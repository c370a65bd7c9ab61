"""Build the CUDA kernels in `csrc/` at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` alone (no PyTorch headers, so a build takes seconds) into
`build/repro_torch_kernels/lib<name>-<hash>.so` at the repository root,
a directory `.gitignore` lists. The hash is of the source text, so an
edited source is rebuilt and a stale library is never loaded. The
`-Xptxas -v` report (registers, shared memory, spills) is kept beside the
library as `<library>.log`. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def kernel_names() -> list:
    """Every kernel source in csrc/, by name (file stem)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch build only where the CUDA toolkit is "
        "installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its library exists; return the
    nvcc/ptxas report kept beside the library. Raises if nvcc fails."""
    out = library_path(name)
    log = Path(str(out) + ".log")
    if not out.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build of {name} failed (nvcc "
                               f"exit {proc.returncode}):\n{proc.stdout}")
        log.write_text(proc.stdout)
        os.replace(tmp, out)
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and load it (once per process)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
