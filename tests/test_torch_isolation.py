"""The port stands alone: `repro_torch`, its examples (`examples_torch/`)
and `chip_smoke.py` import neither JAX nor the JAX package `repro`, and
the examples not the reference's `examples` either.

A subprocess poisons `sys.modules["jax"]` (and `repro`, `examples`) and
then imports every module of the port, every example of the port and
`chip_smoke`; any such import on the way fails it. A source scan also
rejects import statements of `jax` or `repro` (the package name
`repro_torch` excepted) anywhere under src/repro_torch, in the examples
and in `chip_smoke.py`, and of `examples` (`examples_torch` excepted) in
the examples.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.MULTILINE)
EXAMPLES_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro|examples)\b",
                                re.MULTILINE)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _example_modules():
    return [f"examples_torch.{p.stem}" for p in sorted(EXAMPLES.glob("*.py"))]


def test_port_and_chip_smoke_import_without_jax():
    mods = _port_modules() + _example_modules()
    assert "repro_torch.kernels.sla_fwd" in mods
    assert "examples_torch.finetune_dit" in mods
    assert len(_example_modules()) == 6
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['examples'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'examples') or m.startswith(('jax.', 'repro.', 'examples.')))\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_imports_jax_or_repro():
    offenders = []
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for m in IMPORT_RE.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(ROOT)}: {m.group(0)}")
    for path in EXAMPLES.glob("*.py"):
        for m in EXAMPLES_IMPORT_RE.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(ROOT)}: {m.group(0)}")
    assert not offenders, offenders
    assert EXAMPLES_IMPORT_RE.search("from examples.finetune_dit import build")
    assert not EXAMPLES_IMPORT_RE.search(
        "from examples_torch.finetune_dit import build")
    # the pattern does catch what it must
    assert IMPORT_RE.search("import jax.numpy as jnp")
    assert IMPORT_RE.search("    from repro.core import plan")
    assert not IMPORT_RE.search("from repro_torch.core import plan")


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """With no CUDA device the script exits non-zero and prints no result
    line (on a machine with a GPU the script itself is the check)."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
