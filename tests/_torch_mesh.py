"""Launch a multi-rank case of the port: one process per rank over gloo.

`run_ranks(case, world, tmp_path, **spec)` starts `world` processes of
`tests/_torch_mesh_worker.py` (one torch thread each, RANK / LOCAL_RANK /
WORLD_SIZE set, a FileStore under `tmp_path`: no port is taken, so
parallel test workers never collide), waits for all of them, and returns
rank 0's results as a dict of numpy arrays, with every rank's output
under "logs". Any rank failing or
outliving `timeout` fails the caller with the ranks' stderr; a rank
still running then first prints its Python stack (SIGUSR1, the
worker's `faulthandler`).
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import uuid

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).with_name("_torch_mesh_worker.py")


def save_batches(path, batches) -> str:
    """Write a list of batches (dicts of numpy arrays) for the worker."""
    np.savez(path, **{f"{i}/{k}": np.asarray(v)
                      for i, b in enumerate(batches) for k, v in b.items()})
    return str(path)


def save_weights(path, state) -> str:
    """Write a port state_dict (name -> tensor) for the worker."""
    np.savez(path, **{n: t.detach().cpu().numpy() for n, t in state.items()})
    return str(path)


def run_ranks(case: str, world: int, tmp_path, timeout: float = 300,
              **spec) -> dict:
    tag = f"{case}_{uuid.uuid4().hex[:8]}"
    tmp = pathlib.Path(tmp_path)
    spec_path = tmp / f"{tag}.json"
    spec_path.write_text(json.dumps(spec))
    out_path = tmp / f"{tag}.npz"
    store = tmp / f"{tag}.store"
    env = dict(os.environ)
    env.update(PYTHONPATH=f"{ROOT / 'src'}", OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), CUDA_VISIBLE_DEVICES="")
    procs = []
    for rank in range(world):
        env_r = dict(env, RANK=str(rank), LOCAL_RANK=str(rank))
        err = open(tmp / f"{tag}.rank{rank}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), case, str(spec_path),
             str(out_path), str(store)], env=env_r, cwd=str(tmp),
            stdout=err, stderr=subprocess.STDOUT), err))
    failed = []
    try:
        for rank, (p, _) in enumerate(procs):
            try:
                if p.wait(timeout=timeout) != 0:
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
                break
    finally:
        live = [p for p, _ in procs if p.poll() is None]
        for p in live:  # each live rank's stack into its log
            p.send_signal(signal.SIGUSR1)
        if live:
            time.sleep(2)
        for p in live:
            p.kill()
            p.wait()
    logs = []
    for rank, (_, err) in enumerate(procs):
        err.seek(0)
        logs.append(f"--- rank {rank} ---\n{err.read()[-3000:]}")
        err.close()
    assert not failed, f"{case}: ranks {failed} failed\n" + "\n".join(logs)
    with np.load(out_path, allow_pickle=False) as f:
        out = {k: f[k] for k in f.files}
    out["logs"] = logs
    return out
