"""The train CLI, checkpoints and remeshing over a DeviceMesh on gloo
ranks.

- `train.main` with `--data-mesh 2 --model-mesh 2` on 4 ranks gives the
  one-device run's losses within 5e-5 x max(1, |loss|), the loss in f32
  on both sides (`make_train_step(compute_dtype=torch.float32)` patched
  into the CLI), with and without `--compress-grads`; rank 0 alone
  prints.
- A train state placed on a (2, 2) mesh of 4 ranks and saved writes files
  and a manifest byte-identical to a one-device save of the same values;
  rank 0 alone copies leaves to host memory (the other ranks none); 2
  ranks restore it onto a (2, 1) mesh with `shardings=` and this process
  onto no mesh, bitwise.
- `elastic.remesh` takes the same state placed on (4, 1) onto (2, 2):
  the rules' placements, and local shards bitwise those of placing it
  there directly.
"""
import filecmp
import functools

import numpy as np
import torch

from _torch_mesh import run_ranks, save_weights
from _torch_mesh_worker import train_state
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.launch import steps, train
from repro_torch.models import registry

TOL = 5e-5
CLI = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "3", "--device", "cpu",
       "--log-every", "1", "--seed", "2"]


def test_train_cli_on_a_2x2_mesh_matches_one_device(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.setattr(train, "make_train_step", functools.partial(
        steps.make_train_step, compute_dtype=torch.float32))
    argvs = [CLI, CLI + ["--compress-grads"]]
    want = [train.main(a) for a in argvs]
    capsys.readouterr()
    res = run_ranks("cli", 4, tmp_path, argvs=[
        a + ["--data-mesh", "2", "--model-mesh", "2"] for a in argvs])
    for i, w in enumerate(want):
        got = res[f"losses{i}"]
        assert len(got) == len(w) == 3
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=TOL * max(1.0, max(map(abs, w))),
                                   err_msg=" ".join(argvs[i]))
    assert "final loss" in res["logs"][0]
    assert all("final loss" not in log and "step " not in log
               for log in res["logs"][1:])


def _state(tmp_path):
    """A port state_dict of smoke qwen3 (seeded), as the ranks load it."""
    cfg = get_arch("qwen3-1.7b").smoke()
    gen = torch.Generator().manual_seed(4)
    model = registry.get_model(cfg).init(gen, cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model, save_weights(tmp_path / "w.npz", model.state_dict())


def test_sharded_checkpoint_is_a_one_device_checkpoint(tmp_path):
    model, weights = _state(tmp_path)
    sharded, single = tmp_path / "sharded", tmp_path / "single"
    res = run_ranks("ckpt_save", 4, tmp_path, arch="qwen3-1.7b",
                    weights=weights, mesh=[2, 2], remesh_from=[4, 1],
                    dir=str(sharded))
    assert list(res["steps"]) == [1]
    n_leaves = 3 * len(dict(model.named_parameters())) + 1
    assert res["host_leaves"].tolist() == [[n_leaves, n_leaves]] + \
        [[0, n_leaves]] * 3
    params = dict(model.named_parameters())
    opt = train_state(params)
    for n, p in params.items():
        assert np.array_equal(res[f"remesh/{n}"], p.detach().numpy()), n
    CheckpointManager(single).save(1, {"params": params, "opt": opt},
                                   blocking=True)
    a, b = sharded / "step_1", single / "step_1"
    names = sorted(x.name for x in a.iterdir())
    assert names == sorted(x.name for x in b.iterdir())
    assert "manifest.json" in names and len(names) == 3 * len(params) + 2
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors
    # onto a (2, 1) mesh of 2 ranks
    res = run_ranks("ckpt_restore", 2, tmp_path, arch="qwen3-1.7b",
                    weights=weights, mesh=[2, 1], dir=str(sharded))
    for n, p in params.items():
        assert np.array_equal(res[f"param/{n}"], p.detach().numpy()), n
        assert np.array_equal(res[f"m/{n}"], opt["m"][n].numpy()), n
        assert np.array_equal(res[f"v/{n}"], opt["v"][n].numpy()), n
    assert int(res["step"]) == 7
    # onto no mesh
    got = CheckpointManager(sharded).restore(
        1, {"params": params, "opt": opt}, device="cpu")
    for n, p in params.items():
        assert torch.equal(got["params"][n], p.detach()), n
        assert torch.equal(got["opt"]["v"][n], opt["v"][n]), n
    assert int(got["opt"]["step"]) == 7
