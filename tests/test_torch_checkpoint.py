"""The port's checkpoint manager, and a reference checkpoint carried into
the port.

Counterparts of the reference's tests/test_checkpoint.py (round trip,
async save then wait, keep-last-N, a partial write invisible, dtypes
kept), plus what the port's in-place updates and tensors add: an async
`save` followed at once by in-place updates of the saved tensors still
writes the values as they were at `save`, and a bf16 leaf round-trips
bitwise. Then a checkpoint written by the reference's
`CheckpointManager` from a smoke model after one AdamW step loads through
`bridge.train_state_from_checkpoint` into the port's model and optimizer
state bitwise.
"""
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.models import transformer as ttfm


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=gen),
                       "layers": {"ln": torch.ones((4,))}},
            "opt": {"m": torch.zeros((8, 4)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    mgr.save(10, tree, blocking=True)
    assert mgr.latest_step() == 10
    out = mgr.restore(10, tree)
    for a, b in zip(_leaves(out), _leaves(tree)):
        assert torch.equal(a, b)


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    mgr.wait()
    assert mgr.latest_step() == 1


def test_keep_last_n_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.steps() == [3, 4]


def test_partial_write_is_invisible(tmp_path):
    """A .tmp directory (crash mid-write) must not be listed as a step."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree(), blocking=True)
    fake = pathlib.Path(tmp_path) / "step_6.tmp"
    fake.mkdir()
    (fake / "junk.npy").write_bytes(b"xx")
    # also a committed-looking dir without manifest is ignored
    (pathlib.Path(tmp_path) / "step_7").mkdir()
    assert mgr.latest_step() == 5


def test_restore_newer_template_dtype_preserved(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    tree["params"]["half"] = torch.randn((3, 5)).to(torch.bfloat16)
    mgr.save(3, tree, blocking=True)
    out = mgr.restore(3, tree)
    assert out["opt"]["step"].dtype == torch.int32
    # bf16 is stored as its bit patterns, named so, and comes back exact
    manifest = json.loads((tmp_path / "step_3" / "manifest.json")
                          .read_text())["leaves"]
    assert manifest["params__half"]["dtype"] == "bfloat16"
    assert out["params"]["half"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["half"], tree["params"]["half"])


def test_async_save_snapshots_before_in_place_updates(tmp_path,
                                                      monkeypatch):
    """The writer thread is held until the saved tensors have been
    updated in place (as AdamW updates parameters and moments): the
    files still hold the values at `save`."""
    gate = threading.Event()
    save = np.save

    def gated_save(*a, **kw):
        assert gate.wait(timeout=30)
        return save(*a, **kw)

    monkeypatch.setattr(np, "save", gated_save)
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    want = {"w": tree["params"]["w"].clone(),
            "ln": tree["params"]["layers"]["ln"].clone()}
    mgr.save(1, tree)
    with torch.no_grad():
        tree["params"]["w"].add_(1.0)
        tree["params"]["layers"]["ln"].mul_(3.0)
    gate.set()
    mgr.wait()
    out = mgr.restore(1, tree)
    assert torch.equal(out["params"]["w"], want["w"])
    assert torch.equal(out["params"]["layers"]["ln"], want["ln"])


def test_reference_checkpoint_loads_into_the_port_bitwise(tmp_path):
    """A smoke Qwen3 after one reference AdamW step, saved as the
    reference CLI saves it, becomes the port's model weights and AdamW
    moments and step, each leaf bitwise."""
    jcfg, tcfg = jax_get_arch("qwen3-1.7b").smoke(), \
        get_arch("qwen3-1.7b").smoke()
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    opt = jadamw.init(params)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    params, opt, _ = jadamw.update(params, grads, opt, jadamw.AdamWConfig())
    JaxManager(tmp_path).save(1, {"params": params, "opt": opt},
                              blocking=True)
    state_dict, opt_state = bridge.train_state_from_checkpoint(
        tmp_path / "step_1", device="cpu")
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(state_dict)
    named = dict(model.named_parameters())
    want = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    assert set(named) == set(want) == set(opt_state["m"]) \
        == set(opt_state["v"])
    for name, p in named.items():
        assert torch.equal(p.detach(), want[name]), name
    for key in ("m", "v"):
        ref = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, opt[key]), device="cpu")
        for name, t in opt_state[key].items():
            assert torch.equal(t, ref[name]), (key, name)
            assert t.dtype == torch.float32
    assert opt_state["step"].dtype == torch.int32
    assert int(opt_state["step"]) == int(opt["step"]) == 1
