"""Sharded serving of the hybrid (zamba2), ssm (rwkv6) and encdec
(whisper) families over a ("data", "model") DeviceMesh, against the port
on one device and the reference on one device.

Gloo cases (one spawn a world size, every case of that world in it,
`tests/_torch_mesh_serve.py`): the smoke model from the reference's
perturbed init, carried over with `repro_torch.bridge` and placed by the
rules; `make_prefill_step(cfg, "kernel", ...)` on the global batch (the
kernels' plain twins on these CPU tensors; zamba2's K/V sized to the
case's cache length, whisper's by its frames), then 6 `make_serve_step`
calls decoding the reference's own greedy tokens, all under
`activation_sharding(mesh, default_residual_spec(mesh, batch, cache
length))`. rwkv6 runs its 4-head twin (the smoke config's 64 heads of
width 2 make its group norm ill-conditioned: tests/test_torch_rwkv6.py).
Held:

- the logits of every step (and of zamba2's and rwkv6's prefill),
  gathered over the data ranks, and every cache leaf assembled from the
  ranks' parts, within TOL x max(1, max |want|) of the port on one device
  and of the reference (f32 5e-5, bf16 5e-2); the greedy tokens equal the
  reference's; the ranks that hold the same rows return them bitwise, and
  the ranks that hold the same shard of a leaf (a conv tail or token
  shift on every "model" rank, a state on every data rank at batch 1)
  hold the same bits;
- each rank's cache leaves at `NamedSharding.shard_shape` of the rule
  (`sharding.cache_shardings`), the K/V in the layout the case names, its
  bytes equal to `launch/dryrun.rank_bytes` of that cell, an empty
  `make_cache` made as those local leaves;
- the prefill's attention calls (zamba2's shared block at each
  application, whisper's encoder layers: kernel 1's path): this rank's
  batch rows (every row under context parallelism), its query heads, the
  whole sequence.

In process: the conv tail's per-rank slices and their reassembly on a
fake mesh, and `make_cache` on the (16, 16) production mesh against the
dry run's cells.
"""
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from _torch_mesh_serve import (STEPS, TOL, Case, feed_of, greedy,
                               kv_leaves, one_device, port_cfg, reference_of,
                               run_world)
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_arch, get_shape
from repro_torch.distributed import ctx, sharding
from repro_torch.launch import dryrun
from repro_torch.models import hybrid, mamba2, registry

Z, R, W = "zamba2-1.2b", "rwkv6-7b", "whisper-small"
H4 = (("ssm_heads", 4),)  # rwkv6's 4-head twin
CASES = [
    # world 2
    Case("zamba2-2x1", Z, (2, 1), 2, 64, 128, "A"),
    Case("zamba2-1x2", Z, (1, 2), 2, 64, 128, "A"),
    Case("zamba2-1x2-bf16", Z, (1, 2), 2, 64, 128, "A", "bfloat16"),
    Case("zamba2-2x1-batch1", Z, (2, 1), 1, 64, 128, "C"),
    Case("rwkv6-1x2", R, (1, 2), 2, 64, 64, "-", overrides=H4),
    Case("rwkv6-2x1-batch1", R, (2, 1), 1, 64, 64, "-", overrides=H4),
    Case("whisper-1x2", W, (1, 2), 2, 128, 128, "A"),
    Case("whisper-2x1-batch1", W, (2, 1), 1, 128, 128, "C"),
    # world 4: zamba2's spans of 51 positions, the decode crossing one
    Case("zamba2-1x4", Z, (1, 4), 2, 48, 204, "B"),
    Case("whisper-1x4", W, (1, 4), 2, 128, 128, "B"),
    Case("zamba2-2x2-batch1", Z, (2, 2), 1, 64, 128, "C"),
    # world 8: the reference's own decode cell (decode_32k smoke, 2 x 4)
    Case("zamba2-2x4-decode-cell", Z, (2, 4), 2, 64, 256, "B"),
    Case("rwkv6-2x4", R, (2, 4), 2, 64, 64, "-", overrides=H4),
    # the cross cache's frames over ("data", "model"): each rank projects
    # its slice of its data rank's encoder rows
    Case("whisper-2x4-batch1", W, (2, 4), 1, 128, 128, "C"),
]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: {case: rank 0's records}}, one spawn a world size,
    run when its first case asks."""
    done = {}

    def get(world):
        if world not in done:
            try:
                done[world] = run_world(
                    [c for c in CASES if c.world == world],
                    tmp_path_factory.mktemp(f"world{world}"))
            except Exception as e:  # one spawn: every case of it fails
                done[world] = e
        if isinstance(done[world], Exception):
            raise done[world]
        return done[world]

    return get


def _close(got, want, tol, name):
    want = np.asarray(want, dtype=np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_sharded_family_serving_matches_one_device_and_the_reference(
        case, worlds):
    got = worlds(case.world)[case.name]
    cfg = port_cfg(case.arch, case.overrides)
    data, model = case.mesh
    tol = TOL[case.dtype]
    feed = feed_of(case)
    one = one_device(case, feed)
    ref = reference_of(case, feed)
    leaves = sorted(k for k in one if k not in ("logits", "pos"))
    assert sorted(k.split("/", 1)[1] for k in got
                  if k.startswith("spec/")) == leaves
    # the layout the rules gave the K/V, and the residual spec
    for key in kv_leaves(cfg.family):
        spec = json.loads(str(got[f"spec/{key}"]))
        assert spec[3] == {"A": None, "B": "model",
                           "C": "data" if cfg.num_kv_heads % model == 0
                           else ["data", "model"]}[case.layout], spec
        assert (spec[2] == "model") == (cfg.num_kv_heads % model == 0)
    assert str(got["residual"]).startswith("(None") == (case.batch == 1)
    # the states' heads over "model", the tails and shifts whole on it
    for key in set(leaves) - set(kv_leaves(cfg.family)):
        spec = json.loads(str(got[f"spec/{key}"]))
        assert ("model" in spec) == (key in ("ssm", "state")), (key, spec)
    # logits, caches, greedy tokens, positions
    for want, who in ((one, "one device"), (ref, "reference")):
        _close(got["logits"], want["logits"], tol, f"logits vs {who}")
        for key in leaves:
            _close(got[key], want[key], tol, f"{key} cache vs {who}")
        np.testing.assert_array_equal(got["pos"], want["pos"])
    if case.dtype == "float32":
        chose, toks = greedy(cfg.family, got["logits"], feed)
        np.testing.assert_array_equal(chose.argmax(-1), toks)
        chose, toks = greedy(cfg.family, one["logits"], feed)
        np.testing.assert_array_equal(chose.argmax(-1), toks)
    assert bool(got["replicated_bitwise"])
    assert bool(got["leaves_bitwise"])
    if cfg.family != "encdec" and (case.batch == 1 or model > 1):
        # a state replicated over "data", a tail or shift over "model"
        assert int(got["leaf_replicas"]) > 0
    # bytes: the rank's cache against the dry run's cell
    assert int(got["empty_bytes"]) == int(got["dryrun_bytes"])
    if case.dtype == "bfloat16":
        assert int(got["cache_bytes"]) == int(got["dryrun_bytes"])
    # the prefill's attention operands: rows, this rank's heads, the
    # whole sequence; KV heads this rank's, or its query heads' (group 1)
    shapes = got["attn_shapes"][:int(got["prefill_calls"])]
    calls = {"hybrid": len(hybrid.segments(cfg)),
             "encdec": cfg.encoder_layers, "ssm": 0}[cfg.family]
    assert len(shapes) == calls
    if not calls:
        return
    rows = case.batch if case.layout == "C" else case.batch // data
    assert (shapes[:, 0] == rows).all()
    assert (shapes[:, 1] == cfg.num_heads // model).all()
    assert (shapes[:, 2] == case.prompt).all()
    kv = cfg.num_kv_heads
    assert (shapes[:, 3] == (kv // model if kv % model == 0
                             else cfg.num_heads // model)).all()
    assert shapes[:, 5].all()  # SLA everywhere: kernel 1's path


# --------------------------------------------------------------------------
# in process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 2, 4])
def test_conv_tail_slices_and_reassembly_round_trip(m):
    """Each "model" rank's slice of a whole conv tail is the channels its
    conv weights cover (`conv_spans`: its heads' x, then B and C), and
    `whole_tail` of every rank's slice, in rank order, is the whole tail
    bitwise; B and C come from rank 0, so a rank whose B or C differed
    would not change it."""
    cfg = get_arch(Z).smoke()
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    d_conv = d_inner + 2 * cfg.ssm_state
    whole = torch.randn((3, 2, cfg.conv_kernel - 1, d_conv),
                        generator=torch.Generator().manual_seed(m))
    chan = torch.arange(d_conv, dtype=torch.float32)
    parts = [mamba2.rank_tail(whole, cfg, r, m) for r in range(m)]
    di = d_inner // m
    for r, part in enumerate(parts):
        got = mamba2.rank_tail(chan, cfg, r, m)
        want = torch.cat([torch.arange(r * di, (r + 1) * di),
                          torch.arange(d_inner, d_conv)]).float()
        assert torch.equal(got, want)
        assert part.shape[-1] == di + 2 * cfg.ssm_state
    assert torch.equal(mamba2.whole_tail(parts, cfg), whole)
    if m > 1:
        parts[1] = parts[1].clone()
        parts[1][..., di:] += 1.0  # another rank's B and C
        assert torch.equal(mamba2.whole_tail(parts, cfg), whole)


@pytest.fixture
def fake_mesh():
    """A DeviceMesh of the given shape over a fake process group (rank 0
    of it; no collective runs), destroyed after the test."""
    def make(shape, names=("data", "model")):
        dryrun.fake_world(math.prod(shape))
        return init_device_mesh("cpu", shape, mesh_dim_names=names)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in (Z, R, W) for s in ("decode_32k", "long_500k")
    if (a, s) not in dryrun.SKIPS])
def test_family_make_cache_under_the_production_mesh_is_the_dry_runs(
        arch, shape_name, fake_mesh):
    """`make_cache` under `activation_sharding` on the (16, 16) mesh (meta
    tensors, rank 0) makes each leaf at the dry run's local shape for
    that cell, and as many bytes (whisper x long_500k is not a cell: the
    dry run skips it)."""
    mesh = fake_mesh((16, 16))
    cfg, shape = get_arch(arch), get_shape(shape_name)
    cell = dryrun.build_cell(cfg, shape, mesh)
    residual = ctx.default_residual_spec(mesh, shape.global_batch,
                                         shape.seq_len)
    with ctx.activation_sharding(mesh, residual):
        cache = registry.get_model(cfg).make_cache(
            cfg, shape.global_batch, shape.seq_len, device="meta")
    leaves = [k for k, v in cache.items() if torch.is_tensor(v)]
    assert sorted(leaves) == sorted(k for k in cell["cache"]
                                    if k != "pos")
    for key in leaves:
        assert cache[key].shape == cell["cache"][key].to_local().shape, key
    assert dryrun.rank_bytes(cell)["cache"] == 4 + sum(
        cache[key].numel() * cache[key].element_size() for key in leaves)


@pytest.mark.parametrize("arch,model,what", [
    (Z, 3, "ssm_heads (4)"), (R, 3, "rwkv6._heads (4)"),
    (W, 3, "num_heads (4)")])
def test_a_model_axis_the_family_cannot_split_is_refused(arch, model, what):
    """`check_mesh_family` refuses, with the reason, a "model" axis that
    does not divide what the family runs over it (its query or SSM heads,
    rwkv6's heads, the FFN width)."""
    cfg = port_cfg(arch, H4 if arch == R else ())
    with pytest.raises(NotImplementedError) as err:
        sharding.check_mesh_family(cfg, {"data": 1, "model": model})
    assert what in str(err.value)
    sharding.check_mesh_family(cfg, {"data": 2, "model": 2})
