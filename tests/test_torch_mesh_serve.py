"""Sharded serving of the transformer family (dense, MoE, VLM) over a
("data", "model") DeviceMesh, against the port on one device and the
reference on one device.

Gloo cases (one spawn a world size, every case of that world in it,
`tests/_torch_mesh_serve.py`): the smoke model from the reference's
perturbed init, carried over with `repro_torch.bridge` and placed by the
rules; `make_prefill_step(cfg, "kernel", cache_len=)` on the global batch
(the kernels' plain twins on these CPU tensors), then 6 `make_serve_step`
calls decoding the reference's own greedy tokens, all under
`activation_sharding(mesh, default_residual_spec(mesh, batch,
cache_len))`. Held:

- the logits of the prefill and of every step, gathered over the data
  ranks, and every cache leaf assembled from the ranks' parts, within
  TOL x max(1, max |want|) of the port on one device and of the
  reference (f32 5e-5, bf16 5e-2); the greedy tokens equal the
  reference's; the ranks that hold the same rows return them bitwise;
- each rank's cache leaves at `NamedSharding.shard_shape` of the rule
  (`sharding.cache_shardings`), in the layout the case names, its bytes
  equal to `launch/dryrun.rank_bytes` of that cell, an empty
  `make_cache` made as those local leaves;
- the attention calls' operands: this rank's batch rows (every row under
  context parallelism), its query heads, the whole prompt.

Layouts (`distributed/serving.py`): A heads over "model"; B the sequence
over "model" (flash-decoding, "model" does not divide the KV heads); C
the sequence over "data" at batch 1 (and over ("data", "model") where
"model" does not divide the KV heads).

In process: the flash-decoding functions over slices of one cache against
`_dense_decode_attn` on the whole, the span write against `_cache_write`,
the layouts and local shapes on fake meshes (the production mesh's
against the dry run), and every refusal that stays under a mesh of more
than one rank (decode-time SLA itself runs there:
`tests/test_torch_mesh_decode_sla.py`).
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from _torch_mesh_serve import (STEPS, TOL, Case, _length, feed_of,
                               one_device, reference_of, run_world)
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_arch, get_shape
from repro_torch.distributed import ctx, serving, sharding
from repro_torch.launch import dryrun
from repro_torch.core import plan as plan_lib
from repro_torch.models import dit, transformer
from repro_torch.serving.api import Scheduler
from repro_torch.serving.diffusion import DiffusionScheduler
from repro_torch.serving.disagg import DisaggScheduler

Q3 = "qwen3-1.7b"
CASES = [
    # world 2
    Case("qwen3-2x1", Q3, (2, 1), 2, 64, 256, "A"),
    Case("qwen3-1x2", Q3, (1, 2), 2, 64, 256, "A"),
    Case("qwen3-1x2-bf16", Q3, (1, 2), 2, 64, 256, "A", "bfloat16"),
    Case("qwen3-2x1-batch1", Q3, (2, 1), 1, 64, 128, "C"),
    Case("gemma3-1x2-window", "gemma3-1b", (1, 2), 2, 64, 128, "B"),
    Case("moonshot-1x2-experts", "moonshot-v1-16b-a3b", (1, 2), 2, 64, 128,
         "A"),
    Case("internvl2-2x1-prefix", "internvl2-1b", (2, 1), 2, 48, 128, "A"),
    Case("moonshot-2x1-batch1", "moonshot-v1-16b-a3b", (2, 1), 1, 64, 128,
         "C"),
    # world 4: spans of 51 positions, the decode crossing one at 51
    Case("qwen3-1x4", Q3, (1, 4), 2, 48, 204, "B"),
    Case("qwen3-1x4-per-slot", Q3, (1, 4), 2, 48, 204, "B",
         per_slot=(48, 45)),
    Case("qwen3-2x2-batch1", Q3, (2, 2), 1, 64, 128, "C"),
    # world 8: the reference's own decode cell (decode_32k smoke, 2 x 4)
    Case("qwen3-2x4-decode-cell", Q3, (2, 4), 2, 64, 256, "B"),
    Case("qwen3-2x4-decode-cell-bf16", Q3, (2, 4), 2, 64, 256, "B",
         "bfloat16"),
    Case("qwen3-2x4-batch1", Q3, (2, 4), 1, 64, 128, "C"),
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
def test_sharded_serving_matches_one_device_and_the_reference(case,
                                                              worlds):
    got = worlds(case.world)[case.name]
    cfg = get_arch(case.arch).smoke()
    data, model = case.mesh
    tol = TOL[case.dtype]
    feed = feed_of(case)
    one = one_device(case, feed)
    ref = reference_of(case, feed)
    # the layout the rules gave, and the residual spec it ran under
    spec = json.loads(str(got["spec"]))
    assert spec[3] == {"A": None, "B": "model",
                       "C": "data" if cfg.num_kv_heads % model == 0
                       else ["data", "model"]}[case.layout], spec
    assert (spec[2] == "model") == (cfg.num_kv_heads % model == 0), spec
    assert str(got["residual"]).startswith("(None") == (case.layout == "C")
    # logits, caches, greedy tokens, positions
    for want, who in ((one, "one device"), (ref, "reference")):
        _close(got["logits"], want["logits"], tol, f"logits vs {who}")
        for key in ("k", "v"):
            _close(got[key], want[key], tol, f"{key} cache vs {who}")
        np.testing.assert_array_equal(got["pos"], want["pos"])
    if case.dtype == "float32":
        greedy = got["logits"][:STEPS].argmax(-1)
        np.testing.assert_array_equal(greedy, feed)
        np.testing.assert_array_equal(one["logits"][:STEPS].argmax(-1), feed)
    assert bool(got["replicated_bitwise"])
    # bytes: the rank's cache against the dry run's cell
    assert int(got["empty_bytes"]) == int(got["dryrun_bytes"])
    if case.dtype == "bfloat16":
        assert int(got["cache_bytes"]) == int(got["dryrun_bytes"])
    # the prefill's attention operands: rows, this rank's heads, the
    # whole prompt; KV heads this rank's, or its query heads' (group 1)
    shapes = got["attn_shapes"][:int(got["prefill_calls"])]
    assert len(shapes) == cfg.num_layers
    rows = case.batch if case.layout == "C" else case.batch // data
    assert (shapes[:, 0] == rows).all()
    assert (shapes[:, 1] == cfg.num_heads // model).all()
    assert (shapes[:, 2] == _length(case)).all()
    kv = cfg.num_kv_heads
    assert (shapes[:, 3] == (kv // model if kv % model == 0
                             else cfg.num_heads // model)).all()
    assert shapes[:, 5].any()  # SLA layers among them (kernel 1's path)


# --------------------------------------------------------------------------
# in process: the flash-decoding functions over slices of one cache
# --------------------------------------------------------------------------
FLASH = [  # (heads, kv heads, length, spans, window, dtype)
    (4, 2, 96, 4, 0, torch.float32),
    (4, 1, 96, 8, 32, torch.float32),
    (4, 4, 128, 16, 0, torch.float32),
    (4, 2, 96, 4, 0, torch.bfloat16),
    (4, 1, 96, 3, 32, torch.bfloat16),
]


@pytest.mark.parametrize("pos", ["shared", "per-slot"])
@pytest.mark.parametrize("h,hkv,n,spans,window,dtype", FLASH)
def test_flash_decode_over_slices_is_the_whole_cache_attention(
        h, hkv, n, spans, window, dtype, pos):
    """The partial softmax over each span and the combine in span order
    equal `_dense_decode_attn` over the whole cache, within 5e-5 x
    max(1, max |o|) in f32 and 5e-2 in bf16, the sliding window on global
    columns; combining again gives the same bits."""
    cfg = get_arch("gemma3-1b").smoke()
    g = torch.Generator().manual_seed(h * n + spans)
    q = torch.randn((2, h, 1, cfg.head_dim), generator=g).to(dtype)
    kc = torch.randn((2, hkv, n, cfg.head_dim), generator=g).to(dtype)
    vc = torch.randn((2, hkv, n, cfg.head_dim), generator=g).to(dtype)
    p = 70 if pos == "shared" else torch.tensor([70, n - 1])
    kind = transformer.KIND_SWA if window else transformer.KIND_SLA
    cfg = dataclasses.replace(cfg, local_window=window)
    want = transformer._dense_decode_attn(q, kc, vc, p, kind, cfg)
    step = n // spans
    cut = [slice(i * step, (i + 1) * step) for i in range(spans)]
    parts = torch.stack([serving.decode_partial(
        q[:, :, 0], kc[:, :, c], vc[:, :, c], p, c.start, window)
        for c in cut])
    got = serving.decode_combine(parts)
    assert torch.equal(got, serving.decode_combine(parts.clone()))
    got = got.to(dtype).reshape(want.shape)
    tol = 5e-5 if dtype == torch.float32 else 5e-2
    _close(got.float().numpy(), want.float().numpy(), tol, "flash decode")


@pytest.mark.parametrize("h,hkv,n,spans,window,dtype", FLASH[:3])
def test_a_chunk_over_slices_is_the_whole_cache_chunk(h, hkv, n, spans,
                                                      window, dtype):
    """A verify-style chunk of 8 tokens that crosses from one span into
    the next: `write_token` of its K/V on each span writes what the
    whole-cache write does, and the partials of its tokens (token c's
    causal limit pos + c) combined in span order equal
    `_dense_decode_chunk_attn` over the whole cache within 5e-5 x max(1,
    max |o|)."""
    cfg = get_arch("gemma3-1b").smoke()
    g = torch.Generator().manual_seed(h * n + spans + 1)
    cdim, step = 8, n // spans
    pos = step * (spans // 2) - 3  # tokens on both sides of a span's end
    q = torch.randn((2, h, cdim, cfg.head_dim), generator=g).to(dtype)
    kc = torch.randn((2, hkv, n, cfg.head_dim), generator=g).to(dtype)
    vc = torch.randn((2, hkv, n, cfg.head_dim), generator=g).to(dtype)
    new_k = torch.randn((2, hkv, cdim, cfg.head_dim), generator=g)
    new_v = torch.randn((2, hkv, cdim, cfg.head_dim), generator=g)
    cut = [slice(i * step, (i + 1) * step) for i in range(spans)]
    kp = [kc[:, :, c].clone() for c in cut]
    vp = [vc[:, :, c].clone() for c in cut]
    kc[:, :, pos:pos + cdim] = new_k.to(dtype)
    vc[:, :, pos:pos + cdim] = new_v.to(dtype)
    for i in range(spans):
        serving.write_token(kp[i], new_k, pos, i * step, n)
        serving.write_token(vp[i], new_v, pos, i * step, n)
    assert torch.equal(torch.cat(kp, dim=2), kc)
    assert torch.equal(torch.cat(vp, dim=2), vc)
    kind = transformer.KIND_SWA if window else transformer.KIND_SLA
    cfg = dataclasses.replace(cfg, local_window=window)
    want = transformer._dense_decode_chunk_attn(
        q, kc, vc, pos + torch.arange(cdim), kind, cfg)
    parts = torch.stack([serving.decode_partial(
        q, kp[i], vp[i], pos, c.start, window) for i, c in enumerate(cut)])
    got = serving.decode_combine(parts)  # (B, H, C, D)
    got = got.to(dtype).transpose(1, 2).reshape(want.shape)
    _close(got.float().numpy(), want.float().numpy(), 5e-5, "chunk")


@pytest.mark.parametrize("pos", [5, 50, 95, "per-slot", "runaway"])
def test_span_write_is_the_whole_cache_write(pos):
    """`write_token` on each span of a cache writes what `_cache_write`
    writes on the whole: the owner of each position (of each slot's, as
    a masked scatter), a runaway slot clamped to the last position."""
    n, spans = 96, 4
    whole = torch.zeros((3, 2, n, 8))
    new = torch.randn((3, 2, 1, 8))
    p = {"per-slot": torch.tensor([5, 50, 95]),
         "runaway": torch.tensor([7, 300, 48])}.get(pos, pos)
    parts = [whole[:, :, i * 24:(i + 1) * 24].clone() for i in range(spans)]
    transformer._cache_write(whole, new, p)
    for i, part in enumerate(parts):
        serving.write_token(part, new, p, i * 24, n)
    assert torch.equal(torch.cat(parts, dim=2), whole)


# --------------------------------------------------------------------------
# in process: layouts on fake meshes (rank 0 of a fake process group)
# --------------------------------------------------------------------------
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


@pytest.mark.parametrize("shape,batch,hkv,layout", [
    ((2, 4), 2, 2, ("model", 4, False)),
    ((2, 4), 2, 4, (None, 1, True)),
    ((2, 4), 1, 4, ("data", 2, True)),
    ((2, 4), 1, 2, (("data", "model"), 8, False)),
    ((16, 16), 128, 8, ("model", 16, False)),
    ((16, 16), 1, 1, (("data", "model"), 256, False)),
    ((16, 16), 128, 16, (None, 1, True)),
], ids=["B", "A", "C-heads", "C-all", "B-16x16", "C-16x16", "A-16x16"])
def test_kv_layout_reads_the_rules(shape, batch, hkv, layout, fake_mesh):
    mesh = fake_mesh(shape)
    lay = serving.kv_layout(mesh, batch, hkv)
    seq, parts, heads = layout
    assert lay.spec[3] == seq
    assert lay.seq_parts == parts and lay.heads_split == heads
    length = parts * 16
    want = sharding.cache_shardings(
        mesh, {"k": torch.empty((1, batch, hkv, length, 8), device="meta")},
        batch)["k"]
    assert lay.local_shape((1, batch, hkv, length, 8)) == \
        want.shard_shape((1, batch, hkv, length, 8))
    lay.check_length(length)
    if parts > 1:
        with pytest.raises(ValueError, match="divide"):
            lay.check_length(length + 1)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b",
                                  "moonshot-v1-16b-a3b", "internvl2-1b"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_make_cache_under_the_production_mesh_is_the_dry_runs(
        arch, shape_name, fake_mesh):
    """`make_cache` under `activation_sharding` on the (16, 16) mesh (meta
    tensors, rank 0) makes each leaf at the dry run's local shape for
    that cell, and as many bytes."""
    mesh = fake_mesh((16, 16))
    cfg, shape = get_arch(arch), get_shape(shape_name)
    cell = dryrun.build_cell(cfg, shape, mesh)
    residual = ctx.default_residual_spec(mesh, shape.global_batch,
                                         shape.seq_len)
    with ctx.activation_sharding(mesh, residual):
        cache = transformer.make_cache(cfg, shape.global_batch,
                                       shape.seq_len, device="meta")
    for key in ("k", "v"):
        assert cache[key].shape == cell["cache"][key].to_local().shape
    assert dryrun.rank_bytes(cell)["cache"] == 4 + sum(
        cache[key].numel() * cache[key].element_size() for key in ("k", "v"))


# --------------------------------------------------------------------------
# in process: what stays refused under a mesh of more than one rank
# --------------------------------------------------------------------------
def _qwen():
    return get_arch("qwen3-1.7b").smoke()


def _dit():
    cfg = get_arch("lightningdit_1b").smoke()
    return cfg, dit.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")


REFUSED = {
    "the plan cache (plan_cache=)": lambda: DiffusionScheduler(
        *_dit(), num_slots=2, seq_len=64, backend="kernel",
        plan_cache=True, device="cpu").step(),
    "the LM Scheduler (Scheduler)": lambda: Scheduler(_qwen(), None),
    "disaggregated serving (DisaggScheduler)": lambda: DisaggScheduler(
        _qwen(), None),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_refused_under_a_mesh_of_more_than_one_rank(what, fake_mesh):
    mesh = fake_mesh((1, 2))
    with ctx.activation_sharding(mesh, (("data",), None, "model")):
        with pytest.raises(NotImplementedError) as err:
            REFUSED[what]()
    assert str(err.value) == (f"{what} is not ported to a mesh of more "
                              f"than one rank")


def _stack(cfg, batch: int, heads: int, seq: int):
    sla = cfg.sla
    plan = plan_lib.empty_plan(sla, batch, heads, seq // sla.block_q,
                               seq // sla.block_kv)
    return plan_lib.plan_map(
        lambda leaf: torch.stack([leaf] * cfg.num_layers), plan)


@pytest.mark.parametrize("family", ["dit", "lm"])
@pytest.mark.parametrize("mesh_shape", [None, (1, 2)])
def test_a_plan_part_of_the_wrong_shape_is_refused(family, mesh_shape,
                                                   fake_mesh):
    """`plans=` must be this rank's part of the stack: on one device the
    whole stack, on a (1, 2) mesh its batch rows and half the query heads.
    The whole stack given on the mesh, or another batch on one device,
    raises a ValueError naming the expected shape."""
    seq, batch = 64, 2
    if family == "dit":
        cfg, model = _dit()
        x = torch.zeros((batch, seq, cfg.patch_dim))

        def call(plans):
            dit.forward(model, cfg, x, 0.5, plans=plans)
    else:
        cfg = _qwen()
        model = transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        x = torch.zeros((batch, seq), dtype=torch.int32)

        def call(plans):
            transformer.forward(model, cfg, x, plans=plans)
    heads = cfg.num_heads
    blocks = seq // cfg.sla.block_q
    scope = ctx.activation_sharding(None)
    if mesh_shape is None:
        wrong = _stack(cfg, batch + 1, heads, seq)
        want = (cfg.num_layers, batch, heads, blocks, blocks)
    else:
        scope = ctx.activation_sharding(fake_mesh(mesh_shape),
                                        (("data",), None, "model"))
        wrong = _stack(cfg, batch, heads, seq)
        want = (cfg.num_layers, batch, heads // 2, blocks, blocks)
    with scope, torch.no_grad():
        with pytest.raises(ValueError) as err:
            call(wrong)
    assert f"the active layout's part is {want}" in str(err.value)


def test_a_model_axis_the_query_heads_need_is_refused_with_its_reason():
    """A "model" axis that divides the KV heads but not the query heads
    is refused (gemma3's 4 query heads on 8 ranks); one that divides the
    query heads but not the KV heads serves (flash-decoding)."""
    cfg = get_arch("gemma3-1b")
    with pytest.raises(NotImplementedError) as err:
        sharding.check_mesh_family(cfg, {"data": 2, "model": 8})
    assert "num_heads (4)" in str(err.value)
    assert "flash-decoding combine" in str(err.value)
    sharding.check_mesh_family(cfg, {"data": 2, "model": 4})
