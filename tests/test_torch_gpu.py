"""Tests of the port that need a CUDA device (marker `gpu`).

They skip inside the test body where `torch.cuda.is_available()` is
false, and import no JAX, so they run on a machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(`--noconftest` because tests/conftest.py imports JAX for the reference
tests.) Each CUDA kernel (the forward, dQ, dK/dV and decode) is held to
its plain twin on the same card tensors, the kernel backend to the
gather backend on a small DiT (forward, gradients and a train step) and
on a small LM's decode steps, and the streaming service to the
sequential sampler.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import plan as plan_lib
from repro_torch.core.config import SLAConfig
from repro_torch.core.phi import phi
from repro_torch.distributed import ctx
from repro_torch.kernels import cases, ops, sla_bwd, sla_decode, sla_fwd
from repro_torch.launch import steps
from repro_torch.models import dit
from repro_torch.models import transformer
from repro_torch.optim import adamw

# Kernel and twin read the same (possibly bf16) inputs and accumulate in
# f32, so both dtypes are held to the f32 limit; 5e-2 is test_conformance's
# limit for the port's bf16 path against JAX's, not for kernel vs twin.
# The tensor-core routes (bf16 at 64 x 64 blocks) round P (forward) and
# dO, P and dS (backward) to bf16 before their products and are held by
# `cases.tc_criterion` against the twin that rounds alike; the forward's
# O^l, whose arithmetic stays f32, is held to 5e-5.
TWIN_TOL = 5e-5
pytestmark = pytest.mark.gpu


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _operands(seed, h, group, n, d, block, dtype, causal, base, span):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, h, n, d), generator=gen, device="cuda")
    k = torch.randn((1, h // group, n, d), generator=gen, device="cuda")
    v = torch.randn((1, h // group, n, d), generator=gen, device="cuda")
    cfg = SLAConfig(block_q=block, block_kv=block, kh_frac=0.25,
                    kl_frac=0.25, causal=causal)
    plan = plan_lib.plan_attention(q, k, cfg)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)
    fk, fv, fkp = map(ops._flat, (k, v, kp))
    a = ops._flat(plan.marginal)
    hb, zb = ops._hz_blocks(fkp, fv, block)
    hb = torch.repeat_interleave(hb, group, dim=0)  # marginal is per q head
    zb = torch.repeat_interleave(zb, group, dim=0)
    hi, zi = ops._aggregate(a, hb, zb)
    lut, counts = ops._flat(plan.lut), ops._flat(plan.counts)
    fq, fqp = ops._flat(q), ops._flat(qp)
    if causal:  # a span of query blocks against the full KV
        rows = slice(base, base + span)
        cols = slice(base * block, (base + span) * block)
        lut, counts = lut[:, rows].contiguous(), counts[:, rows].contiguous()
        hi, zi = hi[:, rows].contiguous(), zi[:, rows].contiguous()
        fq, fqp = fq[:, cols].contiguous(), fqp[:, cols].contiguous()
    else:
        base = 0
    args = (lut, counts, fq, fk, fv, fqp, hi, zi)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=block,
              block_kv=block, base=base)
    return args, kw, plan


CASES = [
    # (h, group, n, d, block, causal, base)
    (4, 1, 256, 32, 16, False, 0),
    (4, 2, 256, 108, 16, True, 8),
    (2, 1, 512, 128, 64, False, 0),
    (2, 1, 512, 128, 64, True, 4),
    (3, 1, 384, 64, 32, False, 0),
    (2, 1, 256, 8, 16, True, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,group,n,d,block,causal,base", CASES)
def test_cuda_kernel_matches_plain_twin(h, group, n, d, block, causal, base,
                                        dtype):
    """The f32-FMA and split routes within 5e-5; the tensor-core route
    (bf16 at 64 x 64 blocks) by the rounding criterion on (O^s, lse) and
    5e-5 on O^l; the route's own counter moves once per call."""
    _need_gpu()
    args, kw, _ = _operands(7, h, group, n, d, block, dtype, causal, base,
                            span=4)
    route = sla_fwd.forward_route(dtype, block, block, d)
    tc = route == "tc"
    before = _fwd_counters()
    got = sla_fwd.sla_fwd(*args, **kw)
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters() == (before[0] + 1, before[1] + int(tc),
                               before[2] + int(route == "split"))
    for g in got:
        assert g.is_cuda and g.dtype == torch.float32
    if tc:
        _assert_tc_fwd(got, want, args, kw)
        return
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TWIN_TOL, rtol=TWIN_TOL)


def _fwd_counters():
    return sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES, sla_fwd.SPLIT_LAUNCHES


def _assert_tc_fwd(got, want, args, kw):
    """The tensor-core forward: (O^s, lse) by `cases.tc_criterion` against
    the f32 twin and the twin that rounds P to bf16; O^l within 5e-5 x
    max(1, max |twin|)."""
    rounded = sla_fwd.sla_fwd_plain(*args, **kw, mma_dtype=torch.bfloat16)
    res = cases.tc_criterion((got[0], got[2]), (want[0], want[2]),
                             (rounded[0], rounded[2]))
    assert res["ok"], res
    atol = TWIN_TOL * max(1.0, float(want[1].abs().max()))
    torch.testing.assert_close(got[1], want[1], atol=atol, rtol=0)


def test_cuda_tc_fwd_kernel_is_deterministic():
    """No atomics on the forward's tensor-core route: two launches on the
    same operands (causal GQA-2 with a row offset, D 108 padded) are
    bitwise equal."""
    _need_gpu()
    for d in (128, 108):
        args, kw, _ = _operands(8, 4, 2, 1024, d, 64, torch.bfloat16, True,
                                4, span=8)
        before = sla_fwd.TC_LAUNCHES
        first = sla_fwd.sla_fwd(*args, **kw)
        second = sla_fwd.sla_fwd(*args, **kw)
        torch.cuda.synchronize()
        assert sla_fwd.TC_LAUNCHES == before + 2
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        _assert_tc_fwd(first, sla_fwd.sla_fwd_plain(*args, **kw), args, kw)


def test_cuda_tc_fwd_kernel_stops_at_counts():
    """The forward's tensor-core route never reads a padded LUT slot: with
    every slot past the counts naming an extra KV block of NaN, the
    outputs stay finite and bitwise what they were."""
    _need_gpu()
    args, kw, _ = _operands(9, 2, 1, 512, 128, 64, torch.bfloat16, False, 0,
                            span=8)
    lut, counts, q, k, v = args[:5]
    counts = torch.clamp(counts - 1, min=1)  # padded slots in every row
    nan = torch.full((k.shape[0], 64, 128), float("nan"), dtype=k.dtype,
                     device="cuda")
    k_nan, v_nan = (torch.cat([x, nan], dim=1) for x in (k, v))
    extra = k.shape[1] // 64  # the NaN block's index
    dead = torch.arange(lut.shape[-1], device="cuda") >= counts[..., None]
    lut_nan = torch.where(dead, torch.full_like(lut, extra), lut)
    assert int(dead.sum()) > 0
    base_args = (lut, counts, q, k, v, *args[5:])
    want = sla_fwd.sla_fwd(*base_args, **kw)
    got = sla_fwd.sla_fwd(lut_nan, counts, q, k_nan, v_nan, *args[5:], **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _assert_tc_fwd(got, sla_fwd.sla_fwd_plain(*base_args, **kw), base_args,
                   kw)


def test_cuda_tc_fwd_kernel_refuses_misaligned_operands():
    """The tensor-core kernel copies 16-byte chunks: an operand that does
    not start on 16 bytes is refused before any launch."""
    _need_gpu()
    args, kw, _ = _operands(10, 2, 1, 256, 128, 64, torch.bfloat16, False,
                            0, span=4)
    q = args[2]
    store = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")
    shifted = store[1:1 + q.numel()].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sla_fwd.sla_fwd(args[0], args[1], shifted, *args[3:], **kw)
    assert (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES) == before


SPLIT_CASES = [c for c in CASES if c[4] == 64] + [
    (4, 2, 512, 108, 64, True, 2)]


def _assert_split_fwd(got, args, kw):
    """The split route against the f32 twin within 5e-5 x max(1, max
    |twin|) on each of o_s, o_l and lse, and against the twin that cuts
    and sums alike (`mma_dtype="bf16x3"`) within the same limit."""
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    cut = sla_fwd.sla_fwd_plain(*args, **kw, mma_dtype="bf16x3")
    for g, w, c in zip(got, want, cut):
        assert g.is_cuda and g.dtype == torch.float32
        atol = TWIN_TOL * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, atol=atol, rtol=0)
        torch.testing.assert_close(g, c, atol=atol, rtol=0)


@pytest.mark.parametrize("h,group,n,d,block,causal,base", SPLIT_CASES)
def test_cuda_split_fwd_kernel_matches_f32_twin(h, group, n, d, block,
                                                causal, base):
    """f32 at 64 x 64 blocks takes the split route (one split launch and
    one pre-pass launch a call), held at the f32 criterion."""
    _need_gpu()
    args, kw, _ = _operands(11, h, group, n, d, block, torch.float32, causal,
                            base, span=4)
    assert sla_fwd.forward_route(torch.float32, block, block, d) == "split"
    before = _fwd_counters() + (sla_fwd.PLANES_LAUNCHES,)
    got = sla_fwd.sla_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters() + (sla_fwd.PLANES_LAUNCHES,) == (
        before[0] + 1, before[1], before[2] + 1, before[3] + 1)
    _assert_split_fwd(got, args, kw)


def test_cuda_split_planes_match_their_twin_bitwise():
    """The pre-pass cuts bit for bit as `split_kv_planes_plain` does, pads
    D 108 with zeros, and its planes sum back to k and v."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(12)
    k, v = (torch.randn((6, 256, 108), generator=gen, device="cuda") * 3.0
            for _ in range(2))
    k[0, 0, :4] = torch.tensor([0.0, -0.0, 3.4e38, 1e-40])
    before = sla_fwd.PLANES_LAUNCHES
    got = sla_fwd.split_kv_planes(k, v)
    want = sla_fwd.split_kv_planes_plain(k, v)
    torch.cuda.synchronize()
    assert sla_fwd.PLANES_LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.shape == (3, 6, 256, 128) and g.dtype == torch.bfloat16
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert torch.equal(got[0].double().sum(0)[1:, :, :108], k.double()[1:])


def test_cuda_split_fwd_kernel_is_deterministic():
    """No atomics on the split route: two launches on the same operands
    (causal GQA-2 with a row offset, D 128 and 108) are bitwise equal."""
    _need_gpu()
    for d in (128, 108):
        args, kw, _ = _operands(13, 4, 2, 1024, d, 64, torch.float32, True,
                                4, span=8)
        before = sla_fwd.SPLIT_LAUNCHES
        first = sla_fwd.sla_fwd(*args, **kw)
        second = sla_fwd.sla_fwd(*args, **kw)
        torch.cuda.synchronize()
        assert sla_fwd.SPLIT_LAUNCHES == before + 2
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        _assert_split_fwd(first, args, kw)


def test_cuda_split_fwd_kernel_stops_at_counts():
    """The split route never reads a padded LUT slot: with every slot past
    the counts naming an extra KV block of NaN, the outputs stay finite
    and bitwise what they were."""
    _need_gpu()
    args, kw, _ = _operands(14, 2, 1, 512, 128, 64, torch.float32, False, 0,
                            span=8)
    lut, counts, q, k, v = args[:5]
    counts = torch.clamp(counts - 1, min=1)  # padded slots in every row
    nan = torch.full((k.shape[0], 64, 128), float("nan"), device="cuda")
    k_nan, v_nan = (torch.cat([x, nan], dim=1) for x in (k, v))
    extra = k.shape[1] // 64  # the NaN block's index
    dead = torch.arange(lut.shape[-1], device="cuda") >= counts[..., None]
    lut_nan = torch.where(dead, torch.full_like(lut, extra), lut)
    assert int(dead.sum()) > 0
    base_args = (lut, counts, q, k, v, *args[5:])
    want = sla_fwd.sla_fwd(*base_args, **kw)
    got = sla_fwd.sla_fwd(lut_nan, counts, q, k_nan, v_nan, *args[5:], **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _assert_split_fwd(got, base_args, kw)


def test_cuda_split_fwd_kernel_refuses_misaligned_operands():
    """The split kernel reads q in 8-byte pairs and cp.async's the rest in
    16-byte chunks: an operand that does not start on 16 bytes is refused
    before any launch, the pre-pass's included."""
    _need_gpu()
    args, kw, _ = _operands(15, 2, 1, 256, 128, 64, torch.float32, False, 0,
                            span=4)
    for i in (2, 3):  # q, k
        x = args[i]
        store = torch.empty(x.numel() + 4, dtype=x.dtype, device="cuda")
        shifted = store[1:1 + x.numel()].view(x.shape)
        shifted.copy_(x)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        bad = list(args)
        bad[i] = shifted
        before = _fwd_counters() + (sla_fwd.PLANES_LAUNCHES,)
        with pytest.raises(ValueError, match="16-byte aligned"):
            sla_fwd.sla_fwd(*bad, **kw)
        assert _fwd_counters() + (sla_fwd.PLANES_LAUNCHES,) == before


def test_cuda_fma_kernel_forced_at_the_split_shape():
    """`sla_fwd.cu` still takes f32 at 64 x 64 blocks when forced (as
    chip_smoke times it beside the split kernel), within 5e-5."""
    _need_gpu()
    args, kw, _ = _operands(16, 2, 1, 512, 128, 64, torch.float32, True, 2,
                            span=4)
    before = _fwd_counters()
    got = sla_fwd._launch(*args, **kw, route="fma")
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters() == (before[0] + 1, before[1], before[2])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TWIN_TOL, rtol=TWIN_TOL)


def test_cuda_kernel_refuses_what_it_cannot_take():
    _need_gpu()
    args, kw, _ = _operands(1, 2, 1, 256, 32, 16, torch.float32, False, 0, 4)
    bad = list(args)
    bad[2] = bad[2].half()
    with pytest.raises(TypeError, match="float32 or"):
        sla_fwd.sla_fwd(*bad, **kw)
    args, kw, _ = _operands(1, 2, 1, 256, 132, 16, torch.float32, False, 0,
                            4)
    with pytest.raises(ValueError, match="head dims"):
        sla_fwd.sla_fwd(*args, **kw)


@pytest.mark.parametrize("arch", ["wan2_1_1_3b", "lightningdit_1b"])
def test_kernel_backend_matches_gather_on_a_small_dit(arch):
    """A smoke-size DiT forward on the card: kernel vs gather backend on
    the same plans, and the kernel ran once per layer."""
    _need_gpu()
    cfg = get_arch(arch).smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = dit.init(gen, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                      device="cuda"))
    rs = np.random.default_rng(0)
    lat = torch.from_numpy(rs.standard_normal(
        (2, 128, cfg.patch_dim), dtype=np.float32)).cuda()
    cond = (torch.from_numpy(rs.standard_normal(
        (2, cfg.cond_len, cfg.d_model), dtype=np.float32)).cuda()
        if cfg.cross_attn else None)
    t = torch.tensor([0.9, 0.3], device="cuda")
    with torch.no_grad():
        before = sla_fwd.LAUNCHES
        vk, plans = dit.forward(model, cfg, lat, t, cond, torch.float32,
                                "kernel", return_plans=True)
        assert sla_fwd.LAUNCHES == before + cfg.num_layers
        vg = dit.forward(model, cfg, lat, t, cond, torch.float32, "gather",
                         plans=plans)
    assert torch.isfinite(vk).all() and vk.abs().max() > 0.1
    torch.testing.assert_close(vk, vg, atol=1e-4, rtol=1e-4)


def test_scheduler_on_the_card_matches_sequential_sample():
    """The streaming service on the card (kernel backend, mixed
    timesteps, 2 slots) against each request's own batch-1 `sample`:
    cuBLAS may block a batch-2 GEMM differently from a batch-1 one, so
    the rows agree to f32 noise (1e-4), not bitwise."""
    _need_gpu()
    from repro_torch.serving.diffusion import (DenoiseParams,
                                               DiffusionScheduler)
    cfg = get_arch("wan2_1_1_3b").smoke()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = dit.init(gen, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                      device="cuda"))
    rs = np.random.default_rng(2)
    trace = [(3, 1.0), (2, 0.75), (2, 0.5)]
    reqs = [(s, t0, rs.standard_normal((128, cfg.patch_dim),
                                       dtype=np.float32),
             rs.standard_normal((cfg.cond_len, cfg.d_model),
                                dtype=np.float32)) for s, t0 in trace]
    sched = DiffusionScheduler(cfg, model, num_slots=2, seq_len=128,
                               backend="kernel", refresh_mode="fixed",
                               refresh_interval=2)
    for s, t0, lat, cond in reqs:
        sched.submit(lat, DenoiseParams(num_steps=s, t_start=t0), cond=cond)
    before = sla_fwd.LAUNCHES
    done = sched.drain()
    assert sla_fwd.LAUNCHES > before
    for r, (s, t0, lat, cond) in zip(done, reqs):
        ref = dit.sample(model, cfg, torch.from_numpy(lat[None]).cuda(),
                         num_steps=s,
                         cond=torch.from_numpy(cond[None]).cuda(),
                         compute_dtype=torch.float32, backend="kernel",
                         refresh_mode="fixed", refresh_interval=2,
                         t_start=t0)
        assert np.isfinite(r.result).all()
        np.testing.assert_allclose(r.result, ref[0].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_plan_cache_scheduler_on_the_card_matches_the_cpu():
    """The streaming service with the plan cache on the card (kernel
    backend, adaptive refresh, 6 requests of 4 steps through 2 slots)
    against the same trace on the CPU (the kernels' plain twins): the
    same counters, latents within 1e-4. A plan built on the card
    round-trips the wire format bitwise, and `get` hands back CUDA
    tensors."""
    _need_gpu()
    from repro_torch.serving.diffusion import (DenoiseParams,
                                               DiffusionScheduler)
    cfg = get_arch("wan2_1_1_3b").smoke()
    gen = torch.Generator(device="cpu").manual_seed(1)
    host = dit.init(gen, cfg, device="cpu")
    with torch.no_grad():
        for p in host.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    card = dit.init(None, cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    rs = np.random.default_rng(3)
    reqs = [(rs.standard_normal((64, cfg.patch_dim), dtype=np.float32),
             rs.standard_normal((cfg.cond_len, cfg.d_model),
                                dtype=np.float32)) for _ in range(6)]

    def drain(model, device):
        sched = DiffusionScheduler(cfg, model, num_slots=2, seq_len=64,
                                   backend="kernel", refresh_mode="adaptive",
                                   drift_threshold=0.3, plan_cache=True,
                                   t_buckets=8, device=device)
        for lat, cond in reqs:
            sched.submit(lat, DenoiseParams(num_steps=4), cond=cond)
        sched.drain()
        return sched

    on_cpu = drain(host, "cpu")
    before = sla_fwd.LAUNCHES
    on_card = drain(card, "cuda")
    assert sla_fwd.LAUNCHES > before
    assert on_card.cache.stats() == on_cpu.cache.stats()
    assert (on_card.stats.plan_cache_hits,
            on_card.stats.plan_cache_misses) == (5, 1)
    for f in dataclasses.fields(on_card.stats):
        if f.name not in ("prefill_s", "decode_s", "max_decode_gap_s",
                          "last_retention"):
            assert getattr(on_card.stats, f.name) == \
                getattr(on_cpu.stats, f.name), f.name
    for a, b in zip(on_card._requests, on_cpu._requests):
        assert np.isfinite(a.result).all()
        np.testing.assert_allclose(a.result, b.result, atol=1e-4, rtol=1e-4)
    got = on_card.cache.get(on_card.cache.bucket(1.0))
    assert all(getattr(got, n).is_cuda for n in plan_lib.PLAN_LEAVES)
    with torch.no_grad():
        _, plans = dit.forward(card, cfg, torch.from_numpy(
            reqs[0][0][None]).cuda(), 0.5, torch.from_numpy(
            reqs[0][1][None]).cuda(), torch.float32, "kernel",
            return_plans=True)
    back = plan_lib.deserialize_plan(plan_lib.serialize_plan(plans), "cuda")
    for n in plan_lib.PLAN_LEAVES:
        a, b = getattr(back, n), getattr(plans, n)
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b), n


BWD_CASES = [
    # (h, group, n, d, block, causal)
    (4, 1, 256, 32, 16, False),
    (4, 2, 256, 108, 16, True),
    (2, 1, 512, 128, 64, False),
    (2, 1, 512, 128, 64, True),
    (3, 1, 384, 64, 32, False),
    (2, 1, 256, 8, 16, True),
    (4, 2, 1024, 128, 64, True),
    (2, 1, 512, 108, 64, False),
]


def _bwd_operands(seed, h, group, n, d, block, dtype, causal):
    """Both backward kernels' operands: L and O^s from the forward kernel
    on the same inputs, a seeded dO^s and D = rowsum(dO^s * O^s)."""
    args, kw, plan = _operands(seed, h, group, n, d, block, dtype, causal,
                               0, n // block)  # causal: every query block
    o_s, _, lse = sla_fwd.sla_fwd(*args, **kw)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(o_s.shape, generator=gen, device="cuda")
    kw.pop("base")
    tail = (*args[2:5], do, lse, (do * o_s).sum(-1))
    col = (ops._flat(plan.col_lut), ops._flat(plan.col_counts))
    return args[:2] + tail, col + tail, kw


def _assert_twin(got, want):
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.float32
        atol = TWIN_TOL * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, atol=atol, rtol=0)


def _launches():
    return (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
            sla_bwd.TC_LAUNCHES_DQ, sla_bwd.TC_LAUNCHES_DKV)


def _assert_tc(got, plain, args, kw):
    """The tensor-core route's criterion against the f32 twin and the
    twin that rounds dO, P and dS to bf16."""
    want = plain(*args, **kw)
    rounded = plain(*args, **kw, mma_dtype=torch.bfloat16)
    res = cases.tc_criterion(got, want, rounded)
    assert res["ok"], res


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,group,n,d,block,causal", BWD_CASES)
def test_cuda_bwd_kernels_match_plain_twins(h, group, n, d, block, causal,
                                            dtype):
    """Both backward kernels against their twins: the f32-FMA route within
    5e-5, the tensor-core route (bf16 at 64 x 64 blocks) by the rounding
    criterion; the route's own counter moves once per call."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(11, h, group, n, d, block, dtype,
                                          causal)
    tc = sla_bwd.use_tensor_cores(dtype, block, block, d)
    before = _launches()
    got_dq = sla_bwd.sla_bwd_dq(*dq_args, **kw)
    got_dkv = sla_bwd.sla_bwd_dkv(*dkv_args, **kw)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == \
        (1, 1, int(tc), int(tc))
    if tc:
        _assert_tc(got_dq, sla_bwd.sla_bwd_dq_plain, dq_args, kw)
        _assert_tc(got_dkv, sla_bwd.sla_bwd_dkv_plain, dkv_args, kw)
    else:
        _assert_twin(got_dq, sla_bwd.sla_bwd_dq_plain(*dq_args, **kw))
        _assert_twin(got_dkv, sla_bwd.sla_bwd_dkv_plain(*dkv_args, **kw))
    assert got_dq.dtype == torch.float32 and got_dq.shape == (h, n, d)
    assert float(got_dq.abs().max()) > 0


def test_cuda_tc_bwd_kernels_are_deterministic():
    """No atomics on the tensor-core route: two launches on the same
    operands are bitwise equal."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(12, 4, 2, 1024, 128, 64,
                                          torch.bfloat16, True)
    before = _launches()
    first = (sla_bwd.sla_bwd_dq(*dq_args, **kw),
             *sla_bwd.sla_bwd_dkv(*dkv_args, **kw))
    second = (sla_bwd.sla_bwd_dq(*dq_args, **kw),
              *sla_bwd.sla_bwd_dkv(*dkv_args, **kw))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (2, 2, 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_cuda_bwd_kernels_stop_at_counts():
    """Rows and columns with no live entry get zero gradients whatever
    their padded slots name: the kernels never read past the counts."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(3, 2, 1, 512, 128, 64,
                                          torch.float32, False)
    dq_args, dkv_args = list(dq_args), list(dkv_args)
    for args in (dq_args, dkv_args):
        args[0], args[1] = args[0].clone(), args[1].clone()
        args[1][0, 2] = 0
        args[0][0, 2] = 5  # padded slots name another valid block
    dq = sla_bwd.sla_bwd_dq(*dq_args, **kw)
    dk, dv = sla_bwd.sla_bwd_dkv(*dkv_args, **kw)
    torch.cuda.synchronize()
    assert torch.all(dq[0, 128:192] == 0)
    assert torch.all(dk[0, 128:192] == 0) and torch.all(dv[0, 128:192] == 0)
    _assert_twin(dq, sla_bwd.sla_bwd_dq_plain(*dq_args, **kw))
    _assert_twin((dk, dv), sla_bwd.sla_bwd_dkv_plain(*dkv_args, **kw))


def test_cuda_tc_bwd_kernels_stop_at_counts():
    """The tensor-core route (bf16, 64 x 64 blocks) also stops at the
    counts: a row and a column with no live entry get zero gradients
    whatever their padded slots name."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(3, 2, 1, 512, 128, 64,
                                          torch.bfloat16, False)
    dq_args, dkv_args = list(dq_args), list(dkv_args)
    for args in (dq_args, dkv_args):
        args[0], args[1] = args[0].clone(), args[1].clone()
        args[1][0, 2] = 0
        args[0][0, 2] = 5  # padded slots name another valid block
    before = _launches()
    dq = sla_bwd.sla_bwd_dq(*dq_args, **kw)
    dk, dv = sla_bwd.sla_bwd_dkv(*dkv_args, **kw)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 1, 1)
    assert torch.all(dq[0, 128:192] == 0)
    assert torch.all(dk[0, 128:192] == 0) and torch.all(dv[0, 128:192] == 0)
    _assert_tc(dq, sla_bwd.sla_bwd_dq_plain, dq_args, kw)
    _assert_tc((dk, dv), sla_bwd.sla_bwd_dkv_plain, dkv_args, kw)


def _small_dit(arch, seed):
    cfg = get_arch(arch).smoke()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = dit.init(gen, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                      device="cuda"))
    rs = np.random.default_rng(seed)
    batch = {"latents": rs.standard_normal((2, 128, cfg.patch_dim),
                                           dtype=np.float32),
             "noise": rs.standard_normal((2, 128, cfg.patch_dim),
                                         dtype=np.float32),
             "t": np.array([0.8, 0.3], np.float32)}
    if cfg.cross_attn:
        batch["cond"] = rs.standard_normal((2, cfg.cond_len, cfg.d_model),
                                           dtype=np.float32)
    return cfg, model, {k: torch.from_numpy(v).cuda()
                        for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["wan2_1_1_3b", "lightningdit_1b"])
def test_kernel_backend_grads_match_gather_on_a_small_dit(arch):
    """f32 flow-matching loss and every parameter gradient: the kernel
    backend (forward, dQ and dK/dV kernels) against the gather backend's
    autograd, under per-layer remat."""
    _need_gpu()
    cfg, model, batch = _small_dit(arch, 4)
    grads = {}
    for backend in ("kernel", "gather"):
        model.zero_grad()
        before = (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ,
                  sla_bwd.LAUNCHES_DKV)
        with ctx.activation_sharding(remat=True):
            loss = dit.loss_fn(model, cfg, batch, torch.float32, backend)
            loss.backward()
        after = (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ,
                 sla_bwd.LAUNCHES_DKV)
        if backend == "kernel":
            n = cfg.num_layers
            assert tuple(a - b for a, b in zip(after, before)) == (2 * n,
                                                                   n, n)
        grads[backend] = (loss.detach(), {n: p.grad.clone() for n, p in
                                          model.named_parameters()})
    (lk, gk), (lg, gg) = grads["kernel"], grads["gather"]
    torch.testing.assert_close(lk, lg, atol=1e-5, rtol=1e-5)
    for name in gk:
        atol = 1e-4 * max(1.0, float(gg[name].abs().max()))
        torch.testing.assert_close(gk[name], gg[name], atol=atol, rtol=0,
                                   msg=name)


def test_kernel_backend_bf16_grads_on_tensor_cores_match_gather(
        monkeypatch):
    """bf16 compute at 64 x 64 blocks (smoke Wan, seq 256): the kernel
    backend's forward and backward run on the tensor-core kernels, and
    every parameter gradient and the loss meet the rounding criterion
    against the gather backend (f32 attention arithmetic), the "rounded"
    term from the kernel backend run through the twins that round P
    (forward) and dO, P and dS (backward) to bf16."""
    _need_gpu()
    cfg = get_arch("wan2_1_1_3b").smoke()
    cfg = dataclasses.replace(cfg, sla=cfg.sla.replace(block_q=64,
                                                       block_kv=64))
    gen = torch.Generator(device="cuda").manual_seed(6)
    model = dit.init(gen, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                      device="cuda"))
    rs = np.random.default_rng(6)
    batch = {"latents": rs.standard_normal((2, 256, cfg.patch_dim),
                                           dtype=np.float32),
             "noise": rs.standard_normal((2, 256, cfg.patch_dim),
                                         dtype=np.float32),
             "t": np.array([0.8, 0.3], np.float32),
             "cond": rs.standard_normal((2, cfg.cond_len, cfg.d_model),
                                        dtype=np.float32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def grads(backend):
        model.zero_grad()
        loss = dit.loss_fn(model, cfg, batch, torch.bfloat16, backend)
        loss.backward()
        return {"loss": loss.detach().float(),
                **{n: p.grad.clone() for n, p in model.named_parameters()}}

    before = _launches() + (sla_fwd.TC_LAUNCHES,)
    got = grads("kernel")
    n = cfg.num_layers
    assert tuple(a - b for a, b in zip(_launches() + (sla_fwd.TC_LAUNCHES,),
                                       before)) == (n, n, n, n, n)
    want = grads("gather")
    monkeypatch.setattr(ops, "sla_fwd", functools.partial(
        sla_fwd.sla_fwd_plain, mma_dtype=torch.bfloat16))
    monkeypatch.setattr(ops, "sla_bwd_dq", functools.partial(
        sla_bwd.sla_bwd_dq_plain, mma_dtype=torch.bfloat16))
    monkeypatch.setattr(ops, "sla_bwd_dkv", functools.partial(
        sla_bwd.sla_bwd_dkv_plain, mma_dtype=torch.bfloat16))
    rounded = grads("kernel")
    for name in got:
        res = cases.tc_criterion(got[name], want[name].float(),
                                 rounded[name])
        assert res["ok"], (name, res)


def test_train_step_on_the_card_kernel_vs_gather():
    """One make_train_step (bf16 compute over f32 masters, AdamW) on each
    backend from the same weights: the same loss and grad norm to bf16
    noise, finite, and the kernels ran once per layer (twice for the
    forward: its remat recompute)."""
    _need_gpu()
    out = {}
    for backend in ("kernel", "gather"):
        cfg, model, batch = _small_dit("wan2_1_1_3b", 5)
        step = steps.make_train_step(
            cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
            backend=backend)
        state = adamw.init(dict(model.named_parameters()))
        before = (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ,
                  sla_bwd.LAUNCHES_DKV)
        with ctx.activation_sharding(remat=True):
            model, state, loss, gnorm = step(model, state, batch)
        launches = tuple(a - b for a, b in zip(
            (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV),
            before))
        out[backend] = (float(loss), float(gnorm), launches)
    n = cfg.num_layers
    assert out["kernel"][2] == (2 * n, n, n)
    assert out["gather"][2] == (0, 0, 0)
    assert all(np.isfinite(out[b][:2]).all() for b in out)
    np.testing.assert_allclose(out["kernel"][:2], out["gather"][:2],
                               rtol=2e-2)


def _clone(x):
    """A copy of a decode cache: tensors, nested dicts and plans."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, plan_lib.SLAPlan):
        return plan_lib.plan_map(torch.clone, x)
    return x


def _decode_operands(seed, b, hkv, g, c, d, bkv, tn, k_sel, kv_dtype, pos,
                     poison=True):
    """The decode kernel's flat operands on the card: C tokens from base
    position `pos` (mid-block, all in one block), a live LUT per (bh, c)
    with the diagonal block first and other distinct valid blocks after
    it, cnt in [1, K], padded slots naming another valid block
    (`poison`) or repeating the first, every third marg 0, and per-token
    totals and diagonal partials that grow token by token (C = 1: the
    live-row layout, one running total per kv head and no partials)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    bh, bh_kv = b * hkv * g, b * hkv
    row = pos // bkv

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    k = torch.randn((bh_kv, tn, bkv, d), generator=gen, device=dev)
    v = torch.randn((bh_kv, tn, bkv, d), generator=gen, device=dev)
    hblk, zblk = rnd(bh_kv, tn, d, d) * 0.2, rnd(bh_kv, tn, d) + 0.1
    hblk[:, row + 1:] = 0
    zblk[:, row + 1:] = 0
    others = torch.argsort(rnd(bh, c, row), dim=-1)[..., :k_sel - 1]
    lut = torch.cat([torch.full((bh, c, 1), row, device=dev), others],
                    dim=-1).int()
    cnt = torch.randint(1, k_sel + 1, (bh, c), generator=gen,
                        device=dev).int()
    dead = torch.arange(k_sel, device=dev) >= cnt[..., None]
    pad = (torch.randint(0, row, (bh, c, k_sel), generator=gen, device=dev)
           if poison else lut[..., :1].expand(-1, -1, k_sel))
    lut = torch.where(dead, pad.int(), lut).contiguous()
    marg = torch.randint(0, 4, (bh, c), generator=gen, device=dev).int()
    marg.view(-1)[::3] = 0
    grow, growz = rnd(bh_kv, c, d, d) * 0.05, rnd(bh_kv, c, d) * 0.05
    htot = (hblk.sum(1)[:, None] + grow.cumsum(1)).contiguous()
    ztot = (zblk.sum(1)[:, None] + growz.cumsum(1)).contiguous()
    if c == 1:
        hdiag = zdiag = None
        htot, ztot = htot[:, 0], ztot[:, 0]
    else:
        hdiag = (hblk[:, row][:, None] * 0.5 + grow.cumsum(1)).contiguous()
        zdiag = (zblk[:, row][:, None] * 0.5 + growz.cumsum(1)).contiguous()
    q = torch.randn((bh, c, d), generator=gen, device=dev)
    qp = torch.softmax(torch.randn((bh, c, d), generator=gen, device=dev),
                       dim=-1)
    posv = torch.full((bh,), pos, dtype=torch.int32, device=dev)
    args = (lut, cnt, marg, posv, q, qp, k.to(kv_dtype), v.to(kv_dtype),
            hblk, zblk.contiguous(), hdiag, zdiag, htot, ztot)
    return args, dict(scale=d ** -0.5, block_kv=bkv, group=g)


DECODE_CASES = [
    # (b, hkv, g, c, d, bkv, tn, k_sel, pos)
    (2, 8, 2, 1, 128, 64, 64, 6, 40 * 64 + 29),
    (2, 8, 2, 4, 128, 64, 64, 6, 40 * 64 + 29),
    (1, 2, 4, 1, 64, 16, 32, 5, 20 * 16 + 3),
    (1, 2, 4, 4, 64, 16, 32, 5, 20 * 16 + 3),
    (2, 2, 1, 1, 32, 32, 16, 3, 9 * 32 + 10),
]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("poison", [True, False], ids=["poison", "pad"])
@pytest.mark.parametrize("b,hkv,g,c,d,bkv,tn,k_sel,pos", DECODE_CASES)
def test_cuda_decode_kernel_matches_plain_twin(b, hkv, g, c, d, bkv, tn,
                                               k_sel, pos, poison,
                                               kv_dtype):
    """The decode kernel against its twin on the same card tensors: GQA,
    f32 / bf16 K/V, C = 1 (live row) and C = 4 (per-token layout), rows
    with marg = 0 (exact zeros) and padded LUT slots that name another
    block (ignored past cnt); at the chosen split width and at widths 1
    and 2, against the unsplit twin and the split twin at that width, one
    launch a call."""
    _need_gpu()
    args, kw = _decode_operands(3 + c, b, hkv, g, c, d, bkv, tn, k_sel,
                                kv_dtype, pos, poison)
    want = sla_decode.sla_decode_plain(*args, **kw)
    for width in (None, 1, 2):
        before = sla_decode.LAUNCHES
        got = sla_decode.sla_decode(*args, **kw, split_width=width)
        torch.cuda.synchronize()
        assert sla_decode.LAUNCHES == before + 1
        w = sla_decode.split_geometry(args[4], args[0], width)["split_width"]
        split = sla_decode.sla_decode_plain(*args, **kw, split_width=w)
        _assert_twin(got, want)
        _assert_twin(got, split)
        assert torch.all(got[1][args[2] == 0] == 0)
        assert float(got[1].abs().max()) > 0


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 4])
def test_cuda_decode_kernels_are_deterministic(c, kv_dtype):
    """Split and combine in fixed orders, no atomics: two launches of
    either kernel are bitwise equal, at the chosen width and at width 1;
    the paged kernel equals the monolithic one on the gathered view."""
    _need_gpu()
    args, kw = _decode_operands(11, 2, 8, 2, c, 128, 64, 64, 6, kv_dtype,
                                40 * 64 + 29)
    for width in (None, 1):
        one = sla_decode.sla_decode(*args, **kw, split_width=width)
        two = sla_decode.sla_decode(*args, **kw, split_width=width)
        assert all(torch.equal(x, y) for x, y in zip(one, two))
    if c == 1:
        pargs, pkw = cases.paged_decode_operands(
            12, kv_dtype, 20 * 64 + 29, b=4, hkv=8, g=2, d=128, bkv=64,
            tn=32, npages=140, k_sel=6, shared=12)
        dense = cases.paged_dense_operands(pargs)
        for width in (None, 1):
            one = sla_decode.sla_decode_paged(*pargs, **pkw,
                                              split_width=width)
            two = sla_decode.sla_decode_paged(*pargs, **pkw,
                                              split_width=width)
            mono = sla_decode.sla_decode(*dense, **pkw, split_width=width)
            assert all(torch.equal(x, y) and torch.equal(x, z)
                       for x, y, z in zip(one, two, mono))


def test_cuda_decode_kernels_refuse_what_the_split_cannot_take():
    """A split width outside 1..K, and bf16 K/V tiles that are not a
    multiple of 16 bytes (the bulk copies' unit), raise before any
    launch."""
    _need_gpu()
    args, kw = _decode_operands(1, 1, 2, 2, 1, 64, 16, 8, 3, torch.float32,
                                5 * 16 + 2)
    pargs, pkw = cases.paged_decode_operands(
        2, torch.float32, 9 * 16 + 4, b=2, hkv=2, g=1, d=32, bkv=16, tn=16,
        npages=40, k_sel=3, shared=4)
    before = (sla_decode.LAUNCHES, sla_decode.PAGED_LAUNCHES)
    for width in (0, 4, -1):
        with pytest.raises(ValueError, match="split_width"):
            sla_decode.sla_decode(*args, **kw, split_width=width)
        with pytest.raises(ValueError, match="split_width"):
            sla_decode.sla_decode_paged(*pargs, **pkw, split_width=width)
    odd, okw = _decode_operands(1, 1, 2, 2, 1, 36, 3, 8, 3, torch.bfloat16,
                                5 * 3 + 1)
    with pytest.raises(ValueError, match="16 bytes"):
        sla_decode.sla_decode(*odd, **okw)
    assert (sla_decode.LAUNCHES, sla_decode.PAGED_LAUNCHES) == before


def test_cuda_decode_kernel_refuses_what_it_cannot_take():
    _need_gpu()
    args, kw = _decode_operands(1, 1, 2, 2, 1, 64, 16, 8, 3, torch.float32,
                                5 * 16 + 2)
    bad = list(args)
    bad[4] = bad[4].to(torch.bfloat16)
    with pytest.raises(TypeError, match="q must be float32"):
        sla_decode.sla_decode(*bad, **kw)
    bad = list(args)
    bad[6] = bad[6].half()
    bad[7] = bad[7].half()
    with pytest.raises(TypeError, match="float32 or"):
        sla_decode.sla_decode(*bad, **kw)
    with pytest.raises(ValueError, match="kv heads"):
        sla_decode.sla_decode(*args, **dict(kw, group=3))


def test_lm_kernel_decode_matches_gather_on_the_card():
    """A smoke-size Qwen3 on the card, f32: prefill with a decode grid,
    then 24 greedy decode steps through the kernel backend and, from a
    copy of the same cache, the gather backend; the steps cross two block
    boundaries. Logits within 1e-4 x max(1, max |logits|), the same
    tokens, and one decode launch per layer per step."""
    _need_gpu()
    cfg = get_arch("qwen3-1.7b").smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = transformer.init(gen, cfg)
    with torch.no_grad():
        for layer in model.layers:
            layer.sla_proj.copy_(0.1 * torch.randn(
                layer.sla_proj.shape, generator=gen, device="cuda"))
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                         device="cuda")
    with torch.no_grad():
        last, cache = transformer.prefill(model, cfg, toks,
                                          compute_dtype=torch.float32,
                                          decode_max_len=96)

    runs = {}
    for backend, c in (("kernel", cache), ("gather", _clone(cache))):
        tok = (last @ model.embed.t()).argmax(-1)
        toks_out, logits_out = [], []
        before = sla_decode.LAUNCHES
        with torch.no_grad():
            for _ in range(24):
                logits, c = transformer.decode_step(
                    model, cfg, tok, c, compute_dtype=torch.float32,
                    backend=backend)
                tok = logits.argmax(-1)
                toks_out.append(tok)
                logits_out.append(logits)
        runs[backend] = (torch.stack(toks_out), torch.stack(logits_out),
                         sla_decode.LAUNCHES - before, c)
    (tk, lk, nk, ck), (tg, lg, ng, cg) = runs["kernel"], runs["gather"]
    assert nk == 24 * cfg.num_layers and ng == 0
    atol = 1e-4 * max(1.0, float(lg.abs().max()))
    torch.testing.assert_close(lk, lg, atol=atol, rtol=0)
    assert torch.equal(tk, tg)
    assert int(ck["sla"]["extends"].sum()) == cfg.num_layers
    assert torch.equal(ck["sla"]["live_lut"], cg["sla"]["live_lut"])


PAGED_CASES = [
    # (b, hkv, g, d, bkv, tn, npages, k_sel, shared, pos, runaway)
    (4, 8, 2, 128, 64, 32, 140, 6, 12, 20 * 64 + 29, False),
    (2, 2, 4, 64, 16, 24, 60, 5, 6, 10 * 16 + 3, True),
    (2, 2, 1, 32, 32, 16, 40, 3, 4, 9 * 32 + 10, True),
]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hkv,g,d,bkv,tn,npages,k_sel,shared,pos,runaway",
                         PAGED_CASES)
def test_cuda_paged_decode_kernel_matches_twin_and_monolithic(
        b, hkv, g, d, bkv, tn, npages, k_sel, shared, pos, runaway,
        kv_dtype):
    """The paged decode kernel against its twin on the same card tensors
    (shared and shuffled pages, NaN pages behind the padded LUT slots,
    marg = 0 rows exact zeros, a runaway slot), and bitwise against the
    monolithic decode kernel on the page-gathered view of the pools at
    the same split width: the chosen one, 1 and 2."""
    _need_gpu()
    args, kw = cases.paged_decode_operands(
        5 + b, kv_dtype, pos, b=b, hkv=hkv, g=g, d=d, bkv=bkv, tn=tn,
        npages=npages, k_sel=k_sel, shared=shared, runaway=runaway)
    want = sla_decode.sla_decode_paged_plain(*args, **kw)
    dense = cases.paged_dense_operands(args)
    for width in (None, 1, 2):
        before = (sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES)
        got = sla_decode.sla_decode_paged(*args, **kw, split_width=width)
        mono = sla_decode.sla_decode(*dense, **kw, split_width=width)
        torch.cuda.synchronize()
        assert (sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert all(bool(torch.isfinite(x).all()) for x in got)
        _assert_twin(got, want)
        assert torch.all(got[1][args[3] == 0] == 0)
        assert float(got[1].abs().max()) > 0
        for p, m in zip(got, mono):
            assert torch.equal(p, m)


def test_cuda_paged_decode_kernel_refuses_what_it_cannot_take():
    _need_gpu()
    args, kw = cases.paged_decode_operands(
        2, torch.float32, 9 * 16 + 4, b=2, hkv=2, g=1, d=32, bkv=16, tn=16,
        npages=40, k_sel=3, shared=4)
    k = args[7]

    def swap(i, x):
        bad = list(args)
        bad[i] = x
        return bad

    rows_apart = torch.empty(k.shape[:2] + (k.shape[3], k.shape[2]),
                             device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous elements"):
        sla_decode.sla_decode_paged(*swap(7, rows_apart), **kw)
    flat = torch.zeros(k.numel() + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        sla_decode.sla_decode_paged(*swap(7, flat[1:].view(k.shape)), **kw)
    with pytest.raises(ValueError, match="pt must be"):
        sla_decode.sla_decode_paged(*swap(1, args[1].reshape(-1)), **kw)
    with pytest.raises(ValueError, match="q rows are not"):
        sla_decode.sla_decode_paged(*swap(1, args[1][:1]), **kw)
    with pytest.raises(TypeError, match="q must be float32"):
        sla_decode.sla_decode_paged(*swap(5, args[5].bfloat16()), **kw)


def test_paged_scheduler_on_the_card_kernel_vs_gather():
    """A smoke-size Qwen3 through the paged continuous scheduler on the
    card, f32, decode-SLA: 4 requests sharing a prefix (one an exact
    repeat) through 2 slots on the kernel and on the gather backend give
    the same tokens and page counters; the kernel path launches the paged
    kernel once per layer per decode step and the monolithic one never."""
    _need_gpu()
    from repro_torch.serving.api import SamplingParams, Scheduler
    cfg = get_arch("qwen3-1.7b").smoke()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = transformer.init(gen, cfg)
    with torch.no_grad():
        for layer in model.layers:
            layer.sla_proj.copy_(0.1 * torch.randn(
                layer.sla_proj.shape, generator=gen, device="cuda"))
    rs = np.random.default_rng(3)
    shared = rs.integers(0, cfg.vocab_size, 32)
    prompts = [np.concatenate([shared, rs.integers(0, cfg.vocab_size, n)])
               for n in (16, 9, 16)]
    prompts.append(prompts[1])
    budgets = (20, 12, 9, 12)
    runs = {}
    for backend in ("kernel", "gather"):
        sched = Scheduler(cfg, model, num_slots=2, max_len=96,
                          prefill_bucket=48, decode_sla=True, paged=True,
                          backend=backend, compute_dtype=torch.float32)
        for p, n in zip(prompts, budgets):
            sched.submit(p, SamplingParams(max_new_tokens=n))
        before = (sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES)
        done = sched.drain()
        runs[backend] = ([r.tokens_out for r in done], sched.stats,
                         sla_decode.PAGED_LAUNCHES - before[0],
                         sla_decode.LAUNCHES - before[1])
    (tk, sk, pk, mk), (tg, sg, pg, mg) = runs["kernel"], runs["gather"]
    assert tk == tg
    assert [len(t) for t in tk] == list(budgets)
    steps = sk.slot_steps_total // 2
    assert pk == steps * cfg.num_layers and mk == 0 and pg == 0
    for name in ("prefix_hits", "prefix_misses", "prefix_full_hits",
                 "cow_copies", "page_allocs", "pages_peak",
                 "decode_plan_extends", "decode_plan_replans",
                 "decode_plan_reuses"):
        assert getattr(sk, name) == getattr(sg, name), name
    assert sk.prefix_full_hits == 1 and sk.prefix_hits > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_fwd_kernel_on_a_prefill_chunk_span(dtype):
    """Kernel 1 at the shape of a chunked-prefill chunk: a span of 8
    query blocks from block 16 (base > 0, Nq < N) against the full KV,
    causal, 64 x 64 blocks, K/V repeated to the query heads, the rows of
    a plan of the whole map. bf16 takes the tensor-core route (the
    rounding criterion), f32 the split route (5e-5); two launches are
    bitwise equal."""
    _need_gpu()
    args, kw, _ = _operands(21, 4, 1, 2048, 128, 64, dtype, True, 16,
                            span=8)
    route = sla_fwd.forward_route(dtype, 64, 64, 128)
    assert route == ("tc" if dtype == torch.bfloat16 else "split")
    before = _fwd_counters()
    first = sla_fwd.sla_fwd(*args, **kw)
    second = sla_fwd.sla_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters()[0] == before[0] + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    if route == "tc":
        _assert_tc_fwd(first, want, args, kw)
    else:
        _assert_split_fwd(first, args, kw)


def _chunk_lm(block, seed=0):
    """A smoke-size Qwen3 on the card whose SLA blocks are `block` wide
    (64: the tensor-core and split routes of kernel 1), chunk-eligible
    (no column capacity), decode-time SLA, `sla_proj` drawn again."""
    cfg = get_arch("qwen3-1.7b").smoke()
    cfg = dataclasses.replace(cfg, sla=cfg.sla.replace(
        block_q=block, block_kv=block, kh_frac=0.25, kl_frac=0.0,
        col_capacity_factor=None, decode_mode="sla"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = transformer.init(gen, cfg)
    with torch.no_grad():
        for layer in model.layers:
            layer.sla_proj.copy_(0.1 * torch.randn(
                layer.sla_proj.shape, generator=gen, device="cuda"))
    return cfg, model, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chunked_prefill_on_the_card_kernel_vs_gather(dtype):
    """`prefill_chunk` x 4 (64-token chunks of a 256-token bucket, 64 x 64
    blocks) then `finalize_chunked_prefill` on the kernel backend against
    the gather backend: one kernel-1 launch per layer per chunk, all on
    the dtype's route (bf16: tensor cores; f32: split); carried K/V and
    the last hidden within 1e-4 x max(1, max |ref|) in f32 and 5e-2 in
    bf16; the decode rows equal; the kernel's chunks within the same
    limit of its own blocking prefill."""
    _need_gpu()
    cfg, model, gen = _chunk_lm(64)
    cparams = transformer.compute_params(model, dtype)
    toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                         device="cuda")
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    runs = {}
    for backend in ("kernel", "gather"):
        carry = transformer.make_prefill_carry(cfg, 256, compute_dtype=dtype,
                                               decode_sla=True)
        before = _fwd_counters()
        for lo in range(0, 256, 64):
            carry, last = transformer.prefill_chunk(
                cparams, cfg, toks[:, lo:lo + 64], carry, lo,
                compute_dtype=dtype, backend=backend, decode_max_len=320)
        torch.cuda.synchronize()
        runs[backend] = (carry, last, [a - b for a, b in
                                       zip(_fwd_counters(), before)])
    (ck, lk, nk), (cg, lg, ng) = runs["kernel"], runs["gather"]
    route = 1 if dtype == torch.bfloat16 else 2
    assert nk[0] == nk[route] == 4 * cfg.num_layers and ng[0] == 0
    for got, want in ((ck["k"], cg["k"]), (ck["v"], cg["v"]), (lk, lg)):
        atol = tol * max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0)
    assert torch.equal(ck["dmc"], cg["dmc"])
    cache = transformer.finalize_chunked_prefill(cfg, ck, decode_max_len=320)
    with torch.no_grad():
        blast, blocking = transformer.prefill(
            cparams, cfg, toks, compute_dtype=dtype, backend="kernel",
            decode_max_len=320)
    atol = tol * max(1.0, float(blast.float().abs().max()))
    torch.testing.assert_close(lk.float(), blast.float(), atol=atol, rtol=0)
    assert torch.equal(cache["sla"]["plan"].mc, blocking["sla"]["plan"].mc)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_decode_kernel_at_a_16_token_chunk(kv_dtype):
    """Kernel 4 at the shape of a verify-style `decode_chunk`: C = 16
    tokens from a block boundary, each with its own LUT row, totals and
    diagonal partials, at the chosen split width and widths 1 and 2:
    within 5e-5 of the twin, and two launches bitwise equal."""
    _need_gpu()
    args, kw = _decode_operands(31, 2, 8, 2, 16, 128, 64, 64, 6, kv_dtype,
                                40 * 64)
    want = sla_decode.sla_decode_plain(*args, **kw)
    for width in (None, 1, 2):
        before = sla_decode.LAUNCHES
        one = sla_decode.sla_decode(*args, **kw, split_width=width)
        two = sla_decode.sla_decode(*args, **kw, split_width=width)
        torch.cuda.synchronize()
        assert sla_decode.LAUNCHES == before + 2
        _assert_twin(one, want)
        assert all(torch.equal(x, y) for x, y in zip(one, two))


def test_lm_decode_chunk_on_the_card_kernel_vs_gather():
    """A smoke-size Qwen3 on the card, f32: from one cache (a 48-token
    prefill and 8 decode steps), `decode_chunk` of 16 fed tokens (from
    position 56, crossing the block boundary at 64) on the kernel
    backend, on the gather backend, and 16 kernel `decode_step`s; logits
    and the chunk's float cache state within 1e-4 x max(1, max |x|) of
    the steps' (cuBLAS rounds a (B, 16) projection unlike 16 (B, 1)
    ones, so the state is not bitwise the steps' on the card), its
    decode-plan counters equal, and one decode launch per layer per
    chunk."""
    _need_gpu()
    cfg, model, gen = _chunk_lm(16)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                         device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                        device="cuda")
    with torch.no_grad():
        _, cache = transformer.prefill(model, cfg, toks,
                                       compute_dtype=torch.float32,
                                       decode_max_len=96)
        for c in range(8):
            _, cache = transformer.decode_step(
                model, cfg, fed[:, c], cache, compute_dtype=torch.float32,
                backend="kernel")
    fed = fed[:, 8:]

    out = {}
    for backend in ("kernel", "gather"):
        before = sla_decode.LAUNCHES
        out[backend] = transformer.decode_chunk(
            model, cfg, fed, _clone(cache), compute_dtype=torch.float32,
            backend=backend) + (sla_decode.LAUNCHES - before,)
    steps, logits = _clone(cache), []
    with torch.no_grad():
        for c in range(16):
            lg, steps = transformer.decode_step(
                model, cfg, fed[:, c], steps, compute_dtype=torch.float32,
                backend="kernel")
            logits.append(lg)
    (lk, ck, nk), (lg, _, ng) = out["kernel"], out["gather"]
    assert nk == cfg.num_layers and ng == 0
    for want in (lg, torch.stack(logits, dim=1)):
        atol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(lk, want, atol=atol, rtol=0)
    assert int(ck["sla"]["extends"].sum()) == cfg.num_layers
    for key in ("extends", "replans", "reuses", "live_cnt"):
        assert torch.equal(ck["sla"][key], steps["sla"][key]), key
    for got, want in [(ck[k], steps[k]) for k in ("k", "v")] + [
            (ck["sla"][k], steps["sla"][k])
            for k in ("htot", "ztot", "hblk", "zblk", "qpool")]:
        atol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, atol=atol, rtol=0)


def _leaf_pairs(a, b, prefix=""):
    """(name, x, y) for every tensor leaf of two caches of one layout."""
    if torch.is_tensor(a):
        yield prefix, a, b
    elif isinstance(a, dict):
        for key in a:
            yield from _leaf_pairs(a[key], b[key], f"{prefix}.{key}")
    elif isinstance(a, plan_lib.SLAPlan):
        for key in plan_lib.PLAN_LEAVES:
            yield (f"{prefix}.{key}", getattr(a, key), getattr(b, key))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "mono"])
def test_disagg_on_the_card_matches_the_scheduler(paged):
    """A small disaggregated trace on the card, kernel backend, f32,
    decode-SLA, 64 x 64 blocks: 2 prefill and 2 decode workers (paged:
    chunks of one block, r3 resuming from r0's 128-token snapshot;
    unpaged: blocking), per-token decode, decode:0 killed mid-stream at
    tick 5. The tokens equal the port's single Scheduler on the same
    prompts (chunked when paged), every bundle is bitwise its clone from
    its handoff after the drain (one of them replayed), kernel 1 runs
    once a layer per prefill dispatch, and every decode step launches the
    paged kernel (kernel 5) a layer when paged and the monolithic one
    (kernel 4) when not, never the other."""
    _need_gpu()
    from repro_torch.distributed.fault_tolerance import FaultEvent, FaultPlan
    from repro_torch.serving.api import SamplingParams, Scheduler
    from repro_torch.serving.disagg import DisaggScheduler
    cfg, model, _ = _chunk_lm(64)
    rs = np.random.default_rng(7)
    shared = rs.integers(0, cfg.vocab_size, 128)
    prompts = [np.concatenate([shared, rs.integers(0, cfg.vocab_size, 64)]),
               rs.integers(0, cfg.vocab_size, 150),
               rs.integers(0, cfg.vocab_size, 100),
               np.concatenate([shared, rs.integers(0, cfg.vocab_size, 64)])]
    budgets = (12, 9, 10, 8)
    chunk = 1 if paged else None
    kw = dict(max_len=256, backend="kernel", decode_sla=True,
              prefill_bucket=192, paged=paged, prefill_chunk_blocks=chunk,
              compute_dtype=torch.float32)
    base = Scheduler(cfg, model, num_slots=2, **kw)
    for p, n in zip(prompts, budgets):
        base.submit(p, SamplingParams(max_new_tokens=n))
    want = [list(r.tokens_out) for r in base.drain()]
    del base
    clock = iter(range(10**6))
    dis = DisaggScheduler(
        cfg, model, prefill_workers=2, decode_workers=2, slots_per_worker=2,
        decode_step_mode="token", sleep=lambda s: None,
        clock=lambda: 0.5 * next(clock),
        fault_plan=FaultPlan([FaultEvent(tick=5, kind="kill",
                                         pool="decode", worker=0)]), **kw)
    clones = {}
    for w in dis._prefill_pool:
        def hook(stats, tick=w.tick):
            done = tick(stats)
            if done is not None:
                clones[done[0].rid] = (done[1], _clone(done[1].cache))
            return done
        w.tick = hook
    for p, n in zip(prompts, budgets):
        dis.submit(p, SamplingParams(max_new_tokens=n))
    before = (_fwd_counters()[0], sla_decode.LAUNCHES,
              sla_decode.PAGED_LAUNCHES)
    done = dis.drain()
    torch.cuda.synchronize()
    fwd, mono, pg = (a - b for a, b in zip(
        (_fwd_counters()[0], sla_decode.LAUNCHES, sla_decode.PAGED_LAUNCHES),
        before))
    assert [list(r.tokens_out) for r in done] == want
    st = dis.stats
    assert st.kills == 1 and st.requeues >= 1 and st.completed == 4
    assert sorted(clones) == [0, 1, 2, 3]
    for bundle, clone in clones.values():
        for name, x, y in _leaf_pairs(bundle.cache, clone):
            assert torch.equal(x, y), name
    dispatches = st.prefill_chunks if paged else st.handoffs
    if paged:
        assert st.prefill_tokens == 3 * 192 + 64  # r3 resumed at 128
    assert fwd == cfg.num_layers * dispatches
    steps = sum(w.sched.stats.slot_steps_total // 2
                for w in dis._decode_pool)
    assert (pg, mono) == ((cfg.num_layers * steps, 0) if paged
                          else (0, cfg.num_layers * steps))
