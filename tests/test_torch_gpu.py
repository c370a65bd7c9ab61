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
# The tensor-core routes (bf16 at 64 x 64 blocks, and the "tc32" routes
# at 32 x 32) round P (forward) and dO, P and dS (backward)
# to bf16 before their products and are held by `cases.tc_criterion`
# against the twin that rounds alike; the forward's O^l, whose arithmetic
# stays f32, is held to 5e-5.
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
    # D 64 at 64 x 64 blocks (zamba2's shared block, causal; whisper's
    # encoder, non-causal): the tensor-core and split routes pad to 128
    (4, 1, 512, 64, 64, True, 4),
    (3, 1, 512, 64, 64, False, 0),
    # D 256 (gemma3's SLA layers: 4 q heads on 1 kv head, causal), and a
    # head dim between 128 and 256: the f32-FMA route in both dtypes
    (4, 4, 512, 256, 64, True, 4),
    (2, 1, 256, 256, 64, False, 0),
    (2, 2, 256, 192, 32, True, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,group,n,d,block,causal,base", CASES)
def test_cuda_kernel_matches_plain_twin(h, group, n, d, block, causal, base,
                                        dtype):
    """The f32-FMA and split routes within 5e-5; the tensor-core routes
    (bf16 at 64 x 64 and at 32 x 32 blocks) by the rounding criterion on
    (O^s, lse) and 5e-5 on O^l; the route's own counter moves once per
    call."""
    _need_gpu()
    args, kw, _ = _operands(7, h, group, n, d, block, dtype, causal, base,
                            span=4)
    route = sla_fwd.forward_route(dtype, block, block, d)
    before = _fwd_counters() + (sla_fwd.TC32_LAUNCHES,)
    got = sla_fwd.sla_fwd(*args, **kw)
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters() + (sla_fwd.TC32_LAUNCHES,) == (
        before[0] + 1, before[1] + int(route == "tc"),
        before[2] + int(route == "split"), before[3] + int(route == "tc32"))
    for g in got:
        assert g.is_cuda and g.dtype == torch.float32
    if route in ("tc", "tc32"):
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


TC32_FWD_CASES = [
    # (h, group, n, d, causal, base): D 64 (the fine-tune's), D 48 (padded
    # to 64) and D 128, GQA-2, causal on a span from block 4 and
    # bidirectional
    pytest.param(4, 2, 512, d, causal, 4 if causal else 0,
                 id=f"d{d}-{'causal' if causal else 'bidir'}")
    for d in (64, 48, 128)
    for causal in (True, False)
]


@pytest.mark.parametrize("h,group,n,d,causal,base", TC32_FWD_CASES)
def test_cuda_tc32_fwd_kernel_matches_plain_twins(h, group, n, d, causal,
                                                  base):
    """The forward's "tc32" route (bf16 at 32 x 32 blocks): (O^s, lse) by
    `cases.tc_criterion` against the f32 twin and the twin that rounds P
    to bf16, O^l within 5e-5 x max(1, max |twin|); its counter moves once
    a call, at the head dim it pads to, and no other route's does."""
    _need_gpu()
    args, kw, _ = _operands(18, h, group, n, d, 32, torch.bfloat16, causal,
                            base, span=8)
    assert sla_fwd.forward_route(torch.bfloat16, 32, 32, d) == "tc32"
    width = sla_fwd.tc32_head_dim(d)
    before = _fwd_counters() + (sla_fwd.TC32_LAUNCHES,
                                sla_fwd.HEAD_DIMS[width])
    got = sla_fwd.sla_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters() + (sla_fwd.TC32_LAUNCHES,
                              sla_fwd.HEAD_DIMS[width]) == (
        before[0] + 1, before[1], before[2], before[3] + 1, before[4] + 1)
    assert got[0].shape == (h, args[2].shape[1], d)
    assert float(got[0].abs().max()) > 0 and float(got[1].abs().max()) > 0
    _assert_tc_fwd(got, sla_fwd.sla_fwd_plain(*args, **kw), args, kw)


def test_cuda_tc32_fwd_kernel_is_deterministic():
    """No atomics on the forward's "tc32" route: two launches on the same
    operands (causal GQA-2 with a row offset, D 64 and D 108 padded to
    128) are bitwise equal."""
    _need_gpu()
    for d in (64, 108):
        args, kw, _ = _operands(19, 4, 2, 1024, d, 32, torch.bfloat16, True,
                                8, span=16)
        before = sla_fwd.TC32_LAUNCHES
        first = sla_fwd.sla_fwd(*args, **kw)
        second = sla_fwd.sla_fwd(*args, **kw)
        torch.cuda.synchronize()
        assert sla_fwd.TC32_LAUNCHES == before + 2
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        _assert_tc_fwd(first, sla_fwd.sla_fwd_plain(*args, **kw), args, kw)


def test_cuda_tc32_fwd_kernel_stops_at_counts():
    """The forward's "tc32" route never reads a padded LUT slot: with
    every slot past the counts naming a block id far past the end of K
    and V, the outputs stay finite and bitwise what they are with those
    slots naming valid blocks (the twin, which gathers every slot before
    it masks, runs on the latter)."""
    _need_gpu()
    args, kw, _ = _operands(20, 4, 2, 512, 64, 32, torch.bfloat16, False, 0,
                            span=16)
    lut, counts = args[:2]
    counts = torch.clamp(counts - 1, min=1).contiguous()
    dead = torch.arange(lut.shape[-1], device="cuda") >= counts[..., None]
    assert int(dead.sum()) > 0
    far = torch.where(dead, torch.full_like(lut, 1 << 24), lut).contiguous()
    near = torch.where(dead, torch.zeros_like(lut), lut).contiguous()
    want = sla_fwd.sla_fwd(near, counts, *args[2:], **kw)
    got = sla_fwd.sla_fwd(far, counts, *args[2:], **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    call = (near, counts, *args[2:])
    _assert_tc_fwd(got, sla_fwd.sla_fwd_plain(*call, **kw), call, kw)


def test_cuda_fma_kernel_forced_at_the_tc32_shape():
    """`sla_fwd.cu` still takes bf16 at 32 x 32 blocks when forced (as
    chip_smoke times it beside the "tc32" kernel), within 5e-5 of the f32
    twin, and only the launch counter moves."""
    _need_gpu()
    args, kw, _ = _operands(21, 4, 2, 512, 64, 32, torch.bfloat16, True, 4,
                            span=8)
    before = _fwd_counters() + (sla_fwd.TC32_LAUNCHES,)
    got = sla_fwd._launch(*args, **kw, route="fma")
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters() + (sla_fwd.TC32_LAUNCHES,) == (
        before[0] + 1, before[1], before[2], before[3])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TWIN_TOL, rtol=TWIN_TOL)


def test_cuda_tc32_ctas_per_sm():
    """The occupancy query of the "tc32" forward kernel answers at both
    built head dims."""
    _need_gpu()
    assert all(sla_fwd.tc32_ctas_per_sm(d) >= 1 for d in (64, 128))


SPLIT_CASES = [c for c in CASES if c[4] == 64 and c[3] <= 128] + [
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
    args, kw, _ = _operands(1, 2, 1, 256, 260, 16, torch.float32, False, 0,
                            4)
    with pytest.raises(ValueError, match="head dims"):
        sla_fwd.sla_fwd(*args, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_fwd_kernel_at_d256_is_fma_and_deterministic(dtype):
    """Head dim 256 takes the f32-FMA route in both dtypes (the
    tensor-core and split routes stop at 128): the tc and split counters
    do not move, and two launches are bitwise equal."""
    _need_gpu()
    args, kw, _ = _operands(17, 4, 4, 512, 256, 64, dtype, True, 2, span=4)
    assert sla_fwd.forward_route(dtype, 64, 64, 256) == "fma"
    before = _fwd_counters()
    one = sla_fwd.sla_fwd(*args, **kw)
    two = sla_fwd.sla_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert _fwd_counters() == (before[0] + 2, before[1], before[2])
    assert all(torch.equal(x, y) for x, y in zip(one, two))


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
    (4, 1, 512, 64, 64, True),
    (3, 1, 512, 64, 64, False),
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


def _tc32_launches():
    return sla_bwd.TC32_LAUNCHES_DQ, sla_bwd.TC32_LAUNCHES_DKV


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
    5e-5, the tensor-core routes (bf16 at 64 x 64 blocks, and at 32 x 32)
    by the rounding criterion; the route's own counter moves once per
    call."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(11, h, group, n, d, block, dtype,
                                          causal)
    route = sla_bwd.backward_route(dtype, block, block, d)
    tc, tc32 = int(route == "tc"), int(route == "tc32")
    before, before32 = _launches(), _tc32_launches()
    got_dq = sla_bwd.sla_bwd_dq(*dq_args, **kw)
    got_dkv = sla_bwd.sla_bwd_dkv(*dkv_args, **kw)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == \
        (1, 1, tc, tc)
    assert tuple(a - b for a, b in zip(_tc32_launches(), before32)) == \
        (tc32, tc32)
    if route != "fma":
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


@pytest.mark.parametrize("d", [128, 256])
def test_cuda_bwd_kernels_stop_at_counts(d):
    """Rows and columns with no live entry get zero gradients whatever
    their padded slots name: the kernels (narrow and wide) never read past
    the counts."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(3, 2, 1, 512, d, 64,
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


TC32_BWD_CASES = [
    # (h, group, n, d, causal): D 64 (the fine-tune's), D 48 (padded to
    # 64) and D 128, GQA-2, causal and bidirectional
    pytest.param(4, 2, 512, d, causal,
                 id=f"d{d}-{'causal' if causal else 'bidir'}")
    for d in (64, 48, 128)
    for causal in (True, False)
]


@pytest.mark.parametrize("h,group,n,d,causal", TC32_BWD_CASES)
def test_cuda_tc32_bwd_kernels_match_plain_twins(h, group, n, d, causal):
    """The "tc32" route (bf16 at 32 x 32 blocks) against the f32 twin and
    the twin that rounds dO, P and dS to bf16, by `cases.tc_criterion`;
    its own counters move once a call, at the head dim it pads to."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(13, h, group, n, d, 32,
                                          torch.bfloat16, causal)
    assert sla_bwd.backward_route(torch.bfloat16, 32, 32, d) == "tc32"
    width = sla_bwd.tc32_head_dim(d)
    before, before32 = _launches(), _tc32_launches()
    dims = (sla_bwd.HEAD_DIMS_DQ[width], sla_bwd.HEAD_DIMS_DKV[width])
    got_dq = sla_bwd.sla_bwd_dq(*dq_args, **kw)
    got_dkv = sla_bwd.sla_bwd_dkv(*dkv_args, **kw)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 0, 0)
    assert tuple(a - b for a, b in zip(_tc32_launches(), before32)) == (1, 1)
    assert (sla_bwd.HEAD_DIMS_DQ[width] - dims[0],
            sla_bwd.HEAD_DIMS_DKV[width] - dims[1]) == (1, 1)
    assert got_dq.shape == (h, n, d) and got_dkv[0].shape == (h, n, d)
    assert float(got_dq.abs().max()) > 0
    _assert_tc(got_dq, sla_bwd.sla_bwd_dq_plain, dq_args, kw)
    _assert_tc(got_dkv, sla_bwd.sla_bwd_dkv_plain, dkv_args, kw)


def test_cuda_tc32_bwd_kernels_are_deterministic():
    """No atomics on the "tc32" route: two launches on the same operands
    are bitwise equal."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(14, 4, 2, 1024, 64, 32,
                                          torch.bfloat16, True)
    before = _tc32_launches()
    first = (sla_bwd.sla_bwd_dq(*dq_args, **kw),
             *sla_bwd.sla_bwd_dkv(*dkv_args, **kw))
    second = (sla_bwd.sla_bwd_dq(*dq_args, **kw),
              *sla_bwd.sla_bwd_dkv(*dkv_args, **kw))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_tc32_launches(), before)) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _masked_luts(mask, dead_block):
    """A row LUT (live blocks of each row of `mask` (BH, rows, cols) in
    order, then `dead_block` in every padded slot) and its counts."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    counts = mask.sum(-1, dtype=torch.int32)
    slots = torch.arange(mask.shape[-1], device=mask.device)
    lut = torch.where(slots < counts[..., None], order,
                      torch.full_like(order, dead_block))
    return lut.int().contiguous(), counts.contiguous()


def test_cuda_tc32_bwd_kernels_stop_at_counts():
    """The "tc32" kernels never read past the counts: with the padded
    slots of both LUTs naming blocks whose q, dO, L, D (last query block)
    or K, V (last kv block) are NaN, and those blocks' own counts 0, the
    gradients stay finite, zero in the dead blocks, bitwise what they are
    on the operands without NaN, and meet the rounding criterion."""
    _need_gpu()
    h, group, n, d, blk = 4, 2, 512, 64, 32
    dq_args, _, kw = _bwd_operands(15, h, group, n, d, blk, torch.bfloat16,
                                   False)
    t = n // blk
    gen = torch.Generator(device="cuda").manual_seed(15)
    mask = torch.rand((h, t, t), generator=gen, device="cuda") < 0.3
    mask[:, -1, :] = False  # the last query block: no live entry
    mask[:, :, -1] = False  # the last kv block: no live entry
    lut, counts = _masked_luts(mask, t - 1)
    col_lut, col_counts = _masked_luts(mask.transpose(1, 2), t - 1)
    assert int((counts < t).sum()) > 0 and int(col_counts[:, -1].max()) == 0
    q, k, v, do, lse, d_s = dq_args[2:]
    rows = slice(n - blk, n)
    q_nan, do_nan, lse_nan, ds_nan, k_nan, v_nan = (
        x.clone() for x in (q, do, lse, d_s, k, v))
    for x in (q_nan, do_nan, lse_nan, ds_nan, k_nan, v_nan):
        x[:, rows] = float("nan")
    clean = (q, k, v, do, lse, d_s)
    poisoned = (q_nan, k_nan, v_nan, do_nan, lse_nan, ds_nan)
    before = _tc32_launches()
    want = (sla_bwd.sla_bwd_dq(lut, counts, *clean, **kw),
            *sla_bwd.sla_bwd_dkv(col_lut, col_counts, *clean, **kw))
    got = (sla_bwd.sla_bwd_dq(lut, counts, *poisoned, **kw),
           *sla_bwd.sla_bwd_dkv(col_lut, col_counts, *poisoned, **kw))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_tc32_launches(), before)) == (2, 2)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.all(g[:, rows] == 0) for g in got)
    _assert_tc(got[0], sla_bwd.sla_bwd_dq_plain,
               (lut, counts, *poisoned), kw)
    _assert_tc(got[1:], sla_bwd.sla_bwd_dkv_plain,
               (col_lut, col_counts, *poisoned), kw)


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


def test_kernel_backend_bf16_grads_at_32x32_blocks_match_gather(
        monkeypatch):
    """bf16 compute at 32 x 32 blocks (smoke Wan, seq 256, D 32 padded to
    64), the fine-tune's routes: the forward and the backward on the
    "tc32" kernels; every parameter gradient and the loss meet the
    rounding criterion against the gather backend (f32 attention
    arithmetic), the "rounded" term from the kernel backend run through
    the forward twin that rounds P and the backward twins that round dO,
    P and dS to bf16."""
    _need_gpu()
    cfg = get_arch("wan2_1_1_3b").smoke()
    cfg = dataclasses.replace(cfg, sla=cfg.sla.replace(block_q=32,
                                                       block_kv=32))
    gen = torch.Generator(device="cuda").manual_seed(7)
    model = dit.init(gen, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                      device="cuda"))
    rs = np.random.default_rng(7)
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

    def counts():
        return (*_launches(), *_tc32_launches(), sla_fwd.LAUNCHES,
                sla_fwd.TC_LAUNCHES, sla_fwd.TC32_LAUNCHES)

    before = counts()
    got = grads("kernel")
    n = cfg.num_layers
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        n, n, 0, 0, n, n, n, 0, n)
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
    # D 256 (gemma3: 4 q heads on 1 kv head, 64-token blocks): lanes own
    # 8 columns and H streams through the stage in 64-row slices
    (2, 1, 4, 1, 256, 64, 32, 6, 20 * 64 + 29),
    (2, 1, 4, 4, 256, 64, 32, 6, 20 * 64 + 29),
    (1, 2, 2, 1, 160, 32, 16, 4, 9 * 32 + 10),
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


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_decode_partial_mode_over_spans_matches_its_twin(kv_dtype):
    """Kernel 4's partial mode (a split cache's span, before any divide)
    at the Qwen3 decode shape cut into 4 spans of 16 blocks: each span's
    records against the twin's at the kernel's width (5e-5 x max(1, max
    |twin|), field by field), two launches bitwise equal, one
    PARTIAL_LAUNCHES a call and no LAUNCHES; the spans' records combined
    across spans against unsplit kernel 4."""
    _need_gpu()
    args, kw = _decode_operands(17, 2, 8, 2, 1, 128, 64, 64, 6, kv_dtype,
                                40 * 64 + 29)
    want = sla_decode.sla_decode(*args, **kw)
    spans, n = 4, 16
    records = []
    for r in range(spans):
        ops_r = cases.span_operands(args, r * n, n)
        before = sla_decode.PARTIAL_LAUNCHES, sla_decode.LAUNCHES
        got = sla_decode.sla_decode_partial(*ops_r, **kw)
        again = sla_decode.sla_decode_partial(*ops_r, **kw)
        torch.cuda.synchronize()
        assert (sla_decode.PARTIAL_LAUNCHES, sla_decode.LAUNCHES) == (
            before[0] + 2, before[1])
        assert torch.equal(got, again)
        w = sla_decode.split_geometry(ops_r[3], ops_r[0])["split_width"]
        twin = sla_decode.sla_decode_partial_plain(*ops_r, **kw,
                                                   split_width=w)
        err = cases.record_error(got, twin)
        assert err["err"] <= TWIN_TOL and err["neutral_ok"], (r, err)
        records.append(got)
    o_s, o_l = cases.span_combine(torch.stack(records), args, kw["group"])
    _assert_twin((o_s, o_l), want)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("spans", [4, 16])
def test_cuda_paged_partial_mode_is_kernel_4s_on_the_gathered_view(
        spans, kv_dtype):
    """Kernel 5's partial mode (a split paged cache's span, read through
    the span's columns of the page table) at the Qwen3 decode shape, 4
    slots sharing 12 pages, cut into `spans` spans: at the chosen split
    width and at every width 1 .. K, each span's records bitwise kernel
    4's partial mode on the page-gathered view of the span and two
    launches bitwise equal (one PAGED_PARTIAL_LAUNCHES a call, no other
    count); at the chosen width against its twin (5e-5 x max(1, max
    |twin|), field by field), and the spans' records combined against
    unsplit kernel 5."""
    _need_gpu()
    pargs, kw = cases.paged_decode_operands(
        12, kv_dtype, 20 * 64 + 29, b=4, hkv=8, g=2, d=128, bkv=64, tn=32,
        npages=140, k_sel=6, shared=12)
    want = sla_decode.sla_decode_paged(*pargs, **kw)
    n = 32 // spans
    for width in (None, *range(1, 7)):
        records = []
        for first in range(0, 32, n):
            paged, dense = cases.paged_span_operands(pargs, first, n)
            counts = (sla_decode.PAGED_PARTIAL_LAUNCHES,
                      sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES)
            got = sla_decode.sla_decode_paged_partial(*paged, **kw,
                                                      split_width=width)
            again = sla_decode.sla_decode_paged_partial(*paged, **kw,
                                                        split_width=width)
            torch.cuda.synchronize()
            assert (sla_decode.PAGED_PARTIAL_LAUNCHES,
                    sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES) == (
                counts[0] + 2, counts[1], counts[2])
            mono = sla_decode.sla_decode_partial(*dense, **kw,
                                                 split_width=width)
            assert torch.equal(got, again) and torch.equal(got, mono), (
                width, first)
            records.append(got)
            if width is None:
                w = sla_decode.split_geometry(paged[4], paged[0])[
                    "split_width"]
                twin = sla_decode.sla_decode_paged_partial_plain(
                    *paged, **kw, split_width=w)
                err = cases.record_error(got, twin)
                assert err["err"] <= TWIN_TOL and err["neutral_ok"], err
        if width is None:
            _assert_twin(cases.span_combine(
                torch.stack(records), cases.paged_dense_operands(pargs),
                kw["group"]), want)


SLOT_ROW_CASES = {  # slot positions (64-token blocks, spans of 16), C
    # continuous batching: each slot's rows at its own position, in
    # different spans
    "slot-rows": ([40 * 64 + 29, 13 * 64 + 5], 1),
    # verify-style decode: 16 tokens across the end of the first span
    # (block 16), each with its diagonal partial
    "chunk-span-end": ([15 * 64 + 56, 15 * 64 + 56], 16),
    "chunk-slots": ([15 * 64 + 56, 47 * 64 + 60], 16),
}


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", list(SLOT_ROW_CASES))
def test_cuda_decode_partial_mode_at_slot_rows_and_chunks(rows, kv_dtype):
    """Kernel 4's partial mode on the rows continuous batching and
    verify-style decode give it (`cases.slot_decode_operands`) at the
    Qwen3 decode shape (Hkv 8, G 2, D 128, 64 blocks of 64, K 6) cut into
    4 spans of 16 blocks: a different position in each slot's rows, and
    C = 16 tokens straddling a span's end with their diagonal partials.
    Each span's records against the twin's at the kernel's width (5e-5 x
    max(1, max |twin|), field by field), two launches bitwise equal, one
    PARTIAL_LAUNCHES a call; the spans' records combined against unsplit
    kernel 4."""
    _need_gpu()
    pos, c = SLOT_ROW_CASES[rows]
    args, kw = cases.slot_decode_operands(23, "cuda", kv_dtype, pos, hkv=8,
                                          g=2, c=c, d=128, bkv=64, tn=64,
                                          k_sel=6)
    want = sla_decode.sla_decode(*args, **kw)
    spans, n = 4, 16
    records = []
    for r in range(spans):
        ops_r = cases.span_operands(args, r * n, n)
        before = sla_decode.PARTIAL_LAUNCHES
        got = sla_decode.sla_decode_partial(*ops_r, **kw)
        again = sla_decode.sla_decode_partial(*ops_r, **kw)
        torch.cuda.synchronize()
        assert sla_decode.PARTIAL_LAUNCHES == before + 2
        assert torch.equal(got, again)
        w = sla_decode.split_geometry(ops_r[3], ops_r[0])["split_width"]
        twin = sla_decode.sla_decode_partial_plain(*ops_r, **kw,
                                                   split_width=w)
        err = cases.record_error(got, twin)
        assert err["err"] <= TWIN_TOL and err["neutral_ok"], (r, err)
        records.append(got)
    o_s, o_l = cases.span_combine(torch.stack(records), args, kw["group"])
    _assert_twin((o_s, o_l), want)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_decode_kernels_at_d256_are_deterministic(kv_dtype):
    """At head dim 256 (H in slices): two launches of kernel 4 bitwise
    equal at C 1 and 4, and kernel 5 bitwise equal to kernel 4 on the
    gathered view at every split width."""
    _need_gpu()
    for c in (1, 4):
        args, kw = _decode_operands(13, 2, 1, 4, c, 256, 64, 32, 6,
                                    kv_dtype, 20 * 64 + 29)
        one = sla_decode.sla_decode(*args, **kw)
        two = sla_decode.sla_decode(*args, **kw)
        assert all(torch.equal(x, y) for x, y in zip(one, two))
    pargs, pkw = cases.paged_decode_operands(
        14, kv_dtype, 10 * 64 + 29, b=2, hkv=1, g=4, d=256, bkv=64, tn=24,
        npages=60, k_sel=6, shared=6)
    dense = cases.paged_dense_operands(pargs)
    for width in (None, 1, 2, 3, 6):
        paged = sla_decode.sla_decode_paged(*pargs, **pkw, split_width=width)
        mono = sla_decode.sla_decode(*dense, **pkw, split_width=width)
        assert all(torch.equal(x, y) for x, y in zip(paged, mono))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 192])
def test_cuda_bwd_kernels_at_wide_heads_match_f32_twins(d, dtype):
    """Above head dim 128 (gemma3's 256) both backward kernels take the
    f32-FMA route in either dtype (its wide kernels): held to the f32
    twins within 5e-5 x max(1, max |twin|), the tensor-core counters
    still, the head dim recorded, two launches bitwise equal."""
    _need_gpu()
    dq_args, dkv_args, kw = _bwd_operands(18, 4, 4, 512, d, 64, dtype, True)
    assert not sla_bwd.use_tensor_cores(dtype, 64, 64, d)
    before = _launches()
    dims = (sla_bwd.HEAD_DIMS_DQ[d], sla_bwd.HEAD_DIMS_DKV[d])
    first = (sla_bwd.sla_bwd_dq(*dq_args, **kw),
             *sla_bwd.sla_bwd_dkv(*dkv_args, **kw))
    second = (sla_bwd.sla_bwd_dq(*dq_args, **kw),
              *sla_bwd.sla_bwd_dkv(*dkv_args, **kw))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (2, 2, 0, 0)
    assert (sla_bwd.HEAD_DIMS_DQ[d], sla_bwd.HEAD_DIMS_DKV[d]) == \
        (dims[0] + 2, dims[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_twin(first[0], sla_bwd.sla_bwd_dq_plain(*dq_args, **kw))
    _assert_twin(first[1:], sla_bwd.sla_bwd_dkv_plain(*dkv_args, **kw))
    assert all(float(x.abs().max()) > 0 for x in first)


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
    (2, 1, 4, 256, 64, 24, 60, 6, 6, 10 * 64 + 29, True),
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


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "moonshot-v1-16b-a3b"])
def test_lm_train_step_on_the_card_kernel_vs_gather(arch):
    """One LM make_train_step (bf16 compute over f32 masters, AdamW,
    remat) on each backend from the same seeded smoke weights and token
    batch: the same loss and grad norm to bf16 noise, finite, and the
    kernels ran once per layer (twice for the forward: its remat
    recompute)."""
    _need_gpu()
    from repro_torch.configs import get_shape
    from repro_torch.data import pipeline
    cfg = get_arch(arch).smoke()
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipeline.token_batch(
        cfg, get_shape("train_4k", smoke=True), pipeline.DataConfig(), 0
    ).items()}
    out = {}
    for backend in ("kernel", "gather"):
        model = transformer.init(torch.Generator("cuda").manual_seed(3), cfg,
                                 device="cuda")
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


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small"])
def test_family_train_step_on_the_card_kernel_vs_gather(arch):
    """One make_train_step of the hybrid (causal shared SLA block) and
    the encoder-decoder (non-causal SLA encoder) smoke configs at 64 x 64
    blocks and head dim 64, so that kernels 1-3 take the tensor cores at
    D 64 (zero-padded to 128), on each backend from the same seeded
    weights and batch: the same loss and grad norm to bf16 noise, and the
    kernels ran once per SLA call (the encoder's forward twice: its remat
    recompute)."""
    _need_gpu()
    from repro_torch.configs import get_shape
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    cfg = get_arch(arch).smoke()
    cfg = dataclasses.replace(cfg, head_dim=64, sla=cfg.sla.replace(
        block_q=64, block_kv=64))
    mdl = registry.get_model(cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipeline.token_batch(
        cfg, get_shape("train_4k", smoke=True), pipeline.DataConfig(), 0
    ).items()}
    out = {}
    for backend in ("kernel", "gather"):
        model = mdl.init(torch.Generator("cuda").manual_seed(3), cfg,
                         device="cuda")
        step = steps.make_train_step(
            cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
            backend=backend)
        state = adamw.init(dict(model.named_parameters()))
        names = ("LAUNCHES", "TC_LAUNCHES")
        before = ([getattr(sla_fwd, n) for n in names]
                  + [getattr(sla_bwd, n + s) for n in names
                     for s in ("_DQ", "_DKV")])
        with ctx.activation_sharding(remat=True):
            model, state, loss, gnorm = step(model, state, batch)
        after = ([getattr(sla_fwd, n) for n in names]
                 + [getattr(sla_bwd, n + s) for n in names
                    for s in ("_DQ", "_DKV")])
        out[backend] = (float(loss), float(gnorm),
                        tuple(a - b for a, b in zip(after, before)))
    if cfg.family == "hybrid":
        n = len(registry.get_model(cfg).segments(cfg))
        want = (n, n, n, n, n, n)
    else:
        n = cfg.encoder_layers
        want = (2 * n, 2 * n, n, n, n, n)
    assert out["kernel"][2] == want
    assert out["gather"][2] == (0,) * 6
    assert all(np.isfinite(out[b][:2]).all() for b in out)
    np.testing.assert_allclose(out["kernel"][:2], out["gather"][:2],
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_ffn_on_the_card_matches_the_cpu(dtype):
    """The MoE FFN (smoke moonshot: 4 experts, top-2, capacity binding at
    factor 0.5) on the card against the same call on the CPU: routing
    integers equal on inputs with a margin between the k-th and (k+1)-th
    probability, output, aux and gradients within 5e-5 x max(1, max
    |cpu|) in f32 and 5e-2 in bf16."""
    _need_gpu()
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").smoke(),
                              capacity_factor=0.5)
    mod = moe.moe_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(5))
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(6))

    def module(dev):
        m = moe.moe_init(None, cfg, device=dev)
        m.load_state_dict(mod.state_dict())
        return m.to(dtype)

    with torch.no_grad():
        top = moe.route(module("cpu").router, x.to(dtype).reshape(
            -1, cfg.d_model), cfg)["probs"].sort(dim=-1,
                                                 descending=True).values
    k = cfg.experts_per_token
    assert float((top[:, k - 1] - top[:, k]).min()) > 1e-4  # the premise
    runs = {}
    for dev in ("cpu", "cuda"):
        m = module(dev)
        xx = x.to(dev, dtype).clone().requires_grad_()
        r = moe.route(m.router, xx.detach().reshape(-1, cfg.d_model), cfg)
        out, aux = moe.moe_apply(m, xx, cfg)
        ((out.float() * cot.to(dev)).sum() + aux).backward()
        runs[dev] = dict(
            ints=[r[n].cpu() for n in ("eidx", "keep", "dst")],
            floats=[out.detach().float().cpu(), aux.detach().cpu(),
                    xx.grad.float().cpu()]
            + [p.grad.float().cpu() for p in m.parameters()])
    assert bool((~runs["cpu"]["ints"][1]).any())  # slots drop
    for a, b in zip(runs["cuda"]["ints"], runs["cpu"]["ints"]):
        assert torch.equal(a, b)
    tol = TWIN_TOL if dtype == torch.float32 else 5e-2
    for a, b in zip(runs["cuda"]["floats"], runs["cpu"]["floats"]):
        assert float((a - b).abs().max()) <= tol * max(
            1.0, float(b.abs().max()))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "lightningdit_1b",
                                  "moonshot-v1-16b-a3b", "zamba2-1.2b",
                                  "whisper-small", "rwkv6-7b"])
def test_train_on_a_1x1_nccl_mesh_is_the_plain_path(arch, tmp_path):
    """Two make_train_step steps (bf16 compute over f32 masters, kernel
    backend, remat) from the same seeded smoke weights and batches, on
    the plain path and with every parameter and moment a DTensor on a
    1 x 1 mesh over NCCL in this process: losses, grad norms and final
    parameters bitwise equal, and both paths launched the forward and
    backward kernels as often as the family's layers say (rwkv6 does not
    attend)."""
    _need_gpu()
    import torch.distributed as dist
    from repro_torch.configs import get_shape
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import registry
    cfg = get_arch(arch).smoke()
    shape = get_shape("train_4k", smoke=True)
    it = pipeline.make_iterator(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
               for _ in range(2)]

    def run(mesh):
        mdl = registry.get_model(cfg)
        model = mdl.init(torch.Generator("cuda").manual_seed(3), cfg,
                         device="cuda")
        if mesh is not None:
            sharding.place_module(model, mesh)
        named = dict(model.named_parameters())
        state = adamw.init(named)
        step = steps.make_train_step(
            cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
            backend="kernel")
        residual = (None if mesh is None else ctx.default_residual_spec(
            mesh, shape.global_batch, shape.seq_len))
        before = (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ,
                  sla_bwd.LAUNCHES_DKV)
        out = []
        with ctx.activation_sharding(mesh, residual, remat=True):
            for batch in batches:
                model, state, loss, gnorm = step(model, state, batch)
                out.append((loss, gnorm))
        launches = tuple(a - b for a, b in zip(
            (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV),
            before))
        final = {n: sharding.local(p).detach() for n, p in named.items()}
        return out, final, launches

    want, want_p, want_n = run(None)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got, got_p, got_n = run(mesh_lib.make_host_mesh(1, 1, "cuda"))
    finally:
        dist.destroy_process_group()
    # SLA forward (remat runs it twice where a layer is rematerialized)
    # and backward launches a step
    from repro_torch.models import hybrid
    fwd, bwd = {"hybrid": (len(hybrid.segments(cfg)),) * 2,
                "encdec": (2 * cfg.encoder_layers, cfg.encoder_layers),
                "ssm": (0, 0)}.get(cfg.family,
                                   (2 * cfg.num_layers, cfg.num_layers))
    assert got_n == want_n == (2 * fwd, 2 * bwd, 2 * bwd)
    for (gl, gg), (wl, wg) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gg, wg)
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)


@pytest.mark.parametrize("spans", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_decode_combine_on_the_card(spans, dtype):
    """Sharded decode's partial softmax over each span of a card cache
    and the combine in span order (`distributed/serving.py`) against
    `_dense_decode_attn` over the whole cache: f32 within 5e-5 x max(1,
    max |o|), bf16 within 5e-2; shared and per-slot positions, a sliding
    window on global columns; the combine bitwise on repeat."""
    _need_gpu()
    from repro_torch.distributed import serving
    cfg = dataclasses.replace(get_arch("qwen3-1.7b"), local_window=300)
    b, h, hkv, n, d = 2, 8, 2, 1024, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(spans)
    q, kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, h, 1, d), (b, hkv, n, d), (b, hkv, n, d)))
    tol = TWIN_TOL if dtype == torch.float32 else 5e-2
    step = n // spans
    for pos in (700, torch.tensor([700, n - 1], device="cuda")):
        for kind, window in ((transformer.KIND_SLA, 0),
                             (transformer.KIND_SWA, cfg.local_window)):
            want = transformer._dense_decode_attn(q, kc, vc, pos, kind, cfg)
            parts = torch.stack([serving.decode_partial(
                q[:, :, 0], kc[:, :, i * step:(i + 1) * step],
                vc[:, :, i * step:(i + 1) * step], pos, i * step, window)
                for i in range(spans)])
            got = serving.decode_combine(parts)
            assert torch.equal(got, serving.decode_combine(parts.clone()))
            err = float((got.to(dtype).reshape(want.shape).float()
                         - want.float()).abs().max())
            assert err <= tol * max(1.0, float(want.float().abs().max()))


def test_serve_on_a_1x1_nccl_mesh_is_the_plain_path(tmp_path):
    """Smoke qwen3 in bf16: `make_prefill_step(cache_len=)` and 4 greedy
    `make_serve_step` steps on the plain path and with the parameters on
    a 1 x 1 mesh over NCCL in this process: logits, K/V caches and tokens
    bitwise equal, and kernel 1 launched once a layer in each prefill."""
    _need_gpu()
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    cfg = get_arch("qwen3-1.7b").smoke()
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))

    def run(mesh):
        model = transformer.init(torch.Generator("cuda").manual_seed(3), cfg,
                                 dtype=torch.bfloat16, device="cuda")
        if mesh is not None:
            sharding.place_module(model, mesh)
        residual = (None if mesh is None else ctx.default_residual_spec(
            mesh, 2, 128))
        before = sla_fwd.LAUNCHES
        with torch.no_grad(), ctx.activation_sharding(mesh, residual,
                                                       remat=False):
            hidden, cache = steps.make_prefill_step(
                cfg, "kernel", cache_len=128)(model, {"tokens": toks})
            launches = sla_fwd.LAUNCHES - before
            logits = [transformer.logits_from_hidden(model, hidden)]
            serve = steps.make_serve_step(cfg)
            for _ in range(4):
                step, cache = serve(model, logits[-1].argmax(-1), cache)
                logits.append(step)
        return torch.stack(logits), cache, launches

    want, want_c, want_n = run(None)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got, got_c, got_n = run(mesh_lib.make_host_mesh(1, 1, "cuda"))
    finally:
        dist.destroy_process_group()
    assert got_n == want_n == cfg.num_layers
    assert torch.equal(got, want)
    assert torch.equal(got_c["k"], want_c["k"])
    assert torch.equal(got_c["v"], want_c["v"])
    assert got_c["pos"] == want_c["pos"] == 68


def test_hybrid_serve_on_a_1x1_nccl_mesh_is_the_plain_path(tmp_path):
    """Smoke zamba2 in bf16: `make_prefill_step(cache_len=)` and 4 greedy
    `make_serve_step` steps on the plain path and with the parameters on
    a 1 x 1 mesh over NCCL in this process: logits, every cache leaf (SSM
    states, conv tails, the shared block's K/V) and tokens bitwise equal,
    and kernel 1 launched once an application in each prefill."""
    _need_gpu()
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import hybrid
    cfg = get_arch("zamba2-1.2b").smoke()
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))

    def run(mesh):
        model = hybrid.init(torch.Generator("cuda").manual_seed(3), cfg,
                            dtype=torch.bfloat16, device="cuda")
        if mesh is not None:
            sharding.place_module(model, mesh)
        residual = (None if mesh is None else ctx.default_residual_spec(
            mesh, 2, 128))
        before = sla_fwd.LAUNCHES
        with torch.no_grad(), ctx.activation_sharding(mesh, residual,
                                                       remat=False):
            hidden, cache = steps.make_prefill_step(
                cfg, "kernel", cache_len=128)(model, {"tokens": toks})
            launches = sla_fwd.LAUNCHES - before
            logits = [hybrid.logits_from_hidden(model, hidden)]
            serve = steps.make_serve_step(cfg)
            for _ in range(4):
                step, cache = serve(model, logits[-1].argmax(-1), cache)
                logits.append(step)
        return torch.stack(logits), cache, launches

    want, want_c, want_n = run(None)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got, got_c, got_n = run(mesh_lib.make_host_mesh(1, 1, "cuda"))
    finally:
        dist.destroy_process_group()
    assert got_n == want_n == len(hybrid.segments(cfg))
    assert torch.equal(got, want)
    for key in ("ssm", "conv", "attn_k", "attn_v"):
        assert torch.equal(got_c[key], want_c[key]), key
    assert got_c["pos"] == want_c["pos"] == 68
