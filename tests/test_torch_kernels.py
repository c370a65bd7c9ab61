"""The fused forward kernel's plain twin against the Pallas kernel.

`repro_torch.kernels.sla_fwd.sla_fwd_plain` is held to
`repro.kernels.sla_fwd.sla_fwd(interpret=True)` on the same numpy inputs:
f32 and bf16, bidirectional and causal with a `base` row offset, GQA
group 2, head dims 32 and 108. Tolerances are the conformance matrix's
(tests/test_conformance.py): f32 5e-5, bf16 5e-2.

The twin's `mma_dtype=torch.bfloat16` form, which rounds P to bf16 before
P V where the tensor-core kernels (bf16 at 64 x 64 blocks, and the "tc32"
kernel at 32 x 32 blocks) do, is held to the Pallas kernel within the
bf16 limit, at 32 x 32 blocks on D 64 and 128 too; the route rules the
forward shares with the backward (one at each block size), the head-dim
padding of those routes, and the build's hashing of the shared CUDA
headers are checked here too.

The twin's `mma_dtype="bf16x3"` form computes Q K^T and P V as the split
kernel (f32 at 64 x 64 blocks, on the tensor cores) does: three bf16
parts of each operand, six part products summed in f32. It is held to
the Pallas kernel within 5e-5 and to the f32 twin within 1e-5, the cut
(`split_bf16x3`) to recombine exactly, and the forward's three-way route
rule is checked on a table of dtypes, blocks and head dims.

The CUDA kernels themselves run only on a GPU: their tests are in
tests/test_torch_gpu.py, which imports no JAX so that it runs on the card.
"""
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import plan as jplan
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.kernels.sla_fwd import sla_fwd as jax_sla_fwd
from repro_torch.core.config import SLAConfig
from repro_torch.core.phi import phi
from repro_torch.core.plan import plan_attention
from repro_torch.kernels import _build, ops, ref, sla_bwd, sla_fwd

TOL = {"f32": 5e-5, "bf16": 5e-2}
BLOCK = 16


def _case(seed, d, group, causal, base, dtype, h=4, n=128, span=4,
          block=BLOCK):
    """Numpy operands for one kernel call at `block` x `block` blocks.
    Causal cases attend a span of `span` query blocks starting at block
    `base` against the full KV."""
    rs = np.random.default_rng(seed)
    hkv = h // group
    q = rs.standard_normal((h, n, d), dtype=np.float32)
    k = rs.standard_normal((hkv, n, d), dtype=np.float32)
    v = rs.standard_normal((hkv, n, d), dtype=np.float32)
    if dtype == "bf16":  # round once; both sides then see the same values
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    cfg = JaxSLAConfig(block_q=block, block_kv=block, kh_frac=0.5,
                       kl_frac=0.25, causal=causal)
    plan = jplan.plan_attention(jnp.asarray(q[None]),
                                jnp.asarray(k[None]), cfg)
    lut, counts = np.asarray(plan.lut[0]), np.asarray(plan.counts[0])
    if causal:
        rows = slice(base, base + span)
        q, lut, counts = q[:, base * block:(base + span) * block], \
            lut[:, rows], counts[:, rows]
    else:
        base = 0
    tm = q.shape[1] // block
    qp = np.exp(q - q.max(-1, keepdims=True))
    qp = (qp / qp.sum(-1, keepdims=True)).astype(np.float32)
    hi = (0.1 * rs.standard_normal((h, tm, d, d))).astype(np.float32)
    zi = np.abs(rs.standard_normal((h, tm, d))).astype(np.float32)
    zi[0, 0] = 0.0  # an empty marginal set: o_l must be exactly 0 there
    return dict(lut=lut.astype(np.int32), counts=counts.astype(np.int32),
                q=q, k=k, v=v, qp=qp, hi=hi, zi=zi), base


def _torch_args(ops, dtype):
    t = {name: torch.from_numpy(np.array(a)) for name, a in ops.items()}
    if dtype == "bf16":
        for name in ("q", "k", "v"):
            t[name] = t[name].to(torch.bfloat16)
    return [t[n] for n in ("lut", "counts", "q", "k", "v", "qp", "hi", "zi")]


def _jax_args(ops, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return [jnp.asarray(ops["lut"]), jnp.asarray(ops["counts"]),
            *(jnp.asarray(ops[n], jd) for n in ("q", "k", "v")),
            jnp.asarray(ops["qp"]), jnp.asarray(ops["hi"]),
            jnp.asarray(ops["zi"])]


CASES = [
    pytest.param(d, group, causal, base, dtype,
                 id=f"d{d}-g{group}-{'causal' if causal else 'bidir'}"
                    f"{base}-{dtype}")
    for d in (32, 108)
    for group in (1, 2)
    for causal, base in ((False, 0), (True, 4))
    for dtype in ("f32", "bf16")
]


@pytest.mark.parametrize("d,group,causal,base,dtype", CASES)
def test_plain_twin_matches_pallas_kernel(d, group, causal, base, dtype):
    ops, base = _case(d + group, d, group, causal, base, dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=BLOCK,
              block_kv=BLOCK)
    want = jax_sla_fwd(*_jax_args(ops, dtype), **kw, interpret=True,
                       base=jnp.asarray([base], jnp.int32))
    launches = sla_fwd.LAUNCHES
    got = sla_fwd.sla_fwd(*_torch_args(ops, dtype), **kw, base=base)
    assert sla_fwd.LAUNCHES == launches  # CPU tensors: the plain twin
    for name, g, w in zip(("o_s", "o_l", "lse"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=name)
    assert torch.all(got[1][0, :BLOCK] == 0.0)  # den <= eps rows


BF16_CASES = [c for c in CASES if c.values[-1] == "bf16"]
# the same at 32 x 32 blocks, the "tc32" route's (n 256, a span of 4
# query blocks from block 4 when causal): D 64 (the fine-tune's) and 128,
# GQA-2
ROUNDED_CASES = [pytest.param(*c.values, BLOCK, id=c.id)
                 for c in BF16_CASES] + [
    pytest.param(d, 2, causal, 4 if causal else 0, "bf16", 32,
                 id=f"d{d}-g2-{'causal4' if causal else 'bidir0'}-bf16-"
                    f"32x32")
    for d in (64, 128)
    for causal in (False, True)
]


@pytest.mark.parametrize("d,group,causal,base,dtype,block", ROUNDED_CASES)
def test_rounded_twin_matches_pallas_kernel(d, group, causal, base, dtype,
                                            block):
    """The twin that rounds P to bf16 before P V (the tensor-core routes'
    rounding, "tc" and "tc32") against the Pallas kernel, within the bf16
    limit; it leaves l, and so lse, bitwise as the f32 twin has them."""
    n = 128 if block == BLOCK else 256
    ops, base = _case(d + group, d, group, causal, base, dtype, n=n,
                      block=block)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=block,
              block_kv=block)
    want = jax_sla_fwd(*_jax_args(ops, dtype), **kw, interpret=True,
                       base=jnp.asarray([base], jnp.int32))
    args = _torch_args(ops, dtype)
    got = sla_fwd.sla_fwd_plain(*args, **kw, base=base,
                                mma_dtype=torch.bfloat16)
    f32 = sla_fwd.sla_fwd_plain(*args, **kw, base=base)
    for name, g, w in zip(("o_s", "o_l", "lse"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=TOL["bf16"], rtol=TOL["bf16"],
                                   err_msg=name)
    assert float((got[0] - f32[0]).abs().max()) > 0  # P was rounded
    assert torch.equal(got[1], f32[1]) and torch.equal(got[2], f32[2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_twin_without_mma_dtype_is_the_default_twin(dtype):
    """`mma_dtype=None` is bitwise the twin as it was before the option."""
    ops, base = _case(3, 32, 2, True, 4, dtype)
    kw = dict(scale=32 ** -0.5, causal=True, block_q=BLOCK, block_kv=BLOCK,
              base=base)
    args = _torch_args(ops, dtype)
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    got = sla_fwd.sla_fwd_plain(*args, **kw, mma_dtype=None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mma_dtype", [None, torch.bfloat16],
                         ids=["f32", "rounded"])
def test_head_dim_padding_leaves_the_twin_unchanged(mma_dtype):
    """The tensor-core route zero-pads q, k and v from 108 to the kernel's
    width: zero columns leave S unchanged, so the twin on padded operands
    (qp, hi and zi padded with zeros too), sliced back, is the unpadded
    twin within 1e-6."""
    ops, base = _case(5, 108, 2, True, 4, "bf16")
    kw = dict(scale=108 ** -0.5, causal=True, block_q=BLOCK, block_kv=BLOCK,
              base=base, mma_dtype=mma_dtype)
    args = _torch_args(ops, "bf16")
    pad = sla_fwd.TC_HEAD_DIM - 108
    padded = args[:2] + [sla_fwd.pad_head_dim(x) for x in args[2:6]] + [
        torch.nn.functional.pad(args[6], (0, pad, 0, pad)),
        sla_fwd.pad_head_dim(args[7])]
    assert padded[2].shape[-1] == sla_fwd.TC_HEAD_DIM
    assert torch.all(padded[3][..., 108:] == 0)
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    got = sla_fwd.sla_fwd_plain(*padded, **kw)
    for g, w in zip(got[:2], want[:2]):
        assert float(g[..., 108:].abs().max()) == 0
        torch.testing.assert_close(g[..., :108], w, atol=1e-6, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,block_q,block_kv,d,tc", [
    (torch.bfloat16, 64, 64, 128, True),
    (torch.bfloat16, 64, 64, 108, True),
    (torch.float32, 64, 64, 128, False),
    (torch.bfloat16, 16, 16, 108, False),
    (torch.bfloat16, 64, 64, 132, False),
])
def test_forward_and_backward_share_one_route_rule(dtype, block_q, block_kv,
                                                   d, tc):
    """One rule object decides the forward's and the backward's route at
    64 x 64 blocks, so a training step there rounds alike in both
    directions (the backward's 32 x 32 route, `sla_bwd.backward_route`,
    has no forward counterpart)."""
    assert sla_bwd.use_tensor_cores is sla_fwd.use_tensor_cores
    assert sla_bwd.pad_head_dim is sla_fwd.pad_head_dim
    assert (sla_bwd.TC_BLOCK, sla_bwd.TC_HEAD_DIM) == (sla_fwd.TC_BLOCK,
                                                       sla_fwd.TC_HEAD_DIM)
    assert sla_fwd.use_tensor_cores(dtype, block_q, block_kv, d) is tc


@pytest.mark.parametrize("d,group,causal", [(64, 2, False), (128, 2, True),
                                            (48, 1, True)])
def test_forward_and_backward_share_the_32x32_route_rule(d, group, causal):
    """One rule object decides "tc32" for the forward and the backward, so
    a bf16 step at 32 x 32 blocks rounds P alike in both directions (as
    `use_tensor_cores` does at 64 x 64); both pad to the same width, and
    a CPU call at that shape runs the f32 twin with no launch counted."""
    assert sla_bwd.use_tensor_cores_32 is sla_fwd.use_tensor_cores_32
    assert sla_bwd.tc32_head_dim is sla_fwd.tc32_head_dim
    assert sla_bwd.TC32_BLOCK == sla_fwd.TC32_BLOCK == 32
    block = sla_fwd.TC32_BLOCK
    assert sla_fwd.forward_route(torch.bfloat16, block, block, d) == \
        sla_bwd.backward_route(torch.bfloat16, block, block, d) == "tc32"
    assert sla_fwd.tc32_head_dim(d) == (64 if d <= 64 else 128)
    ops, base = _case(50 + d, d, group, causal, 2, "bf16", n=256,
                      block=block)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=block,
              block_kv=block, base=base)
    args = _torch_args(ops, "bf16")
    counters = ("LAUNCHES", "TC_LAUNCHES", "TC32_LAUNCHES")
    before = [getattr(sla_fwd, c) for c in counters]
    got = sla_fwd.sla_fwd(*args, **kw)
    assert [getattr(sla_fwd, c) for c in counters] == before
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_tensors_at_the_tensor_core_shape_run_the_f32_twin():
    """A CPU call at the tensor-core route's shape (bf16, 64 x 64 blocks,
    D 108) runs the f32 twin, with no rounding of P, and counts no launch
    of either route."""
    ops, _ = _case(2, 108, 1, False, 0, "bf16", n=256)
    args = _torch_args(ops, "bf16")
    h, n = args[2].shape[:2]
    tm = n // 64
    lut = torch.stack([torch.arange(tm, dtype=torch.int32)] * h)
    call = [lut[..., None], torch.ones_like(lut), *args[2:6],
            torch.zeros((h, tm, 108, 108)), torch.ones((h, tm, 108))]
    kw = dict(scale=108 ** -0.5, causal=False, block_q=64, block_kv=64)
    assert sla_fwd.use_tensor_cores(args[2].dtype, 64, 64, 108)
    before = (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES)
    got = sla_fwd.sla_fwd(*call, **kw)
    assert (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES) == before
    want = sla_fwd.sla_fwd_plain(*call, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


F32_CASES = [c for c in CASES if c.values[-1] == "f32"]
SPLIT_TOL = 1e-5  # split twin vs f32 twin, x max(1, max |twin|)


@pytest.mark.parametrize("d,group,causal,base,dtype", F32_CASES)
def test_split_twin_matches_pallas_kernel(d, group, causal, base, dtype):
    """The twin that cuts and sums the products as the split kernel does
    (`mma_dtype="bf16x3"`) against the Pallas kernel at the f32 limit."""
    ops, base = _case(d + group, d, group, causal, base, dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=BLOCK,
              block_kv=BLOCK)
    want = jax_sla_fwd(*_jax_args(ops, dtype), **kw, interpret=True,
                       base=jnp.asarray([base], jnp.int32))
    got = sla_fwd.sla_fwd_plain(*_torch_args(ops, dtype), **kw, base=base,
                                mma_dtype="bf16x3")
    for name, g, w in zip(("o_s", "o_l", "lse"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=TOL["f32"], rtol=TOL["f32"],
                                   err_msg=name)


@pytest.mark.parametrize("d,group,causal,base,dtype", F32_CASES)
def test_split_twin_matches_f32_twin(d, group, causal, base, dtype,
                                     record_property):
    """The split twin against the f32 twin within 1e-5 x max(1, max
    |twin|) on o_s, o_l and lse (the measured distance is recorded as
    `split_twin_max_abs_err`); O^l, whose arithmetic is the f32 twin's on
    either, is bitwise equal."""
    ops, base = _case(d + group, d, group, causal, base, dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=BLOCK,
              block_kv=BLOCK, base=base)
    args = _torch_args(ops, dtype)
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    got = sla_fwd.sla_fwd_plain(*args, **kw, mma_dtype="bf16x3")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    record_property("split_twin_max_abs_err", err)
    assert err <= SPLIT_TOL * scale, err
    assert float((got[0] - want[0]).abs().max()) > 0  # the products differ
    assert torch.equal(got[1], want[1])


SPLIT_VALUES = {
    "randn": np.random.default_rng(0).standard_normal(4096) * 10.0,
    "large": [3.4028235e38, -3.4028235e38, 1e38, -2.5e37, 65504.0, 1e30],
    "zeros": [0.0, -0.0],
    "small_normals": [1.1754944e-38, -2.0 ** -110, 2.0 ** -100 * 1.2345,
                      1e-37, -3e-35],
    "denormals": [1e-40, -3e-42, 1.4e-45, -5.877472e-39, 2.0 ** -133,
                  2.0 ** -140],
}


@pytest.mark.parametrize("family", list(SPLIT_VALUES))
def test_split_parts_recombine(family):
    """`split_bf16x3`: every part is exact in bf16, |x1| <= 2^-7 |x| and
    |x2| <= 2^-15 |x|; the parts sum to x exactly when x's lowest set bit
    is at or above 2^-133 (bf16's denormal step: every normal x down to
    2^-110 and the large ones up to the f32 maximum, which truncation
    never rounds past), and within 2^-133 otherwise (no sum of bf16 values
    lands between its steps), so within 2^-24 |x| for |x| >= 2^-109.
    Zeros keep their sign."""
    x = torch.tensor(SPLIT_VALUES[family], dtype=torch.float32)
    parts = sla_fwd.split_bf16x3(x)
    assert len(parts) == sla_fwd.SPLIT_PARTS
    for part in parts:
        assert torch.isfinite(part).all()
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    xd = x.double()
    assert torch.all(parts[1].double().abs() <= 2.0 ** -7 * xd.abs())
    assert torch.all(parts[2].double().abs() <= 2.0 ** -15 * xd.abs())
    err = (sum(part.double() for part in parts) - xd).abs()
    on_grid = torch.remainder(xd, 2.0 ** -133) == 0
    assert torch.all(err[on_grid] == 0)
    assert torch.all(err < 2.0 ** -133)
    big = xd.abs() >= 2.0 ** -109
    assert torch.all(err[big] <= 2.0 ** -24 * xd.abs()[big])
    if family == "zeros":
        assert torch.equal(torch.signbit(parts[0]), torch.signbit(x))


def test_split_kv_planes_twin_pads_and_recombines():
    """The pre-pass's twin: (3, BH_kv, N, 128) bf16 planes whose columns
    past D are zero and whose sum is k (v) exactly; the CPU call counts no
    launch."""
    rs = np.random.default_rng(4)
    k, v = (torch.from_numpy(rs.standard_normal((3, 128, 108),
                                                dtype=np.float32))
            for _ in range(2))
    before = sla_fwd.PLANES_LAUNCHES
    k3, v3 = sla_fwd.split_kv_planes(k, v)
    assert sla_fwd.PLANES_LAUNCHES == before
    for x, x3 in ((k, k3), (v, v3)):
        assert x3.shape == (3, 3, 128, sla_fwd.TC_HEAD_DIM)
        assert x3.dtype == torch.bfloat16
        assert float(x3[..., 108:].abs().max()) == 0
        assert torch.equal(x3.double().sum(0)[..., :108], x.double())


@pytest.mark.parametrize("dtype,block_q,block_kv,d,route", [
    (torch.float32, 64, 64, 128, "split"),
    (torch.float32, 64, 64, 108, "split"),
    (torch.float32, 64, 64, 32, "split"),
    (torch.float32, 32, 32, 128, "fma"),
    (torch.float32, 16, 16, 108, "fma"),
    (torch.float32, 64, 32, 128, "fma"),
    (torch.float32, 64, 64, 132, "fma"),
    (torch.bfloat16, 64, 64, 128, "tc"),
    (torch.bfloat16, 64, 64, 108, "tc"),
    (torch.bfloat16, 32, 32, 128, "tc32"),
    (torch.bfloat16, 64, 64, 132, "fma"),
    (torch.bfloat16, 32, 32, 48, "tc32"),
    (torch.bfloat16, 32, 32, 64, "tc32"),
    (torch.bfloat16, 32, 32, 108, "tc32"),
    (torch.bfloat16, 32, 32, 132, "fma"),
    (torch.float32, 32, 32, 64, "fma"),
])
def test_forward_route_rule(dtype, block_q, block_kv, d, route):
    """The forward's four routes; the split rule is the forward's alone,
    so the backward's (shared) tensor-core rule still sends f32 to its
    f32-FMA kernels; bf16 at 32 x 32 blocks and D <= 128 takes "tc32",
    the backward's 32 x 32 rule too."""
    assert sla_fwd.forward_route(dtype, block_q, block_kv, d) == route
    assert sla_fwd.use_split(dtype, block_q, block_kv, d) is (
        route == "split")
    assert sla_bwd.use_tensor_cores(dtype, block_q, block_kv, d) is (
        route == "tc")
    assert sla_bwd.use_tensor_cores_32(dtype, block_q, block_kv, d) is (
        route == "tc32")


def test_cpu_tensors_at_the_split_shape_run_the_f32_twin():
    """A CPU call at the split route's shape (f32, 64 x 64 blocks, D 108)
    runs the f32 twin, not the split twin, and counts no launch of any
    route or of the pre-pass."""
    ops, _ = _case(2, 108, 1, False, 0, "f32", n=256)
    args = _torch_args(ops, "f32")
    h, n = args[2].shape[:2]
    tm = n // 64
    lut = torch.stack([torch.arange(tm, dtype=torch.int32)] * h)
    call = [lut[..., None], torch.ones_like(lut), *args[2:6],
            torch.zeros((h, tm, 108, 108)), torch.ones((h, tm, 108))]
    kw = dict(scale=108 ** -0.5, causal=False, block_q=64, block_kv=64)
    assert sla_fwd.forward_route(args[2].dtype, 64, 64, 108) == "split"
    counters = ("LAUNCHES", "TC_LAUNCHES", "SPLIT_LAUNCHES",
                "PLANES_LAUNCHES")
    before = [getattr(sla_fwd, c) for c in counters]
    got = sla_fwd.sla_fwd(*call, **kw)
    assert [getattr(sla_fwd, c) for c in counters] == before
    want = sla_fwd.sla_fwd_plain(*call, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    split = sla_fwd.sla_fwd_plain(*call, **kw, mma_dtype="bf16x3")
    assert not torch.equal(got[0], split[0])


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "split"),
                                         (torch.float32, "tc"),
                                         (torch.float32, "dense"),
                                         (torch.float32, "tc32"),
                                         (torch.bfloat16, "tc32")])
def test_forced_route_must_take_the_call(dtype, route):
    """`_launch` forces a route only where that route's kernel takes the
    call (the f32-FMA kernel takes every one): the rest are refused before
    any build or launch."""
    ops, _ = _case(2, 32, 1, False, 0, "f32", n=256)
    args = _torch_args(ops, "f32")
    for i in (2, 3, 4):
        args[i] = args[i].to(dtype)
    h, n = args[2].shape[:2]
    tm = n // 64
    lut = torch.stack([torch.arange(tm, dtype=torch.int32)] * h)
    call = [lut[..., None], torch.ones_like(lut), *args[2:6],
            torch.zeros((h, tm, 32, 32)), torch.ones((h, tm, 32))]
    with pytest.raises(ValueError, match="does not take"):
        sla_fwd._launch(*call, scale=1.0, causal=False, block_q=64,
                        block_kv=64, base=0, route=route)


def test_twin_refuses_unknown_mma_dtype():
    args = _valid_args()
    with pytest.raises(ValueError, match="mma_dtype"):
        sla_fwd.sla_fwd_plain(*args, scale=1.0, causal=False, block_q=BLOCK,
                              block_kv=BLOCK, mma_dtype=torch.float16)


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_op_matches_dense_oracle(causal):
    """ops.sla_attention_core (h/z, aggregation, kernel twin) against the
    dense oracle of kernels/ref.py on the same plan."""
    cfg = SLAConfig(block_q=BLOCK, block_kv=BLOCK, kh_frac=0.25,
                    kl_frac=0.25, causal=causal)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 2, 128, 32), generator=gen) for _ in range(3))
    plan = plan_attention(q, k, cfg)
    qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)
    got = ops.sla_attention_core(q, k, v, qp, kp, plan, cfg)
    want = ref.sla_attention_core_reference(q, k, v, qp, kp, plan.mc, cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL["f32"], rtol=TOL["f32"])
    # a raw M_c works as the plan argument too
    again = ops.sla_attention_core(q, k, v, qp, kp, plan.mc, cfg)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _valid_args(d=32):
    ops, _ = _case(0, d, 1, False, 0, "f32")
    return _torch_args(ops, "f32")


@pytest.mark.parametrize("change,match", [
    (lambda a: a.__setitem__(2, a[2].to(torch.float16)), "float32 or"),
    (lambda a: a.__setitem__(3, a[3].to(torch.bfloat16)), "share one"),
    (lambda a: a.__setitem__(5, a[5].to(torch.bfloat16)), "qp must"),
    (lambda a: a.__setitem__(0, a[0].long()), "lut must"),
    (lambda a: a.__setitem__(2, a[2].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "contiguous"),
    (lambda a: a.__setitem__(0, a[0][:, :4]), "lut must be"),
])
def test_kernel_wrapper_checks_its_operands(change, match):
    args = _valid_args()
    change(args)
    with pytest.raises((TypeError, ValueError), match=match):
        sla_fwd._check(*args, BLOCK, BLOCK)


def test_kernel_wrapper_rejects_unsupported_head_dims_and_blocks():
    for d in (130, 30):
        with pytest.raises(ValueError, match="head dims"):
            sla_fwd._check(*_valid_args(d), BLOCK, BLOCK)
    with pytest.raises(ValueError, match="blocks of"):
        sla_fwd._check(*_valid_args(), 128, 128)
    sla_fwd._check(*_valid_args(108), BLOCK, BLOCK)  # 108 is taken


def test_kernel_wrapper_refuses_other_devices():
    args = [a.to("meta") for a in _valid_args()]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sla_fwd.sla_fwd(*args, scale=1.0, causal=False, block_q=BLOCK,
                        block_kv=BLOCK)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A failed build raises; with no toolkit the error names nvcc."""
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has nvcc; the build itself is exercised by "
                    "tests/test_torch_gpu.py and chip_smoke.py")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("sla_fwd")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.kernel_names() == ["sla_bwd", "sla_bwd_tc", "sla_bwd_tc32",
                                     "sla_decode", "sla_fwd", "sla_fwd_split",
                                     "sla_fwd_tc", "sla_fwd_tc32"]


def test_library_path_hashes_the_shared_headers(monkeypatch, tmp_path):
    """A library's name hashes every csrc/*.cuh with its source, so an
    edited header (which no source's text shows) is rebuilt, never loaded
    stale."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first  # a pure function of the text
    assert _build.kernel_names() == ["k"]
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert _build.library_path("k") not in (first, second)
    (tmp_path / "g.cuh").unlink()
    assert _build.library_path("k") == second
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("k") != second
