"""The backward kernels' plain twins against the Pallas kernels.

`repro_torch.kernels.sla_bwd.sla_bwd_dq_plain` / `sla_bwd_dkv_plain` are
held to `repro.kernels.sla_bwd.sla_bwd_dq` / `sla_bwd_dkv(interpret=True)`
on the same numpy inputs (the row and column LUTs of one JAX plan, L and
O^s from the forward twin), over bidirectional / causal, GQA group 1 / 2,
head dims 16 / 108 and f32 / bf16 inputs. Both sides compute in f32 from
the same (bf16-rounded) values, so both dtypes are held to
5e-5 x max(1, max |reference|). The twins' `mma_dtype=torch.bfloat16`
form, which rounds dO, P and dS where the tensor-core kernels do, is held
to the Pallas kernels within the repo's bf16 conformance limit, 5e-2 x
max(1, max |reference|); the route rule and the head-dim padding of that
route are checked here too. At 32 x 32 blocks and D 64, the shape of the
"tc32" route (the paper's fine-tune), the f32 and the rounded twins are
held to the Pallas kernels alike, and that route's operands (dO cast,
padding to 64 or 128) are checked.

The CUDA kernels themselves run only on a GPU: their tests are in
tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import plan as jplan
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.kernels.sla_bwd import sla_bwd_dkv as jax_dkv
from repro.kernels.sla_bwd import sla_bwd_dq as jax_dq
from repro_torch.kernels import sla_bwd, sla_fwd

TOL = 5e-5
BF16_TOL = 5e-2  # tests/test_conformance.py's bf16 limit
BLOCK = 16


def _case(seed, d, group, causal, dtype, h=4, n=128, block=BLOCK):
    """Numpy operands for one backward call: q, k, v (rounded to bf16
    for the bf16 cases), a random dO^s, the forward's L and
    D = rowsum(dO^s * O^s), and the plan's row and column LUTs."""
    rs = np.random.default_rng(seed)
    hkv = h // group
    q = rs.standard_normal((h, n, d), dtype=np.float32)
    k = rs.standard_normal((hkv, n, d), dtype=np.float32)
    v = rs.standard_normal((hkv, n, d), dtype=np.float32)
    if dtype == "bf16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    cfg = JaxSLAConfig(block_q=block, block_kv=block, kh_frac=0.5,
                       kl_frac=0.25, causal=causal)
    plan = jplan.plan_attention(jnp.asarray(q[None]), jnp.asarray(k[None]),
                                cfg)
    luts = {name: np.asarray(getattr(plan, name)[0]).astype(np.int32)
            for name in ("lut", "counts", "col_lut", "col_counts")}
    tm = n // block
    zeros_h = torch.zeros((h, tm, d, d))
    zeros_z = torch.zeros((h, tm, d))
    t = {name: torch.from_numpy(a) for name, a in
         dict(q=q, k=k, v=v, **luts).items()}
    o_s, _, lse = sla_fwd.sla_fwd_plain(
        t["lut"], t["counts"], t["q"], t["k"], t["v"], torch.zeros_like(
            t["q"]), zeros_h, zeros_z, scale=d ** -0.5, causal=causal,
        block_q=block, block_kv=block)
    do = rs.standard_normal((h, n, d), dtype=np.float32)
    d_s = (torch.from_numpy(do) * o_s).sum(-1).numpy()
    return dict(q=q, k=k, v=v, do=do, lse=lse.numpy(), d_s=d_s, **luts)


def _torch(c, dtype, lut, counts):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return [t(c[lut]), t(c[counts]), *(t(c[n]).to(td) for n in "qkv"),
            t(c["do"]), t(c["lse"]), t(c["d_s"])]


def _jax(c, dtype, lut, counts):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return [jnp.asarray(c[lut]), jnp.asarray(c[counts]),
            *(jnp.asarray(c[n], jd) for n in "qkv"), jnp.asarray(c["do"]),
            jnp.asarray(c["lse"]), jnp.asarray(c["d_s"])]


def _close(got, want, name, tol=TOL):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape, name
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0,
                               err_msg=name)


CASES = [
    pytest.param(d, group, causal, dtype,
                 id=f"d{d}-g{group}-{'causal' if causal else 'bidir'}"
                    f"-{dtype}")
    for d in (16, 108)
    for group in (1, 2)
    for causal in (False, True)
    for dtype in ("f32", "bf16")
]


@pytest.mark.parametrize("d,group,causal,dtype", CASES)
def test_plain_twins_match_pallas_kernels(d, group, causal, dtype):
    c = _case(d + 3 * group + int(causal), d, group, causal, dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=BLOCK,
              block_kv=BLOCK)
    before = (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV)
    dq = sla_bwd.sla_bwd_dq(*_torch(c, dtype, "lut", "counts"), **kw)
    dk, dv = sla_bwd.sla_bwd_dkv(*_torch(c, dtype, "col_lut",
                                         "col_counts"), **kw)
    # CPU tensors: the plain twins, no kernel launch counted
    assert (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV) == before
    _close(dq, jax_dq(*_jax(c, dtype, "lut", "counts"), **kw), "dq")
    jdk, jdv = jax_dkv(*_jax(c, dtype, "col_lut", "col_counts"), **kw)
    _close(dk, jdk, "dk")
    _close(dv, jdv, "dv")
    assert float(dq.abs().max()) > 0 and float(dk.abs().max()) > 0


@pytest.mark.parametrize("d,group,causal,dtype", [
    c for c in CASES if c.values[3] == "bf16"])
def test_rounded_twins_match_pallas_kernels(d, group, causal, dtype):
    """The twins with dO, P and dS rounded to bf16 (the tensor-core
    route's arithmetic) stay within bf16 conformance of the Pallas
    kernels, and the rounding changes the result."""
    c = _case(d + 3 * group + int(causal), d, group, causal, dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=BLOCK,
              block_kv=BLOCK)
    dq_args = _torch(c, dtype, "lut", "counts")
    dkv_args = _torch(c, dtype, "col_lut", "col_counts")
    dq = sla_bwd.sla_bwd_dq_plain(*dq_args, **kw, mma_dtype=torch.bfloat16)
    dk, dv = sla_bwd.sla_bwd_dkv_plain(*dkv_args, **kw,
                                       mma_dtype=torch.bfloat16)
    _close(dq, jax_dq(*_jax(c, dtype, "lut", "counts"), **kw), "dq",
           BF16_TOL)
    jdk, jdv = jax_dkv(*_jax(c, dtype, "col_lut", "col_counts"), **kw)
    _close(dk, jdk, "dk", BF16_TOL)
    _close(dv, jdv, "dv", BF16_TOL)
    assert not torch.equal(dq, sla_bwd.sla_bwd_dq_plain(*dq_args, **kw))


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_rounding_keyword_defaults_to_the_f32_twin(kernel):
    """`mma_dtype=None` is today's f32 twin, bitwise."""
    c = _case(1, 16, 2, True, "bf16")
    names = ("lut", "counts") if kernel == "dq" else ("col_lut",
                                                      "col_counts")
    plain = (sla_bwd.sla_bwd_dq_plain if kernel == "dq"
             else sla_bwd.sla_bwd_dkv_plain)
    args = _torch(c, "bf16", *names)
    kw = dict(scale=0.25, causal=True, block_q=BLOCK, block_kv=BLOCK)
    got = plain(*args, **kw, mma_dtype=None)
    want = plain(*args, **kw)
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mma_dtype", [None, torch.bfloat16],
                         ids=["f32", "rounded"])
def test_head_dim_padding_leaves_the_gradients_unchanged(mma_dtype):
    """The tensor-core route zero-pads q, k, v and dO from 108 to the
    kernel's width: zero columns change neither S nor dP, so the twin on
    the padded operands, sliced back, is the unpadded twin."""
    c = _case(5, 108, 2, False, "bf16")
    kw = dict(scale=108 ** -0.5, causal=False, block_q=BLOCK,
              block_kv=BLOCK, mma_dtype=mma_dtype)
    for names, plain in ((("lut", "counts"), sla_bwd.sla_bwd_dq_plain),
                         (("col_lut", "col_counts"),
                          sla_bwd.sla_bwd_dkv_plain)):
        args = _torch(c, "bf16", *names)
        padded = args[:2] + [sla_bwd.pad_head_dim(x) for x in args[2:6]] \
            + args[6:]
        assert padded[2].shape[-1] == sla_bwd.TC_HEAD_DIM
        assert torch.all(padded[3][..., 108:] == 0)
        want = plain(*args, **kw)
        got = plain(*padded, **kw)
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        for g, w in zip(got, want):
            assert float(g[..., 108:].abs().max()) == 0
            torch.testing.assert_close(g[..., :108], w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,block_q,block_kv,d,tc", [
    (torch.bfloat16, 64, 64, 128, True),
    (torch.bfloat16, 64, 64, 108, True),
    (torch.bfloat16, 64, 64, 32, True),
    (torch.float32, 64, 64, 128, False),
    (torch.bfloat16, 32, 32, 128, False),
    (torch.bfloat16, 16, 16, 108, False),
    (torch.bfloat16, 64, 32, 128, False),
    (torch.bfloat16, 64, 64, 132, False),
])
def test_tensor_core_route_rule(dtype, block_q, block_kv, d, tc):
    """bf16 at 64 x 64 blocks and head dims up to 128 take the
    tensor-core kernels; everything else the f32-FMA kernels."""
    assert sla_bwd.use_tensor_cores(dtype, block_q, block_kv, d) is tc


TC32_CASES = [
    pytest.param(group, causal,
                 id=f"g{group}-{'causal' if causal else 'bidir'}")
    for group in (1, 2)
    for causal in (False, True)
]


def _tc32_case(group, causal):
    """Operands at the "tc32" route's shape: bf16 inputs at 32 x 32
    blocks, D 64, n 256."""
    c = _case(40 + 3 * group + int(causal), 64, group, causal, "bf16",
              n=256, block=sla_bwd.TC32_BLOCK)
    kw = dict(scale=64 ** -0.5, causal=causal, block_q=sla_bwd.TC32_BLOCK,
              block_kv=sla_bwd.TC32_BLOCK)
    assert sla_bwd.backward_route(torch.bfloat16, 32, 32, 64) == "tc32"
    return c, kw


@pytest.mark.parametrize("group,causal", TC32_CASES)
def test_rounded_twins_match_pallas_kernels_at_32x32_blocks(group, causal):
    """At the "tc32" route's shape the twins that round dO, P and dS to
    bf16 (that route's arithmetic) stay within bf16 conformance of the
    Pallas kernels, and the rounding changes the result."""
    c, kw = _tc32_case(group, causal)
    dq_args = _torch(c, "bf16", "lut", "counts")
    dkv_args = _torch(c, "bf16", "col_lut", "col_counts")
    dq = sla_bwd.sla_bwd_dq_plain(*dq_args, **kw, mma_dtype=torch.bfloat16)
    dk, dv = sla_bwd.sla_bwd_dkv_plain(*dkv_args, **kw,
                                       mma_dtype=torch.bfloat16)
    _close(dq, jax_dq(*_jax(c, "bf16", "lut", "counts"), **kw), "dq",
           BF16_TOL)
    jdk, jdv = jax_dkv(*_jax(c, "bf16", "col_lut", "col_counts"), **kw)
    _close(dk, jdk, "dk", BF16_TOL)
    _close(dv, jdv, "dv", BF16_TOL)
    assert not torch.equal(dq, sla_bwd.sla_bwd_dq_plain(*dq_args, **kw))
    assert float(dq.abs().max()) > 0 and float(dk.abs().max()) > 0


@pytest.mark.parametrize("group,causal", TC32_CASES)
def test_f32_twins_match_pallas_kernels_at_32x32_blocks(group, causal):
    """At the "tc32" route's shape the f32 twins (the yardstick
    `cases.tc_criterion` measures that route from) match the Pallas
    kernels within 5e-5, through the wrappers on CPU tensors, with no
    launch of any route counted."""
    c, kw = _tc32_case(group, causal)
    before = (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
              sla_bwd.TC32_LAUNCHES_DQ, sla_bwd.TC32_LAUNCHES_DKV)
    dq = sla_bwd.sla_bwd_dq(*_torch(c, "bf16", "lut", "counts"), **kw)
    dk, dv = sla_bwd.sla_bwd_dkv(*_torch(c, "bf16", "col_lut",
                                         "col_counts"), **kw)
    assert (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
            sla_bwd.TC32_LAUNCHES_DQ, sla_bwd.TC32_LAUNCHES_DKV) == before
    _close(dq, jax_dq(*_jax(c, "bf16", "lut", "counts"), **kw), "dq")
    jdk, jdv = jax_dkv(*_jax(c, "bf16", "col_lut", "col_counts"), **kw)
    _close(dk, jdk, "dk")
    _close(dv, jdv, "dv")


@pytest.mark.parametrize("dtype,block_q,block_kv,d,route", [
    (torch.bfloat16, 64, 64, 128, "tc"),
    (torch.bfloat16, 64, 64, 108, "tc"),
    (torch.bfloat16, 64, 64, 64, "tc"),
    (torch.bfloat16, 32, 32, 64, "tc32"),
    (torch.bfloat16, 32, 32, 128, "tc32"),
    (torch.bfloat16, 32, 32, 48, "tc32"),
    (torch.bfloat16, 32, 32, 108, "tc32"),
    (torch.bfloat16, 32, 32, 132, "fma"),
    (torch.bfloat16, 32, 32, 256, "fma"),
    (torch.float32, 32, 32, 64, "fma"),
    (torch.float32, 64, 64, 128, "fma"),
    (torch.bfloat16, 32, 64, 64, "fma"),
    (torch.bfloat16, 64, 32, 64, "fma"),
    (torch.bfloat16, 16, 16, 64, "fma"),
    (torch.bfloat16, 64, 64, 256, "fma"),
])
def test_backward_route_rule(dtype, block_q, block_kv, d, route):
    """bf16 at 64 x 64 blocks takes the "tc" kernels (the forward's
    tensor-core rule), bf16 at 32 x 32 blocks the "tc32" kernels, both up
    to D 128; everything else the f32-FMA kernels. At 32 x 32 blocks the
    forward takes its own "tc32" kernel by the same rule."""
    assert sla_bwd.backward_route(dtype, block_q, block_kv, d) == route
    assert sla_bwd.use_tensor_cores(dtype, block_q, block_kv, d) is (
        route == "tc")
    if route == "tc32":
        assert not sla_fwd.use_tensor_cores(dtype, block_q, block_kv, d)
        assert sla_fwd.forward_route(dtype, block_q, block_kv, d) == "tc32"


@pytest.mark.parametrize("d,width", [(48, 64), (64, 64), (108, 128),
                                     (128, 128)])
def test_tc32_operands_are_cast_padded_and_aligned(d, width):
    """What the "tc32" kernels read: bf16 q, k, v and dO zero-padded to
    the next of 64 and 128 (q itself where it is that wide); a misaligned
    lse or d_s is refused."""
    assert sla_bwd.tc32_head_dim(d) == width
    c = _case(6, d, 2, False, "bf16")
    q, k, v, do, lse, d_s = _torch(c, "bf16", "lut", "counts")[2:]
    xs = sla_bwd._tc_operands("sla_bwd_dq", q, k, v, do, lse, d_s, width)
    for x, src in zip(xs, (q, k, v, do)):
        assert x.dtype == torch.bfloat16 and x.is_contiguous()
        assert x.shape == (*src.shape[:-1], width)
        assert torch.equal(x[..., :d], src.to(torch.bfloat16))
        assert d == width or float(x[..., d:].abs().max()) == 0
    assert (xs[0] is q) is (d == width)
    assert xs[3].dtype == torch.bfloat16 and do.dtype == torch.float32

    def shifted(x):
        return x.reshape(-1)[1:1 + x.numel() - 64].reshape(x.shape[0], -1)

    with pytest.raises(ValueError, match="16-byte aligned"):
        sla_bwd._tc_operands("sla_bwd_dq", q, k, v, do, shifted(lse), d_s,
                             width)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sla_bwd._tc_operands("sla_bwd_dkv", q, k, v, do, lse, shifted(d_s),
                             width)


def test_cpu_tensors_on_the_tc32_shape_run_the_f32_twin():
    """A CPU call at the "tc32" route's shape runs the f32 twin (no
    rounding) and counts no launch of any route."""
    c, kw = _tc32_case(2, True)
    dq_args = _torch(c, "bf16", "lut", "counts")
    dkv_args = _torch(c, "bf16", "col_lut", "col_counts")
    before = (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
              sla_bwd.TC_LAUNCHES_DQ, sla_bwd.TC_LAUNCHES_DKV,
              sla_bwd.TC32_LAUNCHES_DQ, sla_bwd.TC32_LAUNCHES_DKV)
    got = sla_bwd.sla_bwd_dq(*dq_args, **kw)
    got_kv = sla_bwd.sla_bwd_dkv(*dkv_args, **kw)
    assert (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
            sla_bwd.TC_LAUNCHES_DQ, sla_bwd.TC_LAUNCHES_DKV,
            sla_bwd.TC32_LAUNCHES_DQ, sla_bwd.TC32_LAUNCHES_DKV) == before
    assert torch.equal(got, sla_bwd.sla_bwd_dq_plain(*dq_args, **kw))
    assert all(torch.equal(g, w) for g, w in
               zip(got_kv, sla_bwd.sla_bwd_dkv_plain(*dkv_args, **kw)))
    assert not torch.equal(got, sla_bwd.sla_bwd_dq_plain(
        *dq_args, **kw, mma_dtype=torch.bfloat16))


def test_tensor_core_operands_are_cast_padded_and_aligned():
    """What the tensor-core kernels read: bf16 q, k, v and dO padded to
    `TC_HEAD_DIM` with zeros; a misaligned lse is refused."""
    c = _case(4, 108, 2, False, "bf16")
    q, k, v, do, lse, d_s = _torch(c, "bf16", "lut", "counts")[2:]
    xs = sla_bwd._tc_operands("sla_bwd_dq", q, k, v, do, lse, d_s)
    for x, src in zip(xs, (q, k, v, do)):
        assert x.dtype == torch.bfloat16 and x.is_contiguous()
        assert x.shape == (*src.shape[:-1], sla_bwd.TC_HEAD_DIM)
        assert torch.equal(x[..., :108], src.to(torch.bfloat16))
        assert float(x[..., 108:].abs().max()) == 0
    shifted = lse.reshape(-1)[1:1 + lse.numel() - 64].reshape(
        lse.shape[0], -1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sla_bwd._tc_operands("sla_bwd_dq", q, k, v, do, shifted, d_s)


def test_cpu_tensors_on_the_tensor_core_shape_run_the_f32_twin():
    """A CPU call at the tensor-core route's shape runs the f32 twin (no
    rounding) and counts no launch of either route."""
    c = _case(2, 108, 1, False, "bf16")
    args = _torch(c, "bf16", "lut", "counts")
    h, n = args[2].shape[:2]
    lut = torch.stack([torch.arange(n // 64, dtype=torch.int32)] * h)
    call = [lut[..., None], torch.ones_like(lut)] + args[2:]
    kw = dict(scale=108 ** -0.5, causal=False, block_q=64, block_kv=64)
    assert sla_bwd.use_tensor_cores(args[2].dtype, 64, 64, 108)
    before = (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
              sla_bwd.TC_LAUNCHES_DQ, sla_bwd.TC_LAUNCHES_DKV)
    got = sla_bwd.sla_bwd_dq(*call, **kw)
    got_kv = sla_bwd.sla_bwd_dkv(*call, **kw)
    assert (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
            sla_bwd.TC_LAUNCHES_DQ, sla_bwd.TC_LAUNCHES_DKV) == before
    assert torch.equal(got, sla_bwd.sla_bwd_dq_plain(*call, **kw))
    assert all(torch.equal(g, w) for g, w in
               zip(got_kv, sla_bwd.sla_bwd_dkv_plain(*call, **kw)))
    assert not torch.equal(got, sla_bwd.sla_bwd_dq_plain(
        *call, **kw, mma_dtype=torch.bfloat16))


def test_dead_rows_and_columns_get_zero_gradient():
    """A query row with no live LUT entry gets dQ = 0 and a kv column
    with none gets dK = dV = 0, whatever its padded slots name; the other
    rows and columns are unchanged."""
    c = _case(0, 16, 1, False, "f32")
    kw = dict(scale=0.25, causal=False, block_q=BLOCK, block_kv=BLOCK)
    dq0 = sla_bwd.sla_bwd_dq_plain(*_torch(c, "f32", "lut", "counts"),
                                   **kw)
    dk0, _ = sla_bwd.sla_bwd_dkv_plain(
        *_torch(c, "f32", "col_lut", "col_counts"), **kw)
    c["counts"][0, 2] = 0
    c["col_counts"][1, 3] = 0
    c["lut"][0, 2] = 5  # padded slots name another (valid) block
    c["col_lut"][1, 3] = 5
    dq = sla_bwd.sla_bwd_dq_plain(*_torch(c, "f32", "lut", "counts"), **kw)
    dk, dv = sla_bwd.sla_bwd_dkv_plain(
        *_torch(c, "f32", "col_lut", "col_counts"), **kw)
    rows = slice(2 * BLOCK, 3 * BLOCK)
    cols = slice(3 * BLOCK, 4 * BLOCK)
    assert torch.all(dq[0, rows] == 0) and torch.all(dq0[0, rows] != 0)
    assert torch.all(dk[1, cols] == 0) and torch.all(dv[1, cols] == 0)
    assert torch.equal(dq[:, :2 * BLOCK], dq0[:, :2 * BLOCK])
    assert torch.equal(dk[0], dk0[0])


def _valid(kernel="dq"):
    c = _case(0, 16, 1, False, "f32")
    names = ("lut", "counts") if kernel == "dq" else ("col_lut",
                                                      "col_counts")
    return _torch(c, "f32", *names)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("change,match", [
    (lambda a: a.__setitem__(2, a[2].to(torch.float16)), "float32 or"),
    (lambda a: a.__setitem__(3, a[3].to(torch.bfloat16)), "share one"),
    (lambda a: a.__setitem__(5, a[5].to(torch.bfloat16)), "do_s must"),
    (lambda a: a.__setitem__(6, a[6][:, :8].contiguous()), "lse and"),
    (lambda a: a.__setitem__(0, a[0].long()), "lut must"),
    (lambda a: a.__setitem__(1, a[1][:, :2].contiguous()), "counts must"),
    (lambda a: a.__setitem__(2, a[2].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "contiguous"),
    (lambda a: a.__setitem__(0, a[0][:3]), "lut must be"),
])
def test_wrappers_check_their_operands(kernel, change, match):
    args = _valid(kernel)
    change(args)
    with pytest.raises((TypeError, ValueError), match=match):
        sla_bwd._check(f"sla_bwd_{kernel}", *args, BLOCK, BLOCK, BLOCK)


def test_wrappers_refuse_other_devices():
    for kernel, fn in (("dq", sla_bwd.sla_bwd_dq),
                       ("dkv", sla_bwd.sla_bwd_dkv)):
        args = [a.to("meta") for a in _valid(kernel)]
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn(*args, scale=1.0, causal=False, block_q=BLOCK,
               block_kv=BLOCK)
