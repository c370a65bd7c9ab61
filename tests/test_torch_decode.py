"""The decode kernel's function and the decode backends, port against JAX.

`repro_torch.kernels.sla_decode.decode_attention` on CPU tensors (the CUDA
kernel's plain twin) is held to `repro.kernels.sla_decode.decode_attention`
(the Pallas kernel in interpret mode) on the same numpy decode state: the
C = 1 live-row layout and the C = 4 per-token layout, GQA group 2, f32 and
bf16 K/V, rows with marg = 0, and padded LUT slots that point at another
block. Forward tolerance 5e-5 (f32 K/V) and 5e-2 (bf16 K/V), relative to
max(1, max |reference|); the gradients of the autograd wrapper against the
reference's custom_vjp within 1e-5 of the same scale. Then
`decode_execute` of each decode backend (gather / reference / kernel)
against the JAX backend of the same name, within 5e-5. The kernel's
split-and-combine, as its plain twin computes it (`split_width`), is held
to the reference's `_fused_decode` (interpret mode) at the same
tolerances, over split widths, NaN-poisoned padded slots and both
layouts; and the wrapper's split chooser covers every live slot once.

The CUDA kernel itself runs only on a GPU: tests/test_torch_gpu.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import backends as jbackends
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.kernels import sla_decode as jdecode
from repro_torch.core import backends as tbackends
from repro_torch.core.config import SLAConfig
from repro_torch.kernels import sla_decode

B, HKV, G, D, BKV, TN, K = 2, 2, 2, 32, 16, 8, 3
H = HKV * G
TOL = {"f32": 5e-5, "bf16": 5e-2}
GRAD_TOL = 1e-5
FLOATS = ("k", "v", "hblk", "zblk", "htot", "ztot", "hdiag", "zdiag")


def _cfgs():
    kw = dict(block_q=BKV, block_kv=BKV, kh_frac=0.25, kl_frac=0.0,
              causal=True, decode_mode="sla")
    return JaxSLAConfig(**kw), SLAConfig(**kw)


def _state(seed, c, kv_dtype, poison=True, tn=TN, k_sel=K, row=5,
           nan=False):
    """Numpy decode state at base position `pos` (mid-block, row `row` of
    `tn`): K/V, per-block h/z and their totals; a live LUT of distinct
    valid blocks with the diagonal first, cnt in [1, K] and padded slots
    pointing at another valid block (`poison`) or repeating the first;
    marg with zero rows. c > 1 adds the per-token layout: LUT rows and
    totals per token and the diagonal partials hdiag/zdiag. `nan`: the
    padded slots name blocks past the live one whose K, V, hblk and zblk
    are NaN (the totals sum the valid blocks)."""
    rs = np.random.default_rng(seed)
    K, TN = k_sel, tn  # noqa: N806 (this state's sizes)
    pos = row * BKV + 6
    smax = TN * BKV
    k = rs.standard_normal((B, HKV, smax, D), dtype=np.float32)
    v = rs.standard_normal((B, HKV, smax, D), dtype=np.float32)
    if kv_dtype == "bf16":
        k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                for x in (k, v))
    hblk = rs.random((B, HKV, TN, D, D), dtype=np.float32) * 0.2
    zblk = rs.random((B, HKV, TN, D), dtype=np.float32) + 0.1
    hblk[:, :, row + 1:] = 0.0  # blocks past the live one are empty
    zblk[:, :, row + 1:] = 0.0
    tok = (B, H, c) if c > 1 else (B, H)
    lut = np.zeros(tok + (K,), np.int32)
    cnt = rs.integers(1, K + 1, size=tok).astype(np.int32)
    for idx in np.ndindex(*tok):
        others = rs.permutation(row)[:K - 1]
        lut[idx] = np.concatenate([[row], others])
        if nan:
            lut[idx][cnt[idx]:] = rs.integers(row + 1, TN, K - cnt[idx])
        elif poison:
            lut[idx][cnt[idx]:] = rs.permutation(
                [j for j in range(row) if j not in lut[idx][:cnt[idx]]])[
                    :K - cnt[idx]]
        else:
            lut[idx][cnt[idx]:] = lut[idx][0]
    marg = rs.integers(0, 4, size=tok).astype(np.int32)
    marg.reshape(-1)[::3] = 0
    st = dict(k=k, v=v, hblk=hblk, zblk=zblk, lut=lut, cnt=cnt, marg=marg,
              htot=hblk.sum(axis=2), ztot=zblk.sum(axis=2))
    if c > 1:
        # per-token snapshots: totals grow token by token and the diagonal
        # block's partial is the at-time value
        grow = rs.random((B, HKV, c, D, D), dtype=np.float32) * 0.05
        growz = rs.random((B, HKV, c, D), dtype=np.float32) * 0.05
        st["hdiag"] = hblk[:, :, row][:, :, None] * 0.5 + np.cumsum(grow, 2)
        st["zdiag"] = zblk[:, :, row][:, :, None] * 0.5 + np.cumsum(growz, 2)
        st["htot"] = st["htot"][:, :, None] + np.cumsum(grow, 2)
        st["ztot"] = st["ztot"][:, :, None] + np.cumsum(growz, 2)
    if nan:
        for name in "kv":
            st[name][:, :, (row + 1) * BKV:] = np.nan
        for name in ("hblk", "zblk"):
            st[name][:, :, row + 1:] = np.nan
    qg = rs.standard_normal((B, HKV, G, c, D), dtype=np.float32)
    qpg = rs.random((B, HKV, G, c, D), dtype=np.float32)
    qpg /= qpg.sum(-1, keepdims=True)
    return st, qg, qpg, pos


def _jax_state(st, kv_dtype):
    out = {n: jnp.asarray(a) for n, a in st.items()}
    if kv_dtype == "bf16":
        out["k"], out["v"] = (out[n].astype(jnp.bfloat16) for n in "kv")
    return out


def _torch_state(st, kv_dtype):
    out = {n: torch.from_numpy(np.ascontiguousarray(a))
           for n, a in st.items()}
    if kv_dtype == "bf16":
        out["k"], out["v"] = (out[n].to(torch.bfloat16) for n in "kv")
    return out


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("poison", [True, False])
def test_decode_attention_matches_pallas_kernel(kv_dtype, c, poison):
    jcfg, tcfg = _cfgs()
    st, qg, qpg, pos = _state(7 + c, c, kv_dtype, poison)
    want = jdecode.decode_attention(_jax_state(st, kv_dtype),
                                    jnp.asarray(qg), jnp.asarray(qpg), pos,
                                    jcfg, None, interpret=True)
    got = sla_decode.decode_attention(_torch_state(st, kv_dtype),
                                      torch.from_numpy(qg),
                                      torch.from_numpy(qpg), pos, tcfg)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        limit = TOL[kv_dtype] * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= limit
    # the marg = 0 rows give exact zeros on both sides
    marg = st["marg"] if c > 1 else np.broadcast_to(
        st["marg"][..., None], (B, H, c))
    dead = marg.reshape(B, HKV, G, c) == 0
    assert dead.any()
    assert float(np.abs(got[1].numpy()[dead]).max()) == 0.0


def test_decode_plain_twin_is_the_flat_kernel_function():
    """`sla_decode` on CPU tensors is the plain twin, and the twin on the
    flat layout equals the grouped `_decode_math` bitwise."""
    _, tcfg = _cfgs()
    st, qg, qpg, pos = _state(3, 4, "f32")
    t = _torch_state(st, "f32")
    q, qp = torch.from_numpy(qg), torch.from_numpy(qpg)
    posv = torch.full((B,), pos, dtype=torch.int32)
    args = sla_decode._flat_args(q, qp, t["k"], t["v"], t["hblk"],
                                 t["zblk"], t["hdiag"], t["zdiag"],
                                 t["htot"], t["ztot"],
                                 t["lut"].reshape(B, HKV, G, 4, K),
                                 t["cnt"].reshape(B, HKV, G, 4),
                                 t["marg"].reshape(B, HKV, G, 4), posv, BKV)
    kw = dict(scale=D ** -0.5, block_kv=BKV, group=G)
    before = sla_decode.LAUNCHES
    got = sla_decode.sla_decode(*args, **kw)
    assert sla_decode.LAUNCHES == before  # the twin is no launch
    want = sla_decode.sla_decode_plain(*args, **kw)
    math = sla_decode._decode_math(
        q, qp, t["k"], t["v"], t["hblk"], t["zblk"], t["hdiag"], t["zdiag"],
        t["htot"], t["ztot"], t["lut"].reshape(B, HKV, G, 4, K),
        t["cnt"].reshape(B, HKV, G, 4), t["marg"].reshape(B, HKV, G, 4),
        posv, tcfg, D ** -0.5)
    for g, w, m in zip(got, want, math):
        assert torch.equal(g, w)
        assert torch.equal(g.reshape(m.shape), m)


@pytest.mark.parametrize("c", [1, 4])
def test_decode_attention_gradients_match_custom_vjp(c):
    jcfg, tcfg = _cfgs()
    st, qg, qpg, pos = _state(11, c, "f32")
    names = ["k", "v", "hblk", "zblk", "htot", "ztot"] + (
        ["hdiag", "zdiag"] if c > 1 else [])
    rs = np.random.default_rng(2)
    w_s = rs.standard_normal(qg.shape, dtype=np.float32)
    w_l = rs.standard_normal(qg.shape, dtype=np.float32)

    def jloss(qq, qqp, *leaves):
        s = dict(_jax_state(st, "f32"), **dict(zip(names, leaves)))
        o_s, o_l = jdecode.decode_attention(s, qq, qqp, pos, jcfg, None,
                                            interpret=True)
        return jnp.sum(o_s * w_s) + jnp.sum(o_l * w_l)

    jargs = [jnp.asarray(qg), jnp.asarray(qpg)] + [
        jnp.asarray(st[n]) for n in names]
    want = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)

    targs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
             for a in [qg, qpg] + [st[n] for n in names]]
    ts = dict(_torch_state(st, "f32"), **dict(zip(names, targs[2:])))
    o_s, o_l = sla_decode.decode_attention(ts, targs[0], targs[1], pos, tcfg)
    loss = (o_s * torch.from_numpy(w_s)).sum() + \
        (o_l * torch.from_numpy(w_l)).sum()
    got = torch.autograd.grad(loss, targs)
    for name, g, w in zip(["q", "qp"] + names, got, want):
        w = np.asarray(w)
        limit = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= limit, (name, err, limit)
    assert float(got[2].abs().max()) > 0 and float(got[4].abs().max()) > 0


def test_decode_attention_rejects_paged_state():
    """Paged state (a page table `pt` over page pools) runs the paged
    kernel for single tokens (tests/test_torch_paged_decode.py) and is
    refused for a chunk of C > 1 tokens, as the reference refuses it."""
    _, tcfg = _cfgs()
    st, qg, qpg, pos = _state(1, 4, "f32")
    ts = _torch_state(st, "f32")
    pools = {n: ts[n].reshape(B * HKV, TN, *ts[n].shape[3:])
             for n in ("hblk", "zblk")}
    pools.update({n: ts[n].reshape(B * HKV, TN, BKV, D) for n in "kv"})
    pt = torch.arange(B * TN, dtype=torch.int32).reshape(B, TN)
    paged = dict(ts, pt=pt, **pools)
    with pytest.raises(ValueError, match="single-token"):
        sla_decode.decode_attention(paged, torch.from_numpy(qg),
                                    torch.from_numpy(qpg), pos, tcfg)


@pytest.mark.parametrize("backend", ["gather", "reference", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_decode_execute_matches_jax_backend(backend, kv_dtype):
    jcfg, tcfg = _cfgs()
    st, _, _, pos = _state(5, 1, kv_dtype, poison=False)
    rs = np.random.default_rng(6)
    q = rs.standard_normal((B, H, 1, D), dtype=np.float32)
    proj = rs.standard_normal((H, D, D), dtype=np.float32) * 0.1
    want = jbackends.decode_execute(_jax_state(st, kv_dtype),
                                    {"proj": jnp.asarray(proj)},
                                    jnp.asarray(q), pos, jcfg,
                                    backend=backend)
    got = tbackends.decode_execute(_torch_state(st, kv_dtype),
                                   {"proj": torch.from_numpy(proj)},
                                   torch.from_numpy(q), pos, tcfg,
                                   backend=backend)
    w = np.asarray(want)
    limit = 5e-5 * max(1.0, float(np.abs(w).max()))
    assert float(np.abs(got.numpy() - w).max()) <= limit
    # per-slot (B,) positions go through the same math
    posb = np.array([pos, pos - 3], np.int32)
    want = jbackends.decode_execute(_jax_state(st, kv_dtype),
                                    {"proj": jnp.asarray(proj)},
                                    jnp.asarray(q), jnp.asarray(posb), jcfg,
                                    backend=backend)
    got = tbackends.decode_execute(_torch_state(st, kv_dtype),
                                   {"proj": torch.from_numpy(proj)},
                                   torch.from_numpy(q),
                                   torch.from_numpy(posb), tcfg,
                                   backend=backend)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= limit


def test_resolve_decode_aliases_and_loud_failure():
    for name in ("gather", "reference", "kernel", "pallas", "xla", "dense"):
        assert tbackends.resolve_decode(name) == \
            jbackends.resolve_decode(name)
    with pytest.raises(ValueError, match="unknown SLA decode backend"):
        tbackends.resolve_decode("flash")


# the split-and-combine: a wider grid (Tn 16, K 9, live row 10) so that
# widths 1, 2, 7 and K split it, some splits starting past cnt
SPLIT_TN, SPLIT_K, SPLIT_ROW = 16, 9, 10
SPLIT_WIDTHS = [1, 2, 7, SPLIT_K]


@functools.cache
def _split_case(c, kv_dtype):
    """The flat kernel operands (`_flat_args` of `decode_operands`) of a
    state with NaN-poisoned padded slots, and the reference's
    `_fused_decode` on them (per-token hdiag/htot: for the live row, the
    stored diagonal block and the running totals)."""
    st, qg, qpg, pos = _state(17 + c, c, kv_dtype, tn=SPLIT_TN,
                              k_sel=SPLIT_K, row=SPLIT_ROW, nan=True)
    flat = sla_decode._flat_args(*sla_decode.decode_operands(
        _torch_state(st, kv_dtype), torch.from_numpy(qg),
        torch.from_numpy(qpg), pos), BKV)
    ref = list(flat)
    if ref[10] is None:  # live row
        ref[10], ref[11] = ref[8][:, SPLIT_ROW, None], ref[9][:, SPLIT_ROW,
                                                                None]
        ref[12], ref[13] = ref[12][:, None], ref[13][:, None]

    def to_jax(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())

    want = jdecode._fused_decode(*map(to_jax, ref), scale=D ** -0.5,
                                 block_kv=BKV, group=G, interpret=True)
    return flat, [np.asarray(w) for w in want]


@pytest.mark.parametrize("width", SPLIT_WIDTHS)
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 4])
def test_split_twin_matches_pallas_kernel(c, kv_dtype, width):
    """The kernel's split-and-combine (the twin at `split_width`) against
    the Pallas kernel: finite despite the NaN blocks behind the padded
    slots, within the file's tolerance, exact zeros where marg = 0; and
    `sla_decode` on CPU tensors with a forced width is that twin."""
    flat, want = _split_case(c, kv_dtype)
    kw = dict(scale=D ** -0.5, block_kv=BKV, group=G)
    got = sla_decode.sla_decode_plain(*flat, **kw, split_width=width)
    before = sla_decode.LAUNCHES
    wrapped = sla_decode.sla_decode(*flat, **kw, split_width=width)
    assert sla_decode.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(got, wrapped))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        limit = TOL[kv_dtype] * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= limit
    cnt, marg = flat[1], flat[2]
    nsplit = -(-SPLIT_K // width)
    if nsplit > 1:  # some row's last split starts past its cnt
        assert bool((cnt <= (nsplit - 1) * width).any())
    dead = marg == 0
    assert bool(dead.any()) and float(got[1][dead].abs().max()) == 0.0


@pytest.mark.parametrize("rows,k_sel,sms", [
    (32, 26, 132), (64, 26, 132), (128, 26, 132), (27, 26, 132),
    (8, 3, 132), (4096, 26, 132), (6, 9, 4), (1, 1, 132)])
def test_split_chooser_covers_every_live_slot_once(rows, k_sel, sms):
    """`choose_split_width`: the widest split, up to MAX_SPLIT_WIDTH,
    whose grid still gives every SM SPLITS_PER_SM blocks where the slots
    allow it; for every count the splits [n w, min((n + 1) w, cnt)) walk
    each live slot exactly once."""
    w = sla_decode.choose_split_width(rows, k_sel, sms)
    assert 1 <= w <= min(k_sel, sla_decode.MAX_SPLIT_WIDTH)
    nsplit = -(-k_sel // w)
    want = min(sla_decode.SPLITS_PER_SM * sms, rows * k_sel)
    assert rows * nsplit >= want
    assert w in (k_sel, sla_decode.MAX_SPLIT_WIDTH) or \
        rows * -(-k_sel // (w + 1)) < want
    for cnt in range(k_sel + 1):
        walked = [s for n in range(nsplit)
                  for s in range(n * w, min((n + 1) * w, cnt))]
        assert walked == list(range(cnt))
    q, lut = torch.zeros(rows, 1, 4), torch.zeros(rows, 1, k_sel)
    assert sla_decode.split_geometry(q, lut, sms=sms) == dict(
        split_width=w, nsplit=nsplit, grid_ctas=rows * (nsplit + 1))


def test_split_width_is_refused_outside_one_to_k():
    flat, _ = _split_case(1, "f32")
    kw = dict(scale=D ** -0.5, block_kv=BKV, group=G)
    for bad in (0, SPLIT_K + 1, 2.0, True):
        with pytest.raises(ValueError, match="split_width"):
            sla_decode.sla_decode(*flat, **kw, split_width=bad)
