"""The paged decode kernel's function and the decode backends on paged
state, port against JAX.

`repro_torch.kernels.sla_decode.sla_decode_paged_plain` (the CUDA paged
kernel's plain twin, which `sla_decode_paged` runs on CPU tensors) is held
to the reference's `_fused_decode_paged` (the Pallas kernel in interpret
mode) on the same numpy pools: B 2, Hkv 2, G 2, D 32, bkv 16, Tn 8, a pool
of 24 pages whose page table shares the slots' first 3 pages and shuffles
the rest, per-slot positions mid-block, marg = 0 rows, and padded LUT
slots pointing at other blocks; f32 K/V within 5e-5 and bf16 K/V within
5e-2 of max(1, max |reference|). Then `decode_attention` and
`decode_execute` of each decode backend (gather / reference / kernel) on
paged state against the JAX function of the same name (5e-5), and the
port's paged state against the monolithic state it represents, per
backend, bitwise. The kernel's split-and-combine, as the paged twin
computes it (`split_width`), is held to the same Pallas kernel over split
widths with NaN-poisoned pages behind the padded slots, and to the
monolithic twin on the page-gathered view at the same width, bitwise.
The paged kernel's partial mode (a split paged cache's spans,
`sla_decode_paged_partial`) is held bitwise to the decode kernel's
partial mode on the page-gathered span at split widths 1-4, and its
spans' records, merged by `sla_decode_combine`, to the Pallas paged
kernel. The CUDA kernel itself runs only on a GPU:
tests/test_torch_gpu.py.
"""
import functools

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
from repro_torch.kernels import cases, sla_decode

B, HKV, G, D, BKV, TN, P, K = 2, 2, 2, 32, 16, 8, 24, 4
H = HKV * G
SHARED = 3
TOL = {"f32": 5e-5, "bf16": 5e-2}


def _cfgs():
    kw = dict(block_q=BKV, block_kv=BKV, kh_frac=0.25, kl_frac=0.0,
              causal=True, decode_mode="sla")
    return JaxSLAConfig(**kw), SLAConfig(**kw)


def _state(seed, kv_dtype, poison=True, tn=TN, npages=P, k_sel=K,
           rows=(5, 6), nan=False):
    """Numpy paged decode state: pools (P, Hkv, ...), a page table in
    which both slots share their first SHARED pages and hold distinct
    shuffled pages after them, per-slot positions mid-block (rows 5 and
    6), the live LUT per q head (diagonal first, distinct earlier blocks
    after it, padded slots naming other blocks or repeating the first),
    marg with zero rows, and each slot's running totals. `nan`: the
    padded slots name blocks past the live one, whose pages hold NaN."""
    rs = np.random.default_rng(seed)
    TN, P, K = tn, npages, k_sel  # noqa: N806 (this state's sizes)
    pos = np.array([rows[0] * BKV + 6, rows[1] * BKV + 2], np.int32)
    k = rs.standard_normal((P, HKV, BKV, D), dtype=np.float32)
    v = rs.standard_normal((P, HKV, BKV, D), dtype=np.float32)
    if kv_dtype == "bf16":
        k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                for x in (k, v))
    hblk = rs.random((P, HKV, D, D), dtype=np.float32) * 0.2
    zblk = rs.random((P, HKV, D), dtype=np.float32) + 0.1
    perm = rs.permutation(np.arange(1, P))
    pt = np.zeros((B, TN), np.int32)
    pt[:, :SHARED] = perm[:SHARED]
    pt[:, SHARED:] = perm[SHARED:SHARED + B * (TN - SHARED)].reshape(
        B, TN - SHARED)
    lut = np.zeros((B, H, K), np.int32)
    cnt = rs.integers(1, K + 1, size=(B, H)).astype(np.int32)
    for b, h in np.ndindex(B, H):
        row = pos[b] // BKV
        lut[b, h] = np.concatenate([[row], rs.permutation(row)[:K - 1]])
        if nan:
            lut[b, h][cnt[b, h]:] = rs.integers(row + 1, TN, K - cnt[b, h])
        elif poison:
            pad = [j for j in range(TN) if j not in lut[b, h][:cnt[b, h]]]
            lut[b, h][cnt[b, h]:] = rs.permutation(pad)[:K - cnt[b, h]]
        else:
            lut[b, h][cnt[b, h]:] = lut[b, h][0]
    marg = rs.integers(0, 4, size=(B, H)).astype(np.int32)
    marg.reshape(-1)[::3] = 0
    htot = np.stack([hblk[pt[b, :pos[b] // BKV + 1]].sum(0)
                     for b in range(B)])
    ztot = np.stack([zblk[pt[b, :pos[b] // BKV + 1]].sum(0)
                     for b in range(B)])
    st = dict(k=k, v=v, hblk=hblk, zblk=zblk, pt=pt, lut=lut, cnt=cnt,
              marg=marg, htot=htot, ztot=ztot)
    if nan:  # each slot's own pages past its live block
        for b in range(B):
            for pool in (k, v, hblk, zblk):
                pool[pt[b, pos[b] // BKV + 1:]] = np.nan
    qg = rs.standard_normal((B, HKV, G, 1, D), dtype=np.float32)
    qpg = rs.random((B, HKV, G, 1, D), dtype=np.float32)
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


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, (err, limit)


def _flat_case(st, qg, qpg, pos, kv_dtype):
    """`sla_decode_paged`'s flat operands of a state, and the reference's
    `_fused_decode_paged(interpret=True)` on its head-major pool layout
    and gathered `plut`."""
    K = st["lut"].shape[-1]  # noqa: N806
    bh = B * H
    plut = np.take_along_axis(st["pt"][:, None, :].repeat(H, 1), st["lut"],
                              axis=2)
    dpid = st["pt"][np.arange(B), pos // BKV]
    js = _jax_state(st, kv_dtype)
    flat = dict(
        lut=st["lut"].reshape(bh, 1, K), cnt=st["cnt"].reshape(bh, 1),
        marg=st["marg"].reshape(bh, 1), posv=np.repeat(pos, H),
        q=qg.reshape(bh, 1, D), qp=qpg.reshape(bh, 1, D))
    want = jdecode._fused_decode_paged(
        jnp.asarray(flat["lut"]), jnp.asarray(plut.reshape(bh, 1, K)),
        jnp.asarray(flat["cnt"]), jnp.asarray(flat["marg"]),
        jnp.asarray(flat["posv"]), jnp.asarray(flat["q"]),
        jnp.asarray(flat["qp"]), jnp.moveaxis(js["k"], 0, 1),
        jnp.moveaxis(js["v"], 0, 1), jnp.moveaxis(js["hblk"], 0, 1),
        jnp.moveaxis(js["zblk"], 0, 1),
        js["hblk"][dpid].reshape(B * HKV, 1, D, D),
        js["zblk"][dpid].reshape(B * HKV, 1, D),
        js["htot"].reshape(B * HKV, 1, D, D),
        js["ztot"].reshape(B * HKV, 1, D),
        scale=D ** -0.5, block_kv=BKV, group=G, hkv=HKV, interpret=True)
    ts = _torch_state(st, kv_dtype)
    args = (torch.from_numpy(np.ascontiguousarray(flat["lut"])), ts["pt"],
            torch.from_numpy(np.ascontiguousarray(flat["cnt"])),
            torch.from_numpy(np.ascontiguousarray(flat["marg"])),
            torch.from_numpy(flat["posv"]),
            torch.from_numpy(np.ascontiguousarray(flat["q"])),
            torch.from_numpy(np.ascontiguousarray(flat["qp"])), ts["k"],
            ts["v"], ts["hblk"], ts["zblk"], ts["htot"].reshape(-1, D, D),
            ts["ztot"].reshape(-1, D))
    return args, want


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("poison", [True, False])
def test_paged_twin_matches_pallas_paged_kernel(kv_dtype, poison):
    """The flat paged twin against `_fused_decode_paged(interpret=True)`
    on the reference's head-major pool layout and gathered `plut`."""
    st, qg, qpg, pos = _state(3 + poison, kv_dtype, poison)
    args, want = _flat_case(st, qg, qpg, pos, kv_dtype)
    kw = dict(scale=D ** -0.5, block_kv=BKV, group=G)
    before = sla_decode.PAGED_LAUNCHES
    got = sla_decode.sla_decode_paged(*args, **kw)
    assert sla_decode.PAGED_LAUNCHES == before  # the twin is no launch
    twin = sla_decode.sla_decode_paged_plain(*args, **kw)
    for g, t, w in zip(got, twin, want):
        assert torch.equal(g, t)
        _close(g, w, TOL[kv_dtype])
    dead = st["marg"].reshape(-1) == 0
    assert dead.any() and float(got[1][dead].abs().max()) == 0.0
    assert float(got[1].abs().max()) > 0


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_decode_attention_on_paged_state_matches_jax(kv_dtype):
    jcfg, tcfg = _cfgs()
    st, qg, qpg, pos = _state(9, kv_dtype)
    want = jdecode.decode_attention(_jax_state(st, kv_dtype),
                                    jnp.asarray(qg), jnp.asarray(qpg),
                                    jnp.asarray(pos), jcfg, None,
                                    interpret=True)
    got = sla_decode.decode_attention(_torch_state(st, kv_dtype),
                                      torch.from_numpy(qg),
                                      torch.from_numpy(qpg),
                                      torch.from_numpy(pos), tcfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, TOL[kv_dtype])


def _monolithic(ts):
    """The monolithic decode state the paged one represents."""
    pt = ts["pt"].long()

    def blk(pool):  # (P, Hkv, ...) -> (B, Hkv, Tn, ...)
        return pool[pt].movedim(2, 1).contiguous()

    out = {n: t for n, t in ts.items() if n != "pt"}
    out["k"] = blk(ts["k"]).reshape(B, HKV, TN * BKV, D)
    out["v"] = blk(ts["v"]).reshape(B, HKV, TN * BKV, D)
    out["hblk"], out["zblk"] = blk(ts["hblk"]), blk(ts["zblk"])
    return out


@pytest.mark.parametrize("backend", ["gather", "reference", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_paged_decode_backends_match_jax_and_monolithic(backend, kv_dtype):
    """decode_execute on paged state against the JAX backend of the same
    name (5e-5), and bitwise against the port's own monolithic state."""
    jcfg, tcfg = _cfgs()
    st, _, _, pos = _state(5, kv_dtype, poison=False)
    rs = np.random.default_rng(6)
    q = rs.standard_normal((B, H, 1, D), dtype=np.float32)
    proj = rs.standard_normal((H, D, D), dtype=np.float32) * 0.1
    want = jbackends.decode_execute(_jax_state(st, kv_dtype),
                                    {"proj": jnp.asarray(proj)},
                                    jnp.asarray(q), jnp.asarray(pos), jcfg,
                                    backend=backend)
    ts = _torch_state(st, kv_dtype)
    args = ({"proj": torch.from_numpy(proj)}, torch.from_numpy(q),
            torch.from_numpy(pos), tcfg)
    got = tbackends.decode_execute(ts, *args, backend=backend)
    _close(got, want, 5e-5)
    mono = tbackends.decode_execute(_monolithic(ts), *args, backend=backend)
    assert torch.equal(got, mono)


# the split-and-combine: Tn 16, K 9, live rows 10 and 12 over 40 pages,
# so that widths 1, 2, 7 and K split the walk, some splits past cnt
SPLIT_TN, SPLIT_P, SPLIT_K = 16, 40, 9
SPLIT_WIDTHS = [1, 2, 7, SPLIT_K]


@functools.cache
def _split_case(kv_dtype):
    st, qg, qpg, pos = _state(23, kv_dtype, tn=SPLIT_TN, npages=SPLIT_P,
                              k_sel=SPLIT_K, rows=(10, 12), nan=True)
    args, want = _flat_case(st, qg, qpg, pos, kv_dtype)
    return args, [np.asarray(w) for w in want]


@pytest.mark.parametrize("width", SPLIT_WIDTHS)
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_paged_split_twin_matches_pallas_paged_kernel(kv_dtype, width):
    """The paged kernel's split-and-combine (the paged twin at
    `split_width`) against the Pallas paged kernel: finite despite the NaN
    pages behind the padded slots, within the file's tolerance, exact
    zeros where marg = 0; `sla_decode_paged` on CPU tensors with a forced
    width is that twin, and no launch."""
    args, want = _split_case(kv_dtype)
    kw = dict(scale=D ** -0.5, block_kv=BKV, group=G)
    got = sla_decode.sla_decode_paged_plain(*args, **kw, split_width=width)
    before = sla_decode.PAGED_LAUNCHES
    wrapped = sla_decode.sla_decode_paged(*args, **kw, split_width=width)
    assert sla_decode.PAGED_LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(got, wrapped))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, TOL[kv_dtype])
    cnt, marg = args[2], args[3]
    nsplit = -(-SPLIT_K // width)
    if nsplit > 1:  # some row's last split starts past its cnt
        assert bool((cnt <= (nsplit - 1) * width).any())
    dead = marg.reshape(-1) == 0
    assert bool(dead.any()) and float(got[1][dead].abs().max()) == 0.0


@pytest.mark.parametrize("width", [None, *SPLIT_WIDTHS])
def test_paged_split_matches_monolithic_on_the_gathered_view(width):
    """A paged call and a monolithic call on the same rows split alike
    (`split_geometry` reads the shapes only) and, at the same width, the
    paged twin equals the monolithic twin on the page-gathered view
    bitwise, NaN pages and all."""
    args, _ = _split_case("f32")
    dense = cases.paged_dense_operands(args)
    geo = sla_decode.split_geometry(args[5], args[0], width, sms=132)
    assert geo == sla_decode.split_geometry(dense[4], dense[0], width,
                                             sms=132)
    kw = dict(scale=D ** -0.5, block_kv=BKV, group=G,
              split_width=geo["split_width"])
    paged = sla_decode.sla_decode_paged_plain(*args, **kw)
    mono = sla_decode.sla_decode_plain(*dense, **kw)
    assert all(torch.equal(a, b) for a, b in zip(paged, mono))


# kernel 5's partial mode: the split case's 16 blocks in spans of 4
SPAN_BLOCKS = 4


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_paged_partial_twin_is_the_partial_twin_on_the_gathered_view(
        kv_dtype, width):
    """Kernel 5's partial mode over the spans of a split paged cache (the
    twin `sla_decode_paged_partial` runs on CPU tensors, no launch): each
    span's records bitwise `sla_decode_partial_plain` on the span of the
    page-gathered view at the same split width, NaN pages and all; the
    spans' records merged by `sla_decode_combine` within the file's
    tolerance of the Pallas paged kernel (interpret mode)."""
    args, want = _split_case(kv_dtype)
    kw = dict(scale=D ** -0.5, block_kv=BKV, group=G, split_width=width)
    records = []
    for first in range(0, SPLIT_TN, SPAN_BLOCKS):
        paged, dense = cases.paged_span_operands(args, first, SPAN_BLOCKS)
        before = sla_decode.PAGED_PARTIAL_LAUNCHES
        got = sla_decode.sla_decode_paged_partial(*paged, **kw)
        assert sla_decode.PAGED_PARTIAL_LAUNCHES == before
        assert torch.equal(got, sla_decode.sla_decode_paged_partial_plain(
            *paged, **kw))
        assert torch.equal(got, sla_decode.sla_decode_partial_plain(
            *dense, **kw))
        records.append(got)
    dense_args = cases.paged_dense_operands(args)
    o = cases.span_combine(torch.stack(records), dense_args, G)
    for g, w in zip(o, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, TOL[kv_dtype])
