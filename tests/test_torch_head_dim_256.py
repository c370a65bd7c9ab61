"""Kernels 1, 4 and 5 at head dim 256 (gemma3-1b's heads), port against JAX.

The plain twins that the CUDA kernels are held to on the card are held
here to the Pallas kernels in interpret mode, at D 256 with gemma3's GQA
(4 query heads on 1 kv head), on the same numpy inputs: `sla_fwd_plain`
to `repro.kernels.sla_fwd.sla_fwd` (causal, with a `base` row offset, f32
and bf16 q/k/v), and `decode_attention` on monolithic state (C 1 and 4)
and on paged state to `repro.kernels.sla_decode.decode_attention` (f32
and bf16 K/V). Tolerances: f32 5e-5, bf16 5e-2, relative to max(1, max
|reference|). Then the smoke gemma3 at head_dim 256 through the kernel
backend in f32: prefill (two SLA layers through the forward kernel's
twin, two sliding-window layers) and 8 decode-time SLA steps, within the
f32 limits of the reference on its Pallas kernels. The backward kernels'
twins (`sla_bwd_dq_plain`, `sla_bwd_dkv_plain`, which CPU tensors run)
are held to `repro.kernels.sla_bwd.sla_bwd_dq` / `sla_bwd_dkv` in
interpret mode at D 256, GQA 4:1, causal, on a JAX plan's row LUT and its
column LUT capped by `col_capacity_factor`: f32 and bf16 q/k/v at 5e-5,
the bf16 twin that rounds dO, P and dS (`mma_dtype=torch.bfloat16`) at
5e-2. Last, the smoke gemma3's `loss_fn` and every parameter's gradient
at D 256 on the kernel backend in f32 against JAX's `value_and_grad` on
its Pallas kernels, within 5e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.core import plan as jplan
from repro.core.config import SLAConfig as JSLAConfig
from repro.data import pipeline as jpipeline
from repro.kernels import sla_bwd as jbwd
from repro.kernels import sla_decode as jdecode
from repro.kernels.sla_fwd import sla_fwd as jax_sla_fwd
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.config import SLAConfig
from repro_torch.kernels import sla_bwd, sla_decode, sla_fwd
from repro_torch.models import transformer as ttfm

D, G = 256, 4
TOL = {"f32": 5e-5, "bf16": 5e-2}


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_twin_matches_pallas_kernel_at_d256(dtype):
    """4 query heads on 1 kv head, 32 x 32 blocks, causal, the query span
    of blocks 2-3 against 4 KV blocks (base 2)."""
    rs = np.random.default_rng(1)
    n, block, base, span = 128, 32, 2, 2
    q = rs.standard_normal((G, n, D), dtype=np.float32)
    k, v = (rs.standard_normal((1, n, D), dtype=np.float32)
            for _ in range(2))
    if dtype == "bf16":
        q, k, v = map(_bf16, (q, k, v))
    rows = slice(base * block, (base + span) * block)
    q = q[:, rows]
    lut = np.stack([np.array([[2, 0, 1], [3, 1, 2]], np.int32)] * G)
    counts = np.array([[2, 3]] * G, np.int32)
    qp = np.exp(q - q.max(-1, keepdims=True))
    qp = (qp / qp.sum(-1, keepdims=True)).astype(np.float32)
    hi = (0.05 * rs.standard_normal((G, span, D, D))).astype(np.float32)
    zi = np.abs(rs.standard_normal((G, span, D))).astype(np.float32)
    kw = dict(scale=D ** -0.5, causal=True, block_q=block, block_kv=block)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = jax_sla_fwd(jnp.asarray(lut), jnp.asarray(counts),
                       *(jnp.asarray(x, jd) for x in (q, k, v)),
                       *map(jnp.asarray, (qp, hi, zi)), **kw,
                       interpret=True, base=jnp.asarray([base], jnp.int32))
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = sla_fwd.sla_fwd(
        *map(torch.from_numpy, (lut, counts)),
        *(torch.from_numpy(np.ascontiguousarray(x)).to(td)
          for x in (q, k, v)),
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (qp, hi, zi)),
        **kw, base=base)
    for g, w, what in zip(got, want, ("o_s", "o_l", "lse")):
        _close(g, w, TOL[dtype], what)
    assert sla_fwd.forward_route(td, 64, 64, D) == "fma"


BKV, TN, K, ROW = 16, 6, 3, 4


def _cfgs():
    kw = dict(block_q=BKV, block_kv=BKV, kh_frac=0.25, kl_frac=0.0,
              causal=True, decode_mode="sla")
    return JSLAConfig(**kw), SLAConfig(**kw)


def _decode_state(seed, c, kv_dtype, paged):
    """A D-256 decode state for batch 2: monolithic (B, 1, Smax, D) with
    per-token totals and diagonal partials at C > 1, or page pools of 16
    pages with a page table whose slots share their first 2 pages."""
    rs = np.random.default_rng(seed)
    b = 2
    nblk = 16 if paged else TN
    lead = (nblk, 1) if paged else (b, 1, TN)
    k, v = (rs.standard_normal(lead + (BKV, D), dtype=np.float32)
            for _ in range(2))
    if kv_dtype == "bf16":
        k, v = _bf16(k), _bf16(v)
    hblk = rs.random(lead + (D, D), dtype=np.float32) * 0.05
    zblk = rs.random(lead + (D,), dtype=np.float32) + 0.1
    tok = (b, G, c) if c > 1 else (b, G)
    lut = np.zeros(tok + (K,), np.int32)
    for idx in np.ndindex(*tok):
        lut[idx] = np.concatenate([[ROW], rs.permutation(ROW)[:K - 1]])
    cnt = rs.integers(1, K + 1, size=tok).astype(np.int32)
    marg = rs.integers(0, 3, size=tok).astype(np.int32)
    marg.reshape(-1)[::3] = 0
    st = dict(lut=lut, cnt=cnt, marg=marg)
    if paged:
        pt = np.zeros((b, TN), np.int32)
        perm = rs.permutation(np.arange(1, nblk))
        pt[:, :2] = perm[:2]
        pt[:, 2:] = perm[2:2 + b * (TN - 2)].reshape(b, TN - 2)
        live = [pt[i, :ROW + 1] for i in range(b)]
        st.update(k=k, v=v, hblk=hblk, zblk=zblk, pt=pt,
                  htot=np.stack([hblk[p].sum(0) for p in live]),
                  ztot=np.stack([zblk[p].sum(0) for p in live]))
    else:
        smax = TN * BKV
        hblk[:, :, ROW + 1:] = 0.0
        zblk[:, :, ROW + 1:] = 0.0
        st.update(k=k.reshape(b, 1, smax, D), v=v.reshape(b, 1, smax, D),
                  hblk=hblk, zblk=zblk, htot=hblk.sum(2), ztot=zblk.sum(2))
        if c > 1:
            grow = rs.random((b, 1, c, D, D), dtype=np.float32) * 0.02
            growz = rs.random((b, 1, c, D), dtype=np.float32) * 0.02
            st["hdiag"] = hblk[:, :, ROW][:, :, None] * 0.5 + np.cumsum(
                grow, 2)
            st["zdiag"] = zblk[:, :, ROW][:, :, None] * 0.5 + np.cumsum(
                growz, 2)
            st["htot"] = st["htot"][:, :, None] + np.cumsum(grow, 2)
            st["ztot"] = st["ztot"][:, :, None] + np.cumsum(growz, 2)
    qg = rs.standard_normal((b, 1, G, c, D), dtype=np.float32)
    qpg = rs.random((b, 1, G, c, D), dtype=np.float32)
    qpg /= qpg.sum(-1, keepdims=True)
    pos = np.array([ROW * BKV + 6, ROW * BKV + 9], np.int32) if paged \
        else ROW * BKV + 6
    return st, qg, qpg, pos


DECODE = [(1, False), (4, False), (1, True)]


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,paged", DECODE,
                         ids=["c1", "c4", "paged"])
def test_decode_twins_match_pallas_kernels_at_d256(c, paged, kv_dtype):
    jcfg, tcfg = _cfgs()
    st, qg, qpg, pos = _decode_state(7 + c + paged, c, kv_dtype, paged)
    js = {n: jnp.asarray(a) for n, a in st.items()}
    ts = {n: torch.from_numpy(np.ascontiguousarray(a))
          for n, a in st.items()}
    if kv_dtype == "bf16":
        for n in "kv":
            js[n] = js[n].astype(jnp.bfloat16)
            ts[n] = ts[n].to(torch.bfloat16)
    want = jdecode.decode_attention(js, jnp.asarray(qg), jnp.asarray(qpg),
                                    jnp.asarray(pos), jcfg, None,
                                    interpret=True)
    got = sla_decode.decode_attention(ts, torch.from_numpy(qg),
                                      torch.from_numpy(qpg),
                                      torch.from_numpy(np.asarray(pos)),
                                      tcfg)
    for g, w, what in zip(got, want, ("o_s", "o_l")):
        assert g.shape == w.shape
        _close(g, w, TOL[kv_dtype], what)
    assert float(got[1].abs().max()) > 0


def test_backward_twins_run_at_d256_on_cpu_tensors():
    """Item 15 part 3 takes the backward kernels to 256 on the card; on
    CPU tensors the wrappers run their twins at any head dim."""
    gen = torch.Generator().manual_seed(0)
    n, block = 64, 32
    q, k, v, do = (torch.randn((4, n, D), generator=gen) for _ in range(4))
    lut = torch.tensor([[[0, 0], [1, 0]]] * 4, dtype=torch.int32)
    counts = torch.tensor([[1, 2]] * 4, dtype=torch.int32)
    lse = torch.randn((4, n), generator=gen)
    kw = dict(scale=D ** -0.5, causal=True, block_q=block, block_kv=block)
    dq = sla_bwd.sla_bwd_dq(lut, counts, q, k, v, do, lse, lse, **kw)
    dk, dv = sla_bwd.sla_bwd_dkv(lut, counts, q, k, v, do, lse, lse, **kw)
    assert dq.shape == dk.shape == dv.shape == (4, n, D)
    assert bool(torch.isfinite(dq).all())


def _bwd_case(dtype):
    """Numpy operands of both backward calls at D 256: 4 query heads on 1
    kv head, N 256 in 32 x 32 blocks, causal, the JAX plan's row LUT and
    its column LUT (width from `col_capacity_factor` 2.0), L and O^s from
    the forward twin, a random dO^s."""
    rs = np.random.default_rng(11)
    n, block = 256, 32
    q = rs.standard_normal((G, n, D), dtype=np.float32)
    k, v = (rs.standard_normal((1, n, D), dtype=np.float32)
            for _ in range(2))
    if dtype != "f32":
        q, k, v = map(_bf16, (q, k, v))
    cfg = JSLAConfig(block_q=block, block_kv=block, kh_frac=0.25,
                     kl_frac=0.25, causal=True, col_capacity_factor=2.0)
    plan = jplan.plan_attention(jnp.asarray(q[None]), jnp.asarray(k[None]),
                                cfg)
    c = {name: np.asarray(getattr(plan, name)[0]).astype(np.int32)
         for name in ("lut", "counts", "col_lut", "col_counts")}
    assert c["col_lut"].shape[-1] < n // block  # the capacity cut it
    kw = dict(scale=D ** -0.5, causal=True, block_q=block, block_kv=block)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o_s, _, lse = sla_fwd.sla_fwd_plain(
        torch.from_numpy(c["lut"]), torch.from_numpy(c["counts"]), *t,
        torch.zeros_like(t[0]), torch.zeros((G, n // block, D, D)),
        torch.zeros((G, n // block, D)), **kw)
    do = rs.standard_normal((G, n, D), dtype=np.float32)
    c.update(q=q, k=k, v=v, do=do, lse=lse.numpy(),
             d_s=(torch.from_numpy(do) * o_s).sum(-1).numpy())
    return c, kw


@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16-rounded"])
def test_backward_twins_match_pallas_kernels_at_d256(dtype):
    c, kw = _bwd_case(dtype)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tail = ("q", "k", "v", "do", "lse", "d_s")
    jt = [jnp.asarray(c[x], jd if x in "qkv" else jnp.float32) for x in tail]
    tt = [torch.from_numpy(c[x]).to(td if x in "qkv" else torch.float32)
          for x in tail]
    rounded = dict(mma_dtype=torch.bfloat16) if dtype == "bf16-rounded" \
        else {}
    tol = 5e-2 if rounded else TOL["f32"]
    want = jbwd.sla_bwd_dq(jnp.asarray(c["lut"]), jnp.asarray(c["counts"]),
                           *jt, **kw, interpret=True)
    got = sla_bwd.sla_bwd_dq_plain(torch.from_numpy(c["lut"]),
                                   torch.from_numpy(c["counts"]), *tt, **kw,
                                   **rounded)
    _close(got, want, tol, "dq")
    jdk, jdv = jbwd.sla_bwd_dkv(jnp.asarray(c["col_lut"]),
                                jnp.asarray(c["col_counts"]), *jt, **kw,
                                interpret=True)
    tdk, tdv = sla_bwd.sla_bwd_dkv_plain(torch.from_numpy(c["col_lut"]),
                                         torch.from_numpy(c["col_counts"]),
                                         *tt, **kw, **rounded)
    _close(tdk, jdk, tol, "dk")
    _close(tdv, jdv, tol, "dv")
    assert float(got.abs().max()) > 0 and float(tdk.abs().max()) > 0


@functools.lru_cache(maxsize=None)
def _gemma256():
    jcfg, tcfg = (dataclasses.replace(get("gemma3-1b").smoke(), head_dim=D)
                  for get in (jax_get_arch, get_arch))
    params = jtfm.init(jax.random.PRNGKey(2), jcfg)
    rs = np.random.default_rng(3)
    params["layers"]["sla_proj"] = jnp.asarray(0.05 * rs.standard_normal(
        params["layers"]["sla_proj"].shape, dtype=np.float32))
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return jcfg, tcfg, params, model


def test_gemma3_at_d256_through_the_kernel_backend():
    """Prefill of 2 x 64 tokens and 8 decode-time SLA steps (a block
    boundary at 64 on the first) on the kernel backend of both packages:
    last hidden, logits and the live rows within the f32 limits."""
    jcfg, tcfg, params, model = _gemma256()
    assert tcfg.head_dim == D and tcfg.num_heads // tcfg.num_kv_heads == G
    toks = np.random.default_rng(4).integers(0, 512, size=(2, 64)) \
        .astype(np.int32)
    jlast, jcache = jax.jit(functools.partial(
        jtfm.prefill, cfg=jcfg, compute_dtype=jnp.float32,
        backend="kernel", decode_max_len=96))(params,
                                              tokens=jnp.asarray(toks))
    step = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg,
                                     compute_dtype=jnp.float32,
                                     backend="kernel"))
    with torch.no_grad():
        tlast, tcache = ttfm.prefill(model, tcfg,
                                     torch.from_numpy(toks).long(),
                                     compute_dtype=torch.float32,
                                     backend="kernel", decode_max_len=96)
    _close(tlast, jlast, TOL["f32"], "last hidden")
    tokens = np.random.default_rng(5).integers(0, 512, size=(8, 2)) \
        .astype(np.int32)
    for i in range(8):
        jl, jcache = step(params, token=jnp.asarray(tokens[i]), cache=jcache)
        with torch.no_grad():
            tl, tcache = ttfm.decode_step(
                model, tcfg, torch.from_numpy(tokens[i]).long(), tcache,
                compute_dtype=torch.float32, backend="kernel")
        _close(tl, jl, 1e-4, f"logits of step {i}")
    for name in ("live_lut", "live_cnt", "live_marg"):
        assert np.array_equal(tcache["sla"][name].numpy(),
                              np.asarray(jcache["sla"][name])), name


def test_gemma3_at_d256_loss_and_grads_match_jax():
    """`loss_fn` on one smoke `train_4k` batch on the kernel backend in
    f32 (the SLA layers through kernels 1-3's twins, both directions) and
    every parameter's gradient, against JAX's `value_and_grad` on its
    Pallas kernels: within 5e-5 x max(1, max |reference|)."""
    jcfg, tcfg, params, model = _gemma256()
    batch = jpipeline.token_batch(jcfg, jax_get_shape("train_4k", smoke=True),
                                  jpipeline.DataConfig(seed=3), 0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, batch, jnp.float32, "kernel")))(
        params)
    model.zero_grad(set_to_none=True)
    tl = ttfm.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                      torch.float32, "kernel")
    tl.backward()
    _close(tl.detach(), jl, TOL["f32"], "loss")
    want = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jg),
                                    device="cpu")
    # a sliding-window layer's sla_proj is never read: zero, as JAX's
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert sorted(want) == sorted(grads)
    assert any(float(g.abs().max()) > 0 for n, g in grads.items()
               if n.endswith("sla_proj"))
    for name, g in grads.items():
        _close(g, want[name], TOL["f32"], name)
    model.zero_grad(set_to_none=True)
