"""Attention execution backends: one registry, one `execute` interface.

`core/plan.py` classifies blocks and builds LUTs once; this module runs
the attention math given that plan. Three backends, all returning
(O^s, O^l):

  reference  dense oracle (O(N^2); validation only)
  gather     LUT-gather PyTorch path whose work is the true sparse cost
  kernel     the fused CUDA kernel (its plain twin for CPU tensors)

`execute(plan, params, q, k, v, cfg, backend=...)` owns mode dispatch
("sla" / "sparse_only" / "linear_only" / "l_plus_s" / "full"), the phi
feature maps, GQA head broadcast, and the learned Proj merge (Eq. 6).
A second registry runs one decode token against the decode cache state
(`decode_execute`; backends gather / reference / kernel), on monolithic
or paged decode state, `decode_partial_execute` one rank's span of a
split cache (kernel 4's partial records), and `decode_execute_chunk` a
chunk of C tokens
with per-token plan rows and linear-state snapshots (verify-style
decode). Counterpart of `repro.core.backends`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import reference as ref
from repro_torch.core.config import SLAConfig
from repro_torch.core.masks import NEG_INF
from repro_torch.core.phi import phi
from repro_torch.core.plan import SLAPlan, plan_attention
from repro_torch.core.plan import repeat_kv as _repeat_kv

Params = Dict[str, torch.Tensor]
# A backend maps (plan, q, k, v, qp, kp, cfg, scale) -> (O^s, O^l).
BackendFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

_BACKENDS: Dict[str, BackendFn] = {}

# Legacy spellings from the reference's pre-registry API.
_ALIASES = {"pallas": "kernel", "xla": "gather", "dense": "reference"}


def register_backend(name: str) -> Callable[[BackendFn], BackendFn]:
    """Decorator: register `fn` as the SLA execution backend `name`."""

    def deco(fn: BackendFn) -> BackendFn:
        _BACKENDS[name] = fn
        return fn

    return deco


def resolve(name: str) -> str:
    """Canonical backend name for `name` (resolving legacy aliases);
    unknown names fail loudly."""
    key = _ALIASES.get(name, name)
    if key not in _BACKENDS:
        raise ValueError(
            f"unknown SLA backend {name!r}; available: "
            f"{sorted(_BACKENDS)} (aliases: "
            f"{ {a: t for a, t in sorted(_ALIASES.items())} })")
    return key


def get_backend(name: str) -> BackendFn:
    return _BACKENDS[resolve(name)]


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


@register_backend("reference")
def _reference_backend(plan, q, k, v, qp, kp, cfg, scale):
    return ref.sla_forward_reference(q, k, v, qp, kp, plan.mc, cfg, scale,
                                     marginal=plan.marginal)


@register_backend("gather")
def _gather_backend(plan, q, k, v, qp, kp, cfg, scale):
    from repro_torch.core.block_sparse_xla import sla_forward_gather
    return sla_forward_gather(q, k, v, qp, kp, plan, cfg, scale)


@register_backend("kernel")
def _kernel_backend(plan, q, k, v, qp, kp, cfg, scale):
    from repro_torch.kernels import ops as kops
    return kops.sla_attention_core(q, k, v, qp, kp, plan, cfg, scale=scale)


def execute(plan: Optional[SLAPlan], params: Optional[Params],
            q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: SLAConfig, scale: Optional[float] = None,
            backend: str = "reference",
            routing: Optional[Params] = None) -> torch.Tensor:
    """Run SLA attention under `cfg.mode` with the given execution backend.

    q: (B, H, N, D); k, v: (B, Hkv, N, D) with Hkv | H. `plan` is the
    precomputed SLAPlan for (q, k); None plans inline. Modes that need no
    block structure ("full", "linear_only") ignore the plan.

    Returns (B, H, N, D) in q.dtype.
    """
    backend = resolve(backend)
    cfg.validate()
    in_dtype = q.dtype
    h = q.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)

    if cfg.mode == "full":
        return ref.full_attention(q, k, v, cfg.causal, scale).to(in_dtype)

    if cfg.mode == "linear_only":
        qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)
        o = ref.full_linear(qp, kp, v)
        if params is not None:
            o = torch.einsum("bhnd,hde->bhne", o, params["proj"].float())
        return o.to(in_dtype)

    if plan is None:
        plan = plan_attention(q, k, cfg, scale, routing=routing)
    else:
        tm, tn = q.shape[2] // cfg.block_q, k.shape[2] // cfg.block_kv
        if tuple(plan.mc.shape[-2:]) != (tm, tn):
            raise ValueError(
                f"stale SLAPlan: plan is for {tuple(plan.mc.shape[-2:])} "
                f"blocks but (q, k) need ({tm}, {tn}) — re-plan with "
                f"plan_attention(q, k, cfg)")

    if cfg.mode == "sparse_only":
        o_s, _ = ref.sparse_component(q, k, v, plan.mc, cfg, scale)
        return o_s.to(in_dtype)

    qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)

    if cfg.mode == "l_plus_s":
        o_s, _ = ref.sparse_component(q, k, v, plan.mc, cfg, scale)
        o_l = ref.full_linear(qp, kp, v)
        return (o_s + o_l).to(in_dtype)

    if cfg.mode != "sla":
        raise ValueError(f"unknown SLA mode {cfg.mode!r}")

    o_s, o_l = get_backend(backend)(plan, q, k, v, qp, kp, cfg, scale)
    proj = params["proj"].float()
    o = o_s + torch.einsum("bhnd,hde->bhne", o_l, proj)
    return o.to(in_dtype)


# ---------------------------------------------------------------------------
# decode-time SLA: one new token against the per-layer decode cache state
# ---------------------------------------------------------------------------
# A decode backend maps (state, qg, qpg, pos, cfg, scale) -> (O^s, O^l),
# both (B, Hkv, G, D) f32, where G = H // Hkv and `state` holds
#   k, v   : (B, Hkv, Smax, D)   static KV cache (Smax = Tn * block_kv)
#   hblk   : (B, Hkv, Tn, D, D)  per-block running h_j = sum phi(k) v^T
#   zblk   : (B, Hkv, Tn, D)     per-block running z_j = sum phi(k)
#   htot   : (B, Hkv, D, D)      running total H = sum_j h_j
#   ztot   : (B, Hkv, D)         running total Z = sum_j z_j
#   lut    : (B, H, K) int32     live row's critical block ids
#   cnt    : (B, H)    int32     live entries in lut
#   marg   : (B, H)    int32     live row's marginal block count
# Paged state adds the page table pt (B, Tn) int32 and holds k, v, hblk
# and zblk as the layer's page pools (P, Hkv, bkv, D) / (P, Hkv, D, D) /
# (P, Hkv, D), read through pt[b, lut].
# The linear branch is the subtractive aggregation (paper App. A.3),
#   H_marg = htot - sum_{j in lut} hblk[j],
# exact because decode plans classify with kl_frac = 0.
_DECODE_BACKENDS: Dict[str, BackendFn] = {}
_DECODE_ALIASES = {"pallas": "kernel", "xla": "gather", "dense": "reference"}


def register_decode_backend(name: str) -> Callable[[BackendFn], BackendFn]:
    def deco(fn: BackendFn) -> BackendFn:
        _DECODE_BACKENDS[name] = fn
        return fn

    return deco


def resolve_decode(name: str) -> str:
    """Canonical decode-backend name (loud failure, like `resolve`)."""
    key = _DECODE_ALIASES.get(name, name)
    if key not in _DECODE_BACKENDS:
        raise ValueError(
            f"unknown SLA decode backend {name!r}; available: "
            f"{sorted(_DECODE_BACKENDS)} (aliases: "
            f"{ {a: t for a, t in sorted(_DECODE_ALIASES.items())} })")
    return key


def _group_heads(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, H, ...) -> (B, Hkv, G, ...): q head h <-> (h // G, h % G)."""
    b, h = x.shape[:2]
    return x.reshape(b, hkv, h // hkv, *x.shape[2:])


def _gather_state(x: torch.Tensor, idx: torch.Tensor, k_sel: int
                  ) -> torch.Tensor:
    """x: (B, Hkv, Tn, ...); idx: (B, Hkv, G*K) -> (B, Hkv, G, K, ...)."""
    b, hkv = x.shape[:2]
    bi = torch.arange(b, device=x.device)[:, None, None]
    hi = torch.arange(hkv, device=x.device)[None, :, None]
    out = x[bi, hi, idx.long()]
    return out.reshape(b, hkv, -1, k_sel, *x.shape[3:])


def _pos_view(pos, ndim: int, device):
    """`pos` (python int, scalar or (B,) tensor) shaped to broadcast
    against a (B, ...) tensor of `ndim` dims; a python int stays one (no
    host-to-device copy)."""
    if not torch.is_tensor(pos):
        return int(pos)
    p = pos.to(device)
    return p if p.ndim == 0 else p.reshape(-1, *(1,) * (ndim - 1))


def _gather_pool(pool: torch.Tensor, idx: torch.Tensor, k_sel: int
                 ) -> torch.Tensor:
    """Paged analogue of `_gather_state`: pool (P, Hkv, ...) gathered by
    PHYSICAL page ids idx (B, Hkv, G*K) -> (B, Hkv, G, K, ...).

    The ids route the logical LUT through the page table (`plut =
    pt[b, lut]`), so the gathered blocks are the ones the monolithic
    layout would read. Dead LUT entries (beyond `cnt`) may name any live
    page; as in the monolithic path they are masked to exact zeros."""
    hkv = pool.shape[1]
    hi = torch.arange(hkv, device=pool.device)[None, :, None]
    out = pool[idx.long(), hi]
    return out.reshape(out.shape[0], out.shape[1], -1, k_sel,
                       *pool.shape[2:])


def _physical_lut(pt: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Logical block ids -> physical page ids: pt (B, Tn), lut
    (B, H, K) -> (B, H, K)."""
    b = torch.arange(pt.shape[0], device=pt.device)[:, None, None]
    return pt[b, lut.long()]


def gather_pages(pool: torch.Tensor, pt: torch.Tensor, axis: int = 0
                 ) -> torch.Tensor:
    """The monolithic per-block layout of a page pool (a copy): pool
    (..., P, Hkv, X...), its page axis at `axis`, gathered through the
    page table pt (B, Tn) -> (..., B, Hkv, Tn, X...)."""
    g = pool.index_select(axis, pt.reshape(-1).long())
    g = g.reshape(pool.shape[:axis] + pt.shape + pool.shape[axis + 1:])
    return g.movedim(axis + 2, axis + 1)


def _paged_dense_state(state):
    """A monolithic decode-state slice from a paged one (page-gathered KV
    and per-block partials, copies) for the backends that want the
    contiguous layout (the dense reference oracle)."""
    out = {k: v for k, v in state.items() if k != "pt"}
    for key in ("k", "v", "hblk", "zblk"):
        out[key] = gather_pages(state[key], state["pt"])
    out["k"] = out["k"].flatten(-3, -2)  # (B, Hkv, Tn * bkv, Dh)
    out["v"] = out["v"].flatten(-3, -2)
    return out


@register_decode_backend("gather")
def _decode_gather_backend(state, qg, qpg, pos, cfg, scale):
    """O(K * bkv * d) sparse + O(K * d^2) subtractive linear per token.

    Paged decode state (`"pt"` present) gathers the SAME K critical blocks
    straight out of the page pools (P, Hkv, ...) through the page table:
    physical ids replace logical ones at the gather and nowhere else (the
    masking keeps the logical LUT), so paged and monolithic outputs are
    bitwise equal."""
    paged = "pt" in state
    kc, vc = state["k"], state["v"]
    bkv = cfg.block_kv
    if paged:
        b, tn = state["pt"].shape
        hkv, d = kc.shape[1], kc.shape[-1]
    else:
        b, hkv, smax, d = kc.shape
        tn = smax // bkv
    dev = kc.device
    lutg = _group_heads(state["lut"], hkv)  # (B, Hkv, G, K)
    cntg = _group_heads(state["cnt"], hkv)  # (B, Hkv, G)
    k_sel = lutg.shape[-1]
    if paged:
        idx = _group_heads(_physical_lut(state["pt"], state["lut"]),
                           hkv).reshape(b, hkv, -1)
        kg = _gather_pool(kc, idx, k_sel)
        vg = _gather_pool(vc, idx, k_sel)
    else:
        idx = lutg.reshape(b, hkv, -1)
        kg = _gather_state(kc.reshape(b, hkv, tn, bkv, d), idx, k_sel)
        vg = _gather_state(vc.reshape(b, hkv, tn, bkv, d), idx, k_sel)
    s = torch.einsum("bngd,bngkvd->bngkv", qg, kg.float()) * scale
    cols = lutg[..., None] * bkv + torch.arange(bkv, device=dev)
    live = torch.arange(k_sel, device=dev) < cntg[..., None]
    ok = (cols <= _pos_view(pos, 5, dev)) & live[..., None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    sf = s.reshape(b, hkv, -1, k_sel * bkv)
    m = sf.amax(dim=-1, keepdim=True)
    p = torch.exp(sf - m)
    o_s = torch.einsum("bngk,bngkd->bngd", p / p.sum(dim=-1, keepdim=True),
                       vg.reshape(b, hkv, -1, k_sel * bkv, d).float())
    gather = _gather_pool if paged else _gather_state
    hg = gather(state["hblk"], idx, k_sel)  # (B, Hkv, G, K, D, D)
    zg = gather(state["zblk"], idx, k_sel)  # (B, Hkv, G, K, D)
    hg = torch.where(live[..., None, None], hg, torch.zeros_like(hg))
    zg = torch.where(live[..., None], zg, torch.zeros_like(zg))
    h_m = state["htot"][:, :, None] - hg.sum(dim=3)
    z_m = state["ztot"][:, :, None] - zg.sum(dim=3)
    num = torch.einsum("bngd,bngde->bnge", qpg, h_m)
    den = torch.einsum("bngd,bngd->bng", qpg, z_m)[..., None]
    o_l = ref._safe_div(num, den)
    # rows with an empty marginal set give exact zeros (the residual of
    # the subtraction is f32 noise; never divide noise by noise)
    margg = _group_heads(state["marg"], hkv)
    o_l = torch.where(margg[..., None] > 0, o_l, torch.zeros_like(o_l))
    return o_s, o_l


@register_decode_backend("kernel")
def _decode_kernel_backend(state, qg, qpg, pos, cfg, scale):
    """The fused CUDA decode kernel (kernels/sla_decode; its plain twin on
    CPU tensors): one launch for the sparse softmax over the LUT blocks
    and the subtractive linear branch."""
    from repro_torch.kernels import sla_decode
    o_s, o_l = sla_decode.decode_attention(
        state, qg[..., None, :], qpg[..., None, :], pos, cfg, scale)
    return o_s[..., 0, :], o_l[..., 0, :]


@register_decode_backend("reference")
def _decode_reference_backend(state, qg, qpg, pos, cfg, scale):
    """Dense O(S) oracle: expands the live row's block structure to a token
    mask and aggregates marginal blocks directly (validation). Paged state
    is made monolithic first (the oracle reads every position anyway)."""
    if "pt" in state:
        state = _paged_dense_state(state)
    kc, vc = state["k"], state["v"]
    b, hkv, smax, d = kc.shape
    bkv = cfg.block_kv
    tn = smax // bkv
    dev = kc.device
    lutg = _group_heads(state["lut"], hkv)
    cntg = _group_heads(state["cnt"], hkv)
    k_sel = lutg.shape[-1]
    live = torch.arange(k_sel, device=dev) < cntg[..., None]
    crit_blk = ((lutg[..., None] == torch.arange(tn, device=dev))
                & live[..., None]).any(dim=3)  # (B, Hkv, G, Tn)
    crit_tok = torch.repeat_interleave(crit_blk, bkv, dim=-1)
    s = torch.einsum("bngd,bnsd->bngs", qg, kc.float()) * scale
    post = _pos_view(pos, 4, dev)
    keep = crit_tok & (torch.arange(smax, device=dev) <= post)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o_s = torch.einsum("bngs,bnsd->bngd", p / p.sum(dim=-1, keepdim=True),
                       vc.float())
    valid = torch.arange(tn, device=dev) <= post // bkv
    marg = (valid & ~crit_blk).float()
    h_m = torch.einsum("bngt,bntde->bngde", marg, state["hblk"])
    z_m = torch.einsum("bngt,bntd->bngd", marg, state["zblk"])
    num = torch.einsum("bngd,bngde->bnge", qpg, h_m)
    den = torch.einsum("bngd,bngd->bng", qpg, z_m)[..., None]
    return o_s, ref._safe_div(num, den)


def decode_execute(state: Dict[str, torch.Tensor], params: Optional[Params],
                   q: torch.Tensor, pos, cfg: SLAConfig,
                   scale: Optional[float] = None,
                   backend: str = "gather") -> torch.Tensor:
    """One-token SLA attention against the decode cache state.

    q: (B, H, 1, D) the new token's query; `pos` its position, a python
    int or an int tensor, scalar (every row shares it) or (B,). Paged
    state holds the page table `pt` (B, Tn) and pools k/v (P, Hkv, bkv,
    D), hblk (P, Hkv, D, D), zblk (P, Hkv, D) in place of the per-slot
    leaves. Returns
    (B, H, D) in q.dtype: O^s + Proj(O^l) under cfg.mode "sla", O^s alone
    under "sparse_only"."""
    backend = resolve_decode(backend)
    cfg.validate()
    in_dtype = q.dtype
    b, h, _, d = q.shape
    hkv = state["k"].shape[1]  # (B, Hkv, ...) or a (P, Hkv, ...) pool
    scale = (d**-0.5) if scale is None else scale
    qg = _group_heads(q[:, :, 0, :].float(), hkv)
    qpg = _group_heads(phi(q[:, :, 0, :], cfg.phi), hkv)
    o_s, o_l = _DECODE_BACKENDS[backend](state, qg, qpg, pos, cfg, scale)
    o_s = o_s.reshape(b, h, d)
    if cfg.mode == "sparse_only":
        return o_s.to(in_dtype)
    if cfg.mode != "sla":
        raise ValueError(
            f"decode_execute supports modes 'sla'/'sparse_only', got "
            f"{cfg.mode!r}")
    proj = params["proj"].float()
    o = o_s + torch.einsum("bhd,hde->bhe", o_l.reshape(b, h, d), proj)
    return o.to(in_dtype)


def decode_partial_execute(state: Dict[str, torch.Tensor], q: torch.Tensor,
                           pos, cfg: SLAConfig,
                           scale: Optional[float] = None,
                           backend: str = "gather") -> torch.Tensor:
    """Kernel 4's partial records of decode tokens over one rank's span of
    a cache whose sequence is split over several ranks
    (`distributed/serving.py`), for `sla_decode.sla_decode_combine`.

    q: (B, H, D) one token's queries, or (B, H, C, D) a chunk's, H a
    multiple of the span's KV heads; `state` holds the span's k, v (B,
    Hkv, S_span, D), hblk (B, Hkv, Tn_span, D, D), zblk (B, Hkv, Tn_span,
    D), and each token's blocks in the span, lut (B, H, K) or (B, H, C, K)
    int32 in the span's own block ids (`sla_decode.span_lut`) with cnt
    (B, H) or (B, H, C); a chunk's state may hold its tokens' diagonal
    partials hdiag (B, Hkv, C, D, D) and zdiag (B, Hkv, C, D). `pos` is
    the (first) token's position less the span's first position, a
    python int or a (B,) tensor (each slot's own). Backend "kernel"
    launches `sla_decode_partial` (its plain twin on CPU tensors),
    "gather" runs the twin's math; "reference" has no partial form and is
    refused. A paged span (one token) holds the span's page table pt
    (B, Tn_span) and the rank's page pools, k/v (P, Hkv, bkv, D), hblk
    (P, Hkv, D, D), zblk (P, Hkv, D), in place of the per-slot leaves:
    kernel 5's partial mode `sla_decode_paged_partial` (or its twin).
    Returns (B, H, 2 D + 3) f32 records (m, l, acc[D], hsel[D], zsel),
    (B, H, C, 2 D + 3) for a chunk."""
    from repro_torch.kernels import sla_decode

    backend = resolve_decode(backend)
    if backend == "reference":
        raise ValueError("the 'reference' decode backend has no partial "
                         "form over a split cache: use 'kernel' or "
                         "'gather'")
    chunk = q.ndim == 4
    qc = q if chunk else q[:, :, None]
    b, h, cdim, d = qc.shape
    hkv = state["k"].shape[1]
    bkv = cfg.block_kv
    k_sel = state["lut"].shape[-1]
    bh = b * h
    scale = (d**-0.5) if scale is None else scale
    if torch.is_tensor(pos):  # each slot's rows at its own position
        posv = pos.to(device=q.device, dtype=torch.int32) \
            .repeat_interleave(h)
    else:
        posv = torch.full((bh,), int(pos), dtype=torch.int32,
                          device=q.device)
    if "pt" in state:
        if cdim != 1:
            raise ValueError(f"the paged partial mode takes one token a "
                             f"row (got a chunk of {cdim})")
        run = (sla_decode.sla_decode_paged_partial if backend == "kernel"
               else sla_decode.sla_decode_paged_partial_plain)
        rec = run(state["lut"].reshape(bh, 1, k_sel).int().contiguous(),
                  state["pt"].int().contiguous(),
                  state["cnt"].reshape(bh, 1).int().contiguous(),
                  posv.contiguous(),
                  qc.float().reshape(bh, 1, d).contiguous(),
                  phi(qc, cfg.phi).float().reshape(bh, 1, d).contiguous(),
                  state["k"], state["v"], state["hblk"], state["zblk"],
                  scale=float(scale), block_kv=bkv, group=h // hkv)
        rec = rec.reshape(b, h, 1, 2 * d + 3)
        return rec if chunk else rec[:, :, 0]
    tn = state["k"].shape[2] // bkv
    hdiag, zdiag = state.get("hdiag"), state.get("zdiag")
    run = (sla_decode.sla_decode_partial if backend == "kernel"
           else sla_decode.sla_decode_partial_plain)
    rec = run(state["lut"].reshape(bh, cdim, k_sel).int().contiguous(),
              state["cnt"].reshape(bh, cdim).int().contiguous(),
              posv.contiguous(),
              qc.float().reshape(bh, cdim, d).contiguous(),
              phi(qc, cfg.phi).float().reshape(bh, cdim, d).contiguous(),
              state["k"].reshape(b * hkv, tn, bkv, d),
              state["v"].reshape(b * hkv, tn, bkv, d),
              state["hblk"].reshape(b * hkv, tn, d, d),
              state["zblk"].reshape(b * hkv, tn, d),
              None if hdiag is None
              else hdiag.reshape(b * hkv, cdim, d, d).contiguous(),
              None if zdiag is None
              else zdiag.reshape(b * hkv, cdim, d).contiguous(),
              scale=float(scale), block_kv=bkv, group=h // hkv)
    rec = rec.reshape(b, h, cdim, 2 * d + 3)
    return rec if chunk else rec[:, :, 0]


def decode_execute_chunk(state: Dict[str, torch.Tensor],
                         params: Optional[Params], q: torch.Tensor, pos,
                         cfg: SLAConfig, scale: Optional[float] = None,
                         backend: str = "gather") -> torch.Tensor:
    """C-token chunked SLA attention against the decode cache state.

    q: (B, H, C, D) chunk queries; `pos` the base position (token c sits
    at pos + c). Unlike the single-token path, `state` carries per-token
    plan rows and linear-state snapshots: lut (B, H, C, K), cnt/marg
    (B, H, C), htot (B, Hkv, C, D, D), ztot (B, Hkv, C, D) and the
    diagonal block's at-time partials hdiag/zdiag of the same shapes (what
    `transformer.decode_chunk` records). One launch of the decode kernel
    (backend "kernel") or one call of its plain math (backends "gather"
    and "reference", as in the reference) covers the chunk. Monolithic
    state only. Returns (B, H, C, D) in q.dtype."""
    from repro_torch.kernels import sla_decode

    backend = resolve_decode(backend)
    cfg.validate()
    in_dtype = q.dtype
    b, h, cdim, d = q.shape
    hkv = state["k"].shape[1]
    scale = (d**-0.5) if scale is None else scale
    qg = _group_heads(q.float(), hkv)
    qpg = _group_heads(phi(q, cfg.phi), hkv)
    if backend == "kernel":
        o_s, o_l = _decode_kernel_backend_chunk(state, qg, qpg, pos, cfg,
                                                scale)
    else:
        posv = torch.broadcast_to(torch.as_tensor(
            pos, dtype=torch.int32, device=q.device), (b,))
        o_s, o_l = sla_decode._decode_math(
            qg, qpg, state["k"], state["v"], state["hblk"], state["zblk"],
            state["hdiag"], state["zdiag"], state["htot"], state["ztot"],
            _group_heads(state["lut"], hkv), _group_heads(state["cnt"], hkv),
            _group_heads(state["marg"], hkv), posv, cfg, scale)
    o_s = o_s.reshape(b, h, cdim, d)
    if cfg.mode == "sparse_only":
        return o_s.to(in_dtype)
    if cfg.mode != "sla":
        raise ValueError(
            f"decode_execute_chunk supports modes 'sla'/'sparse_only', got "
            f"{cfg.mode!r}")
    proj = params["proj"].float()
    o = o_s + torch.einsum("bhcd,hde->bhce", o_l.reshape(b, h, cdim, d),
                           proj)
    return o.to(in_dtype)


def _decode_kernel_backend_chunk(state, qg, qpg, pos, cfg, scale):
    """The fused decode kernel over a chunk's per-token rows (its plain
    twin on CPU tensors): one launch for the whole chunk."""
    from repro_torch.kernels import sla_decode
    return sla_decode.decode_attention(state, qg, qpg, pos, cfg, scale)
