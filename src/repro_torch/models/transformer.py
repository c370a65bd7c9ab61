"""Decoder-only transformer LM (dense family): the part LM serving needs.

Counterpart of `repro.models.transformer`: `init`, `forward` (with plan
reuse and decode-plan seeding), `prefill`, and the dense and decode-time
SLA `decode_step` over a monolithic static cache with one position shared
by the batch. The parameters live in `nn.Module`s in the reference's
layout (`x @ W`, W of shape (in, out)); the reference's layer scan and
`lax.cond`s are Python loops and branches. Caches and plans carry a
leading layer axis, as in the reference.

Decode updates the cache IN PLACE (the reference returns a new cache):
the new token's K/V, the running h/z partials and totals, the pooled
features, and at block boundaries the appended plan row and the live
row. `cache["pos"]` and the decode state's `"rows"` are python ints, so
the boundary work is a host branch, not a select; decode_step returns
the same cache dict, advanced by one token. Not ported yet: MoE FFNs
(ROADMAP.md queue 1, item 13), sliding-window and VLM layers (item 15),
and, for the paged continuous scheduler (item 14), per-slot (B,)
positions, `make_cache`, `insert_slot`, the paged cache, `decode_chunk`
and chunked prefill; each raises and names its item.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import backends as backend_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core.phi import phi
from repro_torch.core.plan import repeat_kv
from repro_torch.models.common import (attention, dense_init, embed_init,
                                       logits_from_hidden, rms_norm, rope)

KIND_SLA, KIND_FULL, KIND_SWA = 0, 1, 2
NEG_INF = masks_lib.NEG_INF
# the weights the reference casts to the compute dtype inside each matmul
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo")


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"item {item})")


def layer_kinds_list(cfg: ArchConfig) -> list:
    """Static per-layer attention kinds."""
    n = cfg.num_layers
    if cfg.local_global_pattern:
        p = cfg.local_global_pattern
        return [KIND_SLA if (i + 1) % p == 0 else KIND_SWA for i in range(n)]
    if cfg.attention_kind == "full":
        return [KIND_FULL] * n
    if cfg.attention_kind == "swa":
        return [KIND_SWA] * n
    return [KIND_SLA] * n


def layer_kinds(cfg: ArchConfig, device=None) -> torch.Tensor:
    return torch.tensor(layer_kinds_list(cfg), dtype=torch.int32,
                        device=device)


class TransformerLayer(nn.Module):
    """One decoder layer's parameters (the reference's `layers` leaves at
    one layer index)."""

    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        if cfg.num_experts:
            raise _not_ported("the MoE FFN", 13)
        d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)

        def dense(i, o):
            return nn.Parameter(dense_init(generator, i, o, dtype, device))

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device))

        self.ln1, self.ln2 = zeros(d), zeros(d)
        self.wq, self.wk = dense(d, h * dh), dense(d, hkv * dh)
        self.wv, self.wo = dense(d, hkv * dh), dense(h * dh, d)
        self.sla_proj = zeros(h, dh, dh)
        if cfg.sla.routing_mode == "learned":
            r = masks_lib.routing_init(h, dh, dtype, device)
            self.routing = nn.ParameterDict(
                {name: nn.Parameter(w) for name, w in r.items()})
        if cfg.qk_norm:
            self.qnorm, self.knorm = zeros(dh), zeros(dh)
        self.mlp_wi = dense(d, 2 * cfg.d_ff)
        self.mlp_wo = dense(cfg.d_ff, d)


class Transformer(nn.Module):
    """The LM's parameters: layers, the embedding table (tied unembedding
    unless cfg.tie_embeddings is off) and the final norm."""

    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            TransformerLayer(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))
        self.embed = nn.Parameter(embed_init(
            generator, cfg.vocab_size, cfg.d_model, dtype, device))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                             device=device))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(embed_init(
                generator, cfg.vocab_size, cfg.d_model, dtype, device))


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         dtype=torch.float32, device=None) -> Transformer:
    """Random LM parameters drawn from `generator` (on the target
    device). Entry point: runs on CUDA unless `device` says otherwise. Not
    bitwise the reference's init; tests carry the reference's weights
    over with `repro_torch.bridge`."""
    if cfg.frontend != "none":
        raise _not_ported(f"the {cfg.frontend!r} frontend", 15)
    return Transformer(cfg, generator, dtype, resolve_device(device))


def compute_params(params: Transformer, dtype=torch.bfloat16):
    """The parameters as the forward reads them in `dtype` compute: the
    matmul weights (MATMUL_WEIGHTS) cast once, everything the reference
    reads in f32 (norms, sla_proj, routing, the embedding table) as it
    is. Casting once equals the reference's per-matmul cast and saves a
    cast of every weight per call. Returns a tree of plain tensors (no
    gradient) that `forward`, `prefill` and `decode_step` read like the
    module."""
    layers = []
    for p in params.layers:
        tree = types.SimpleNamespace(**{
            name: t.detach() for name, t in p.named_parameters(
                recurse=False)})
        for name in MATMUL_WEIGHTS:
            setattr(tree, name, getattr(tree, name).to(dtype))
        if hasattr(p, "routing"):
            tree.routing = {n: w.detach() for n, w in p.routing.items()}
        layers.append(tree)
    return types.SimpleNamespace(
        layers=layers, embed=params.embed.detach(),
        ln_f=params.ln_f.detach(),
        unembed=(params.unembed.detach() if hasattr(params, "unembed")
                 else None))


def _routing(p, cfg) -> Optional[dict]:
    """The layer's learned-routing scorer, or None under threshold
    routing."""
    if cfg.routing_mode != "learned":
        return None
    return dict(p.routing)


# --------------------------------------------------------------------------
# attention sub-block
# --------------------------------------------------------------------------
def _qkv(p, x, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, h, dh).transpose(1, 2)
    k = (x @ p.wk.to(x.dtype)).reshape(b, s, hkv, dh).transpose(1, 2)
    v = (x @ p.wv.to(x.dtype)).reshape(b, s, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p.qnorm)
        k = rms_norm(k, p.knorm)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn(p, x, kind, cfg: ArchConfig, positions, backend, layer_plan=None,
          drift_threshold=None, want_plan=False, decode_plan_cfg=None):
    """Returns (attn_out (B,S,d), k, v, plan, retention, replanned,
    decode_mc). `want_plan` plans inline and returns the plan; a given
    `layer_plan` is reused, refreshed when its drift reaches
    `drift_threshold` (this layer's scalar). `decode_plan_cfg` also
    returns the prompt's decode-grid classification (the rows that seed
    the decode plan)."""
    b, s, _ = x.shape
    dev = x.device
    q, k, v = _qkv(p, x, cfg, positions)
    sla_cfg = cfg.sla
    if cfg.sliding_window:
        sla_cfg = dataclasses.replace(sla_cfg, window=cfg.sliding_window)
    routing = _routing(p, sla_cfg)
    retention = torch.ones((), dtype=torch.float32, device=dev)
    replanned = torch.zeros((), dtype=torch.bool, device=dev)
    decode_mc = None
    if decode_plan_cfg is not None:
        decode_mc = masks_lib.compute_mask(q, repeat_kv(k, q.shape[1]),
                                           decode_plan_cfg, routing=routing)
    if want_plan or layer_plan is not None:
        plan_cfg = dataclasses.replace(sla_cfg, causal=True)
        if layer_plan is None:
            layer_plan = plan_lib.plan_attention(q, k, plan_cfg,
                                                 routing=routing)
        elif drift_threshold is not None:
            layer_plan, retention, replanned = plan_lib.refresh_plan(
                layer_plan, q, k, plan_cfg, drift_threshold,
                routing=routing)
    if kind == KIND_SLA:
        out = attention({"proj": p.sla_proj}, q, k, v, "sla", sla_cfg,
                        causal=True, backend=backend, plan=layer_plan,
                        routing=routing)
    elif kind == KIND_FULL:
        out = attention(None, q, k, v, "full", sla_cfg, causal=True)
    else:
        out = attention(None, q, k, v, "swa", sla_cfg, causal=True)
    out = out.transpose(1, 2).reshape(b, s, -1) @ p.wo.to(x.dtype)
    return out, k, v, layer_plan, retention, replanned, decode_mc


def _ffn(p, x, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.num_experts:
        raise _not_ported("the MoE FFN", 13)
    g, u = (x @ p.mlp_wi.to(x.dtype)).chunk(2, dim=-1)
    out = (F.silu(g) * u) @ p.mlp_wo.to(x.dtype)
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            return_cache: bool = False, plans=None,
            return_plans: bool = False, drift_threshold=None,
            decode_plan_cfg=None, cache_len: Optional[int] = None):
    """Returns hidden states (B, S, d) and the MoE aux loss; optionally the
    per-layer KV cache.

    `return_plans=True` also returns the per-layer SLAPlan stack; pass it
    back as `plans=` on a later same-shape prefill to reuse the block
    structure, with `drift_threshold=` (scalar or per-layer (L,)) to
    refresh drifted layers. `decode_plan_cfg=` also returns the per-layer
    decode-grid classification of the prompt (L, B, H, Tm, Tn) int8.
    `cache_len` (with return_cache) allocates the caches at that length,
    zero past the prompt, as `prefill(decode_max_len=)` needs them.
    Return order: (x, aux[, (k, v)][, plans][, decode_mcs][, drift info]).
    """
    if prefix_embeds is not None:
        raise _not_ported("the VLM prefix embeddings", 15)
    x = params.embed[tokens].to(compute_dtype)
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    kinds = layer_kinds_list(cfg)
    nl = cfg.num_layers
    want_plan = return_plans or plans is not None
    adaptive = drift_threshold is not None and plans is not None
    if adaptive:
        thresholds = torch.broadcast_to(torch.as_tensor(
            drift_threshold, dtype=torch.float32, device=dev), (nl,))
    if return_cache:
        length = max(s, cache_len or s)
        shape = (nl, b, cfg.num_kv_heads, length, cfg.head_dim)
        make = torch.zeros if length > s else torch.empty
        kc = make(shape, dtype=compute_dtype, device=dev)
        vc = make(shape, dtype=compute_dtype, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    out_plans, dmcs, rets, reps = [], [], [], []
    for li, p in enumerate(params.layers):
        given = (None if plans is None
                 else plan_lib.plan_map(lambda leaf: leaf[li], plans))
        a, k, v, layer_plan, ret, rep, dmc = _attn(
            p, rms_norm(x, p.ln1), kinds[li], cfg, positions, backend,
            layer_plan=given,
            drift_threshold=thresholds[li] if adaptive else None,
            want_plan=want_plan, decode_plan_cfg=decode_plan_cfg)
        x = x + a
        f, layer_aux = _ffn(p, rms_norm(x, p.ln2), cfg)
        x = x + f
        aux = aux + layer_aux
        if return_cache:
            kc[li, :, :, :s] = k
            vc[li, :, :, :s] = v
        if return_plans:
            out_plans.append(layer_plan)
        if decode_plan_cfg is not None:
            dmcs.append(dmc)
        if adaptive:
            rets.append(ret)
            reps.append(rep)
        del a, k, v, f  # free this layer's activations before the next
    x = rms_norm(x, params.ln_f)
    result = (x, aux)
    if return_cache:
        result += ((kc, vc),)
    if return_plans:
        result += (plan_lib.plan_map(lambda *ls: torch.stack(ls),
                                     *out_plans),)
    if decode_plan_cfg is not None:
        result += (torch.stack(dmcs),)
    if adaptive:
        result += ({"retention": torch.stack(rets),
                    "replanned": torch.stack(reps)},)
    return result


# --------------------------------------------------------------------------
# serving: prefill + single-token decode over a static-size KV cache
# --------------------------------------------------------------------------
def _seed_decode_state(cfg: ArchConfig, kc, vc, decode_mcs, max_len: int):
    """Decode-SLA state from the prompt caches kc, vc (L, B, Hkv, S, Dh)
    and the decode-grid classification of the prompt rows decode_mcs
    (L, B, H, Tm_p, Tn_p): the static-grid incremental plan, the per-block
    h_j = sum phi(k) v^T and z_j = sum phi(k) partials with their running
    totals, and the pooled-k sums. Built one layer at a time, so the f32
    phi(k) and v temporaries hold one layer."""
    sla = cfg.sla
    bq, bkv = sla.block_q, sla.block_kv
    nl, b, hkv, s, dh = kc.shape
    dev = kc.device
    tn = max_len // bkv
    tm_p, tn_p = s // bq, s // bkv
    dcfg = sla.decode_plan_cfg(tn)
    f32 = dict(dtype=torch.float32, device=dev)
    hblk = torch.zeros((nl, b, hkv, tn, dh, dh), **f32)
    zblk = torch.zeros((nl, b, hkv, tn, dh), **f32)
    kpool = torch.zeros((nl, b, hkv, tn, dh), **f32)
    plans = []
    for li in range(nl):
        kpb = phi(kc[li], sla.phi).reshape(b, hkv, tn_p, bkv, dh)
        vb = vc[li].float().reshape(b, hkv, tn_p, bkv, dh)
        hblk[li, :, :, :tn_p] = torch.matmul(kpb.transpose(-1, -2), vb)
        zblk[li, :, :, :tn_p] = kpb.sum(dim=-2)
        kpool[li, :, :, :tn_p] = kc[li].float().reshape(
            b, hkv, tn_p, bkv, dh).sum(dim=-2)
        del kpb, vb
        mc = torch.full((b, cfg.num_heads, tn, tn), -1, dtype=torch.int8,
                        device=dev)
        mc[..., :tm_p, :tn_p] = decode_mcs[li]
        # col_width=1: decode never runs the dK/dV backward, so the plan
        # skips the O(Tn^2)-per-head column LUT
        plans.append(plan_lib.plan_from_mask(mc, dcfg, col_width=1))
    k_sel = dcfg.num_critical(tn)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "hblk": hblk, "zblk": zblk,
        "htot": hblk.sum(dim=3), "ztot": zblk.sum(dim=3),
        "kpool": kpool,
        "qpool": torch.zeros((nl, b, cfg.num_heads, dh), **f32),
        "plan": plan_lib.plan_map(lambda *ls: torch.stack(ls), *plans),
        "rows": tm_p,
        "live_lut": torch.zeros((nl, b, cfg.num_heads, k_sel), **i32),
        "live_cnt": torch.zeros((nl, b, cfg.num_heads), **i32),
        "live_marg": torch.zeros((nl, b, cfg.num_heads), **i32),
        "extends": torch.zeros((nl,), **i32),
        "replans": torch.zeros((nl,), **i32),
        "reuses": torch.zeros((nl,), **i32),
        "retention": torch.ones((nl,), **f32),
    }


def _check_decode_grid(cfg: ArchConfig, seq_len: int, max_len: int):
    sla = cfg.sla
    if sla.block_q != sla.block_kv:
        raise ValueError("decode-time SLA requires block_q == block_kv")
    if sla.window or cfg.sliding_window:
        # the subtractive linear state cannot exclude out-of-window past
        # blocks, so decode would diverge from the windowed prefill
        raise ValueError(
            "decode-time SLA does not support window-constrained SLA "
            "layers (SLAConfig.window / cfg.sliding_window); use dense "
            "decode for sliding-window configs")
    if seq_len % sla.block_q or max_len % sla.block_q:
        raise ValueError(
            f"decode-time SLA needs block-aligned lengths: prompt "
            f"{seq_len} and max_len {max_len} must be multiples of "
            f"sla.block_q={sla.block_q}")


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            plans=None, drift_threshold=None, return_plans: bool = False,
            decode_max_len: Optional[int] = None):
    """Run the prompt; returns (last_hidden (B, d), cache dict).

    `return_plans=True` also returns the per-layer SLAPlan stack; pass it
    back as `plans=` (with `drift_threshold=`) on the next same-shape
    prefill. `decode_max_len=` sizes a static decode block grid, makes
    the KV caches that long, and seeds the cache with the incremental
    decode plan and the linear branch's running H/Z state, so that
    `decode_step` runs decode-time SLA. Return order: (last_hidden,
    cache[, plans][, drift info]); cache["pos"] is the prompt length."""
    dcfg = None
    s = tokens.shape[1]
    if decode_max_len is not None:
        _check_decode_grid(cfg, s, decode_max_len)
        dcfg = cfg.sla.decode_plan_cfg(decode_max_len // cfg.sla.block_kv)
    out = forward(params, cfg, tokens, compute_dtype=compute_dtype,
                  backend=backend, return_cache=True, plans=plans,
                  return_plans=return_plans,
                  drift_threshold=drift_threshold, decode_plan_cfg=dcfg,
                  cache_len=decode_max_len)
    x, (kc, vc) = out[0], out[2]
    extras = list(out[3:])
    cache = {"k": kc, "v": vc, "pos": s}
    if decode_max_len is not None:
        decode_mcs = extras.pop(1 if return_plans else 0)
        cache["sla"] = _seed_decode_state(cfg, kc[..., :s, :],
                                          vc[..., :s, :], decode_mcs,
                                          decode_max_len)
    return (x[:, -1], cache) + tuple(extras)


def _scalar_pos(pos) -> int:
    if torch.is_tensor(pos) and pos.ndim > 0:
        raise _not_ported("decode with per-slot (B,) positions (the "
                          "continuous scheduler)", 14)
    return int(pos)


def _dense_decode_attn(q, kc, vc, pos: int, kind, cfg: ArchConfig):
    """Masked softmax over the full static cache, O(S) per token. q:
    (B, H, 1, Dh); kc, vc: (B, Hkv, Smax, Dh). GQA folds the head group
    into the query. Returns (B, 1, H * Dh) in q.dtype."""
    if kind == KIND_SWA:
        raise _not_ported("sliding-window decode attention", 15)
    b, h = q.shape[0], q.shape[1]
    hkv, smax = kc.shape[1], kc.shape[2]
    qg = q[:, :, 0, :].reshape(b, hkv, h // hkv, cfg.head_dim)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), kc.float()) \
        * (cfg.head_dim**-0.5)
    ok = torch.arange(smax, device=q.device) <= pos
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, dim=-1),
                     vc.float())
    return o.to(q.dtype).reshape(b, 1, h * cfg.head_dim)


def _cache_write(c, new, pos: int):
    """Write one new token's KV at `pos`, in place: c (B, Hn, S, D), new
    (B, Hn, 1, D)."""
    c[:, :, pos] = new[:, :, 0].to(c.dtype)


def _blk_update(buf, upd, row: int):
    """Add `upd` (B, Hn, ...) into block `row` of a per-block running
    buffer (B, Hn, Tn, ...), in place."""
    buf[:, :, row] += upd


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                compute_dtype=torch.bfloat16, backend: str = "gather",
                drift_threshold=None):
    """One decode step. token: (B,) int; cache k/v: (L, B, Hkv, S, Dh);
    cache["pos"] the position shared by the batch. Caches made with
    `prefill(decode_max_len=)` carry decode-SLA state and run SLA decode
    (`_decode_step_sla`); otherwise dense masked attention over the full
    static cache. Writes the new token into the cache in place and
    returns (logits (B, V) f32, cache) with cache["pos"] advanced."""
    if "kp" in cache:
        raise _not_ported("the paged KV cache", 14)
    if "sla" in cache:
        return _decode_step_sla(params, cfg, token, cache, compute_dtype,
                                backend, drift_threshold)
    pos = _scalar_pos(cache["pos"])
    x = params.embed[token[:, None]].to(compute_dtype)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, device=x.device)
    kinds = layer_kinds_list(cfg)
    for li, p in enumerate(params.layers):
        q, k_new, v_new = _qkv(p, rms_norm(x, p.ln1), cfg, positions)
        kc, vc = cache["k"][li], cache["v"][li]
        _cache_write(kc, k_new, pos)
        _cache_write(vc, v_new, pos)
        o = _dense_decode_attn(q, kc, vc, pos, kinds[li], cfg)
        x = x + o @ p.wo.to(x.dtype)
        f, _ = _ffn(p, rms_norm(x, p.ln2), cfg)
        x = x + f
    x = rms_norm(x, params.ln_f)
    cache["pos"] = pos + 1
    return logits_from_hidden(params, x[:, 0]), cache


def _decode_step_sla(params, cfg: ArchConfig, token, cache, compute_dtype,
                     backend: str, drift_threshold=None):
    """Decode-time SLA step.

    Per token: the O(1) running-state update (phi(k) v^T into the current
    block's h/z partials and the totals), then attention over the live
    row's critical KV blocks plus the subtractive linear branch. At a
    block boundary (pos % b_q == 0) the just-completed row is classified
    from its pooled q and appended with `plan_extend`, and each layer
    decides for the new live row: inherit the previous row's critical set
    (plus the forced diagonal; "reuse") unless its drift against a fresh
    classification from this token's q reaches the layer's threshold
    ("replan"). The boundary work runs only at boundaries (a host
    branch); the reference computes it every step and selects, with the
    same result.
    """
    backend_lib.resolve_decode(backend)
    pos = _scalar_pos(cache["pos"])
    st = cache["sla"]
    sla = cfg.sla
    bq, bkv = sla.block_q, sla.block_kv
    x = params.embed[token[:, None]].to(compute_dtype)
    b, dev = x.shape[0], x.device
    tn = cache["k"].shape[-2] // bkv
    dcfg = sla.decode_plan_cfg(tn)
    kinds = layer_kinds_list(cfg)
    nl = cfg.num_layers
    if drift_threshold is None:
        drift_threshold = sla.drift_thresholds(nl)
    # host floats: a per-step host-to-device copy would sync the stream
    thresholds = torch.broadcast_to(torch.as_tensor(
        drift_threshold, dtype=torch.float32), (nl,)).tolist()
    row = pos // bq                     # the current (partial) query row
    boundary = pos % bq == 0            # a block was just completed
    append = boundary and st["rows"] < row
    positions = torch.full((b, 1), pos, device=dev)
    if boundary:
        # tokens per KV block after this step's write (pooled-k means)
        blk = torch.arange(tn, device=dev)
        blk_cnt = torch.clamp(torch.clamp((pos + 1) - blk * bkv, max=bkv),
                              1, bkv)[:, None].float()
    plan = st["plan"]
    for li, p in enumerate(params.layers):
        q, k_new, v_new = _qkv(p, rms_norm(x, p.ln1), cfg, positions)
        kc, vc = cache["k"][li], cache["v"][li]
        _cache_write(kc, k_new, pos)
        _cache_write(vc, v_new, pos)
        h, hkv = q.shape[1], k_new.shape[1]
        g = h // hkv
        qf = q[:, :, 0, :].float()       # (B, H, D)
        kf = k_new[:, :, 0, :].float()   # (B, Hkv, D)
        vf = v_new[:, :, 0, :].float()
        routing = _routing(p, dcfg)
        lplan = plan_lib.plan_map(lambda leaf: leaf[li], plan)  # views
        hb, zb = st["hblk"][li], st["zblk"][li]
        ht, zt = st["htot"][li], st["ztot"][li]
        kp_sum, qp_sum = st["kpool"][li], st["qpool"][li]

        # 1. append the just-completed row (its pooled k excludes the
        # current block's new token)
        if append:
            kpm = torch.repeat_interleave(kp_sum / bkv, g, dim=1)
            pc_prev = masks_lib.score_row(routing, qp_sum / bq, kpm,
                                          row - 1, dcfg)
            plan_lib.plan_extend(
                lplan, masks_lib.classify_row(pc_prev, row - 1, dcfg),
                row - 1)
            st["extends"][li] += 1

        # 2. O(1) running-state update for the new token
        phik = phi(kf, sla.phi)          # (B, Hkv, D) f32
        hupd = phik[..., :, None] * vf[..., None, :]
        _blk_update(hb, hupd, row)
        _blk_update(zb, phik, row)
        _blk_update(kp_sum, kf, row)
        ht += hupd
        zt += phik

        # 3. the new live row's structure, drift-gated per layer
        if boundary:
            kpm_live = torch.repeat_interleave(kp_sum / blk_cnt, g, dim=1)
            pc_live = masks_lib.score_row(routing, qf, kpm_live, row, dcfg)
            mc_fresh = masks_lib.classify_row(pc_live, row, dcfg)
            mc_inh = lplan.mc[..., row - 1, :].clone()  # (B, H, Tn)
            mc_inh[..., row] = 1
            stale = (pc_live * (mc_inh == 1)).sum(dim=-1)
            fresh = (pc_live * (mc_fresh == 1)).sum(dim=-1)
            r = torch.clamp(stale / torch.clamp(fresh, min=plan_lib.EPS),
                            0.0, 1.0)
            retention = r.min()
            thr = thresholds[li]
            replan = (1.0 - retention) >= thr
            if thr >= 1.0:  # a threshold of 1.0 never re-plans
                replan = torch.zeros_like(replan)
            mc_live = torch.where(replan, mc_fresh, mc_inh)
            lut_n, cnt_n = plan_lib.build_lut(mc_live[..., None, :],
                                              lplan.k_sel)
            st["live_lut"][li] = lut_n[..., 0, :]
            st["live_cnt"][li] = cnt_n[..., 0]
            st["live_marg"][li] = (mc_live == 0).sum(dim=-1,
                                                     dtype=torch.int32)
            st["replans"][li] += replan.to(torch.int32)
            st["reuses"][li] += (~replan).to(torch.int32)
            st["retention"][li] = retention
            qp_sum.copy_(qf)
        else:
            qp_sum += qf

        # 4. attention: critical blocks + the O(1) linear state
        if kinds[li] == KIND_SLA:
            state = {"k": kc, "v": vc, "hblk": hb, "zblk": zb, "htot": ht,
                     "ztot": zt, "lut": st["live_lut"][li],
                     "cnt": st["live_cnt"][li], "marg": st["live_marg"][li]}
            o = backend_lib.decode_execute(
                state, {"proj": p.sla_proj}, q, pos, dcfg, backend=backend)
            o = o.reshape(b, 1, h * cfg.head_dim).to(x.dtype)
        else:
            o = _dense_decode_attn(q, kc, vc, pos, kinds[li], cfg)
        x = x + o @ p.wo.to(x.dtype)
        f, _ = _ffn(p, rms_norm(x, p.ln2), cfg)
        x = x + f
    if append:
        st["rows"] += 1
    x = rms_norm(x, params.ln_f)
    cache["pos"] = pos + 1
    return logits_from_hidden(params, x[:, 0]), cache


def _item14(what: str):
    def fn(*args, **kwargs):
        raise _not_ported(what, 14)
    fn.__name__ = what
    fn.__doc__ = f"`{what}` of the reference; raises until item 14."
    return fn


make_cache = _item14("make_cache")
insert_slot = _item14("insert_slot")
decode_chunk = _item14("decode_chunk")
prefill_chunk = _item14("prefill_chunk")
