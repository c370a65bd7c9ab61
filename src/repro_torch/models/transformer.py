"""Decoder-only transformer LM (dense, MoE and VLM families).

Counterpart of `repro.models.transformer`: `init`, `forward` (with plan
reuse, decode-plan seeding and per-layer remat), the training losses
`loss_fn` and `distill_loss_fn`, `prefill`, the dense and decode-time SLA
`decode_step`, and the decode caches of serving: the monolithic static
cache with one position shared by the batch, the per-slot cache of
continuous batching (`make_cache(per_slot=True)`, `insert_slot`), and
the paged, prefix-shared cache (`make_paged_cache`, `insert_slot_paged`,
`insert_slot_state_paged`, `slot_state_from_prefill`, `copy_page`,
`paged_dense_view`). The parameters live in `nn.Module`s in the
reference's layout (`x @ W`, W of shape (in, out)); the reference's layer
scan and `lax.cond`s are Python loops and branches. Caches and plans
carry a leading layer axis, as in the reference.

Decode updates the cache IN PLACE (the reference returns a new cache):
the new token's K/V, the running h/z partials and totals, the pooled
features, and at block boundaries the appended plan row and the live
row. A static cache's `pos` and decode-state `rows` are python ints; a
per-slot cache keeps `pos` as a (B,) device tensor advanced in place with
its host mirror `pos_host`, so the boundary work is a host branch (run
for the whole batch when any slot is at a boundary, selected per slot),
not a select, and no step syncs the stream. decode_step returns the same
cache dict, advanced by one token. Chunked admission prefill
(`prefill_chunk` over a carry, `finalize_chunked_prefill`) and
verify-style multi-token decode (`decode_chunk`) update their carry and
cache in place too. An MoE layer (`cfg.num_experts`) holds its FFN in a
`moe` submodule (`models/moe.py`) in place of `mlp_wi` / `mlp_wo`.
Sliding-window layers (gemma3's local layers) attend a block-granular
band in the forward (`common._swa_attention`) and a token-level window
in dense decode, as the reference's. The VLM family prepends patch
embeddings to the tokens (`forward(prefix_embeds=)`).

Over a ("data", "model") mesh (`distributed.ctx.activation_sharding`)
`forward`, `prefill`, `make_cache`, `insert_slot`, `decode_step` and
`decode_chunk` serve, dense and decode-time SLA, per-slot positions and
learned routing included: each rank's caches, and its part of the
decode-SLA state, are its part under `sharding.cache_shardings`, and
decode attends by that layout (`distributed/serving.py`; over a split
sequence through kernel 4's partial records and a combine across ranks).
Paged caches serve there too (`make_paged_cache`, `insert_slot_paged`,
`set_page_table`, `copy_page`, `paged_dense_view`): each rank's pools
hold the pages of its part of the per-slot cache they stand for, at the
global page ids, and a split sequence attends through kernel 5's
partial mode; chunked
admission (`make_prefill_carry`, `prefill_chunk`,
`finalize_chunked_prefill`) follows the sharded prefill's scheme on a
carry each rank holds whole over the bucket; `snapshot_slots` /
`restore_slots` copy and restore a rank's part.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import types
from typing import Optional, Tuple

import numpy as np
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
from repro_torch.distributed import ctx
from repro_torch.distributed import serving
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (attention, chunked_softmax_xent,
                                       dense_init, embed_init,
                                       local_kv_heads, logits_from_hidden,
                                       mse_loss, output_table, qkv_heads,
                                       rms_norm, rope)

KIND_SLA, KIND_FULL, KIND_SWA = 0, 1, 2
NEG_INF = masks_lib.NEG_INF
# the weights the reference casts to the compute dtype inside each matmul:
# a layer's own (the dense FFN's where it has one), then its MoE FFN's
# experts; the MoE router is read in f32
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo")
MOE_MATMUL_WEIGHTS = ("wi", "wo", "shared_wi", "shared_wo")


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
        if cfg.num_experts:
            self.moe = moe_lib.moe_init(generator, cfg, dtype, device)
        else:
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
    over with `repro_torch.bridge`. The VLM family's vision frontend is
    a stub, as the reference's: it has no parameters, and its patch
    embeddings arrive as `forward(prefix_embeds=)`."""
    return Transformer(cfg, generator, dtype, resolve_device(device))


def compute_params(params: Transformer, dtype=torch.bfloat16):
    """The parameters as the forward reads them in `dtype` compute: the
    matmul weights (MATMUL_WEIGHTS, and an MoE layer's expert weights
    MOE_MATMUL_WEIGHTS) cast once, everything the reference reads in f32
    (norms, sla_proj, routing, the MoE router, the embedding table) as it
    is. Casting once equals the reference's per-matmul cast and saves a
    cast of every weight per call. Returns a tree of plain tensors (no
    gradient) that `forward`, `prefill` and `decode_step` read like the
    module."""
    def cast(module, names):
        tree = types.SimpleNamespace(**{
            name: t.detach() for name, t in module.named_parameters(
                recurse=False)})
        for name in names:
            if hasattr(tree, name):
                setattr(tree, name, getattr(tree, name).to(dtype))
        return tree

    layers = []
    for p in params.layers:
        tree = cast(p, MATMUL_WEIGHTS)
        if hasattr(p, "routing"):
            tree.routing = {n: w.detach() for n, w in p.routing.items()}
        if hasattr(p, "moe"):
            tree.moe = cast(p.moe, MOE_MATMUL_WEIGHTS)
        layers.append(tree)
    return types.SimpleNamespace(
        layers=layers, embed=params.embed.detach(),
        ln_f=params.ln_f.detach(),
        unembed=(params.unembed.detach() if hasattr(params, "unembed")
                 else None))


def _routing(p, cfg, every: bool = False) -> Optional[dict]:
    """The layer's learned-routing scorer (this rank's heads of it under a
    mesh; every head with `every`, as decode scores every head's row), or
    None under threshold routing."""
    if cfg.routing_mode != "learned":
        return None
    return {n: ctx.fsdp_gather(w, "rep" if every else "row")
            for n, w in p.routing.items()}


# --------------------------------------------------------------------------
# attention sub-block
# --------------------------------------------------------------------------
def _qkv(p, x, cfg: ArchConfig, positions):
    """q, k, v (B, H, S, Dh) with rope. Under a mesh, this "model" rank's
    query heads and the KV heads projected (`common.qkv_heads(pick=
    False)`): its own where "model" divides them, else all of them, the
    heads a KV cache holds; `_attn` picks each query head's."""
    q, k, v = qkv_heads(x, x, p.wq, p.wk, p.wv, cfg, pick=False)
    if cfg.qk_norm:
        q = rms_norm(q, ctx.fsdp_gather(p.qnorm, "tp"))
        k = rms_norm(k, ctx.fsdp_gather(p.knorm, "tp"))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _plan_layer(q, k, sla_cfg, routing, layer_plan, drift_threshold,
                plan: bool, decode_plan_cfg) -> dict:
    """One layer's block structure: {"plan", "retention", "replanned",
    "decode_mc"}. `plan` plans inline when no `layer_plan` is given; a
    given one is reused, refreshed when its drift reaches
    `drift_threshold` (this layer's scalar). `decode_plan_cfg` also
    classifies the prompt on the decode grid (the rows that seed the
    decode plan)."""
    dev = q.device
    out = dict(retention=torch.ones((), dtype=torch.float32, device=dev),
               replanned=torch.zeros((), dtype=torch.bool, device=dev),
               decode_mc=None, plan=layer_plan)
    if decode_plan_cfg is not None:
        out["decode_mc"] = masks_lib.compute_mask(
            q, repeat_kv(k, q.shape[1]), decode_plan_cfg, routing=routing)
    plan_cfg = dataclasses.replace(sla_cfg, causal=True)
    if layer_plan is None and plan:
        out["plan"] = plan_lib.plan_attention(q, k, plan_cfg,
                                              routing=routing)
    elif layer_plan is not None and drift_threshold is not None:
        out["plan"], out["retention"], out["replanned"] = \
            plan_lib.refresh_plan(layer_plan, q, k, plan_cfg,
                                  drift_threshold, routing=routing)
    return out


def _attn(p, x, kind, cfg: ArchConfig, positions, backend, kept: dict,
          layer_plan=None, drift_threshold=None, want_plan=False,
          decode_plan_cfg=None) -> torch.Tensor:
    """Returns the attention block's output (B, S, d). Its first call (an
    empty `kept`) builds the layer's block structure (`_plan_layer`: an
    SLA layer's plan whenever `want_plan` or its mode needs one) and keeps
    it in `kept` with the layer's k and v; a rematerializing recompute
    finds it there and attends over the same blocks without planning
    again. Under context parallelism q, k and v are gathered to the whole
    sequence first, so planning ranks every query row, and this rank
    keeps its own rows of the output. `kept` gets k and v at the heads a
    KV cache holds (before `local_kv_heads` picks each query head's)."""
    b, s, _ = x.shape
    x = ctx.to_tp(x)
    q, kw, vw = (ctx.gather_seq(t, 2) for t in _qkv(p, x, cfg, positions))
    k = local_kv_heads(kw, cfg.num_heads, cfg.num_kv_heads)
    v = local_kv_heads(vw, cfg.num_heads, cfg.num_kv_heads)
    sla_cfg = cfg.sla
    if cfg.sliding_window:
        sla_cfg = dataclasses.replace(sla_cfg, window=cfg.sliding_window)
    routing = _routing(p, sla_cfg)
    if "plan" not in kept:
        plan_needed = kind == KIND_SLA and sla_cfg.mode not in (
            "full", "linear_only")
        # Tensors the planning ops save for the backward (the learned
        # router's straight-through gates) stay out of a remat checkpoint,
        # whose recompute does not plan again.
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: t.detach(), lambda t: t):
            kept.update(_plan_layer(q, k, sla_cfg, routing, layer_plan,
                                    drift_threshold,
                                    want_plan or plan_needed,
                                    decode_plan_cfg))
        kept["k"], kept["v"] = kw, vw
    layer_plan = kept["plan"]
    if kind == KIND_SLA:
        out = attention({"proj": ctx.fsdp_gather(p.sla_proj, "row")}, q, k,
                        v, "sla", sla_cfg, causal=True, backend=backend,
                        plan=layer_plan, routing=routing)
    elif kind == KIND_FULL:
        out = attention(None, q, k, v, "full", sla_cfg, causal=True)
    else:
        out = attention(None, q, k, v, "swa", sla_cfg,
                        window=cfg.local_window or cfg.sliding_window,
                        causal=True)
    out = ctx.seq_rows(out, dim=2)
    return ctx.from_tp(out.transpose(1, 2).reshape(b, s, -1)
                       @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))


def _ffn(p, x, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.num_experts:
        return moe_lib.moe_apply(p.moe, x, cfg)
    x = ctx.to_tp(x)
    g, u = (x @ ctx.fsdp_gather(p.mlp_wi, "col", chunks=2).to(x.dtype)) \
        .chunk(2, dim=-1)
    out = ctx.from_tp((F.silu(g) * u)
                      @ ctx.fsdp_gather(p.mlp_wo, "row").to(x.dtype))
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _kv_cache(cfg: ArchConfig, global_batch: int, length: int, dtype,
              device, zeros: bool):
    """Empty K and V caches (L, B, Hkv, length, Dh) and this rank's span
    of their positions (first, count). Under a mesh they are this rank's
    part under the rules, allocated at that shape only: its batch rows,
    its KV heads (or all of them), its span of the positions."""
    shape = (cfg.num_layers, global_batch, cfg.num_kv_heads, length,
             cfg.head_dim)
    span = (0, length)
    kl = serving.active_kv_layout(global_batch, cfg.num_kv_heads)
    if kl is not None:
        kl.check_length(length)
        shape, span = kl.local_shape(shape), kl.span(length)
    make = torch.zeros if zeros else torch.empty
    return (make(shape, dtype=dtype, device=device),
            make(shape, dtype=dtype, device=device), span)


def forward(params, cfg: ArchConfig, tokens: Optional[torch.Tensor],
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

    VLM: `prefix_embeds` (B, P, d) are prepended to the token embeddings
    in the compute dtype and share the rope positions (0 .. P + S - 1);
    `tokens` may then be None.

    Under `distributed.ctx.activation_sharding(remat=True)` with autograd
    recording, each layer is rematerialized (`ctx.maybe_remat`, the
    reference's remat of its layer scan); its block structure is built
    once, outside the recompute.

    Under `activation_sharding(mesh, ...)` the batch is the global one:
    this rank keeps its rows of it (data parallelism) or of the sequence
    (context parallelism, after the prefix is prepended, with global rope
    positions), and the hidden states returned are those rows; an MoE
    layer runs its experts over "model" (`models/moe.py`). The caches are
    this rank's part under `sharding.cache_shardings` (`_kv_cache`): its
    batch rows, its KV heads or all of them, its span of the positions.
    `decode_plan_cfg=` classifies this rank's query heads over the whole
    prompt (its batch rows). The plans are this rank's part of the stack,
    as the DiT's (`models.dit.forward`): leaves (L, B_local, H_local,
    ...) over the whole prompt's block grid, B_local its batch rows (the
    whole batch under context parallelism) and H_local its query heads;
    `plans=` takes that part (anything else raises a ValueError naming
    the expected shape), and the drift gate's MIN crosses the ranks that
    hold the rest of the batch and heads (`core.plan.refresh_plan`), so
    the info holds the global decisions.
    """
    global_batch = (tokens if tokens is not None else prefix_embeds).shape[0]
    tokens = ctx.batch_rows(tokens)
    prefix_embeds = ctx.batch_rows(prefix_embeds)
    parts = []
    if prefix_embeds is not None:
        parts.append(prefix_embeds.to(compute_dtype))
    if tokens is not None:
        parts.append(ctx.vocab_lookup(tokens, params.embed)
                     .to(compute_dtype))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    s_all = x.shape[1]
    start, _ = ctx.seq_span(s_all)
    x = ctx.seq_rows(x)
    b, s, _ = x.shape
    dev = x.device
    positions = (torch.arange(start, start + s, device=dev) if start
                 else torch.arange(s, device=dev))[None, :].expand(b, s)
    kinds = layer_kinds_list(cfg)
    nl = cfg.num_layers
    if plans is not None:
        _, m = ctx.model_rank_size()
        plan_lib.check_stack(plans, nl, b, cfg.num_heads // m,
                             s_all // cfg.sla.block_q,
                             s_all // cfg.sla.block_kv)
    want_plan = return_plans or plans is not None
    adaptive = drift_threshold is not None and plans is not None
    if adaptive:
        thresholds = torch.broadcast_to(torch.as_tensor(
            drift_threshold, dtype=torch.float32, device=dev), (nl,))
    if return_cache:
        length = max(s_all, cache_len or s_all)
        kc, vc, (lo, span) = _kv_cache(cfg, global_batch, length,
                                       compute_dtype, dev,
                                       zeros=length > s_all)
        # the prompt's positions in this rank's span
        written = min(span, max(0, s_all - lo))

    def layer(x, p, kind, given, thr, kept):
        a = _attn(p, rms_norm(x, ctx.fsdp_gather(p.ln1, "rep")), kind, cfg,
                  positions, backend, kept, layer_plan=given,
                  drift_threshold=thr, want_plan=want_plan,
                  decode_plan_cfg=decode_plan_cfg)
        x = ctx.shard_residual(x + a)
        f, layer_aux = _ffn(p, rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")),
                            cfg)
        return ctx.shard_residual(x + f), layer_aux

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    out_plans, dmcs, rets, reps = [], [], [], []
    for li, p in enumerate(params.layers):
        given = (None if plans is None
                 else plan_lib.plan_map(lambda leaf: leaf[li], plans))
        kept = {}
        x, layer_aux = ctx.maybe_remat(functools.partial(
            layer, p=p, kind=kinds[li], given=given,
            thr=thresholds[li] if adaptive else None, kept=kept))(x)
        aux = aux + layer_aux
        # popped: a remat checkpoint holds `kept` until the backward
        k, v = kept.pop("k"), kept.pop("v")
        if return_cache and written:
            kc[li, :, :, :written] = k[:, :, lo:lo + written]
            vc[li, :, :, :written] = v[:, :, lo:lo + written]
        if return_plans:
            out_plans.append(kept["plan"])
        if decode_plan_cfg is not None:
            dmcs.append(kept["decode_mc"])
        if adaptive:
            rets.append(kept["retention"])
            reps.append(kept["replanned"])
        del k, v  # free this layer's k and v before the next
    x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
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


def loss_fn(params, cfg: ArchConfig, batch: dict,
            compute_dtype=torch.bfloat16, backend: str = "gather"
            ) -> torch.Tensor:
    """Next-token cross-entropy over the `unembed` table (the tied `embed`
    without one), plus 0.01 x the MoE aux loss. batch: `tokens`,
    `targets` (B, S) integer tensors, an optional `mask` and, for the
    VLM family, `patch_embeds` (B, P, d), whose P hidden rows the loss
    leaves out. `params` is
    the Transformer module or a tree of its tensors with the same
    attributes (`launch.steps.cast_params_bf16`). Under a mesh the batch
    is the global one and the loss the global mean: each rank scores its
    own rows (`forward`), the sums and the row count are summed over the
    data ranks."""
    prefix = batch.get("patch_embeds")
    x, aux = forward(params, cfg, batch["tokens"], prefix_embeds=prefix,
                     compute_dtype=compute_dtype, backend=backend)
    targets = ctx.batch_rows(batch["targets"])
    mask = ctx.batch_rows(batch.get("mask"))
    npre = 0 if prefix is None else prefix.shape[1]
    start, rows = ctx.seq_span(npre + targets.shape[1])
    if rows == npre + targets.shape[1]:
        if prefix is not None:
            x = x[:, npre:]
    else:
        # context parallelism: this rank's rows of [prefix; tokens], the
        # prefix's rows (if any are here) masked out
        g = torch.arange(start - npre, start - npre + rows,
                         device=x.device)
        idx = torch.clamp(g, min=0)
        keep = (g >= 0).to(torch.float32)[None, :].expand(x.shape[0], rows)
        mask = keep if mask is None else keep * mask[:, idx].float()
        targets = targets[:, idx]
    loss = chunked_softmax_xent(x, output_table(params), targets, mask)
    return loss + 0.01 * aux


def distill_loss_fn(params, cfg: ArchConfig, batch: dict,
                    compute_dtype=torch.bfloat16, backend: str = "gather"
                    ) -> torch.Tensor:
    """End-to-end distillation (the paper's fine-tuning objective, Sec.
    5): MSE between the SLA student's final hidden states and an
    exact-attention teacher running the same params, plus 0.01 x the
    student's MoE aux loss. The teacher (`mode="full"`, threshold
    routing) runs under `torch.no_grad()`, the reference's
    stop_gradient. Routing parameters get their straight-through
    gradients only on the autodiff backends ("gather", "reference"): the
    kernel backend treats the plan as a constant."""
    tcfg = dataclasses.replace(
        cfg, sla=cfg.sla.replace(mode="full", routing_mode="threshold"))
    with torch.no_grad():
        x_t, _ = forward(params, tcfg, batch["tokens"],
                         prefix_embeds=batch.get("patch_embeds"),
                         compute_dtype=compute_dtype, backend=backend)
    x_s, aux = forward(params, cfg, batch["tokens"],
                       prefix_embeds=batch.get("patch_embeds"),
                       compute_dtype=compute_dtype, backend=backend)
    return mse_loss(x_s, x_t) + 0.01 * aux


# --------------------------------------------------------------------------
# serving: prefill + single-token decode over a static-size KV cache
# --------------------------------------------------------------------------
def decode_state_shapes(cfg: ArchConfig, batch: int, max_len: int,
                        per_slot: bool = False, pooled: bool = False
                        ) -> dict:
    """{name: global shape} of the decode-SLA state's tensors (the plan's
    fields as "plan/<field>"; `rows` is a host int and not among them) for
    `batch` rows and a `max_len`-position grid: per-slot counters with
    `per_slot`, no per-block leaves where `pooled` page pools hold them."""
    sla = cfg.sla
    nl, hkv, dh, nh = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                       cfg.num_heads)
    tn = max_len // sla.block_kv
    k_sel = sla.decode_plan_cfg(tn).num_critical(tn)
    lead = (nl, batch, nh)
    counters = (nl, batch) if per_slot else (nl,)
    out = {} if pooled else {"hblk": (nl, batch, hkv, tn, dh, dh),
                             "zblk": (nl, batch, hkv, tn, dh),
                             "kpool": (nl, batch, hkv, tn, dh)}
    out.update({
        "htot": (nl, batch, hkv, dh, dh), "ztot": (nl, batch, hkv, dh),
        "qpool": lead + (dh,),
        "plan/mc": lead + (tn, tn), "plan/lut": lead + (tn, k_sel),
        "plan/counts": lead + (tn,), "plan/col_lut": lead + (tn, 1),
        "plan/col_counts": lead + (tn,), "plan/marginal": lead + (tn, tn),
        "live_lut": lead + (k_sel,), "live_cnt": lead, "live_marg": lead,
        "extends": counters, "replans": counters, "reuses": counters,
        "retention": counters})
    return out


def _sla_parts(cfg: ArchConfig, global_batch: int, max_len: int,
               kl: Optional[serving.KVLayout], per_slot: bool = False
               ) -> serving.SLAParts:
    """Where this rank's part of a decode-SLA state sits under the KV
    layout `kl` (`serving.SLAParts`; every leaf whole where kl is None, no
    mesh), its counters per slot with `per_slot`. Refuses a sequence split
    into spans of part KV blocks."""
    if kl is not None:
        kl.check_length(max_len, cfg.sla.block_kv)
    return serving.SLAParts(
        kl, decode_state_shapes(cfg, global_batch, max_len, per_slot),
        global_batch)


def _seed_decode_state(cfg: ArchConfig, kc, vc, decode_mcs, max_len: int,
                       parts: Optional[serving.SLAParts] = None):
    """Decode-SLA state from the prompt caches kc, vc (L, B, Hkv, S, Dh)
    and the decode-grid classification of the prompt rows decode_mcs
    (L, B, H, Tm_p, Tn_p): the static-grid incremental plan, the per-block
    h_j = sum phi(k) v^T and z_j = sum phi(k) partials with their running
    totals, and the pooled-k sums. Built one layer at a time, so the f32
    phi(k) and v temporaries hold one layer.

    Under a mesh (`parts`) kc, vc are the prompt's blocks in this rank's
    span (its first block first), decode_mcs this rank's batch rows and
    query heads, and every leaf comes out at this rank's part: the
    per-block partials of its own blocks, the totals summed over the spans
    in span order, the plan at its rule."""
    sla = cfg.sla
    bkv = sla.block_kv
    nl, b, hkv, s, dh = kc.shape
    dev = kc.device
    tn = max_len // bkv
    tm_p, tn_p = decode_mcs.shape[-2:]
    nb = s // bkv  # the prompt's blocks held here
    dcfg = sla.decode_plan_cfg(tn)
    sharded = parts is not None and parts.kl is not None
    shapes = (parts.local if sharded
              else decode_state_shapes(cfg, b, max_len))
    f32 = dict(dtype=torch.float32, device=dev)
    hblk = torch.zeros(shapes["hblk"], **f32)
    zblk = torch.zeros(shapes["zblk"], **f32)
    kpool = torch.zeros(shapes["kpool"], **f32)
    plans = []
    for li in range(nl):
        kpb = phi(kc[li], sla.phi).reshape(b, hkv, nb, bkv, dh)
        vb = vc[li].float().reshape(b, hkv, nb, bkv, dh)
        hblk[li, :, :, :nb] = torch.matmul(kpb.transpose(-1, -2), vb)
        zblk[li, :, :, :nb] = kpb.sum(dim=-2)
        kpool[li, :, :, :nb] = kc[li].float().reshape(
            b, hkv, nb, bkv, dh).sum(dim=-2)
        del kpb, vb
        mc = torch.full(decode_mcs.shape[1:3] + (tn, tn), -1,
                        dtype=torch.int8, device=dev)
        mc[..., :tm_p, :tn_p] = decode_mcs[li]
        # col_width=1: decode never runs the dK/dV backward, so the plan
        # skips the O(Tn^2)-per-head column LUT
        plans.append(plan_lib.plan_from_mask(mc, dcfg, col_width=1))
    plan = plan_lib.plan_map(lambda *ls: torch.stack(ls), *plans)
    htot, ztot = hblk.sum(dim=3), zblk.sum(dim=3)
    if sharded:
        htot, ztot = _span_totals(parts, htot, ztot)
        have = (parts.batch, parts.heads, None, None)
        plan = plan_lib.SLAPlan(**{
            field: parts.to_leaf(f"plan/{field}", getattr(plan, field),
                                 have[:getattr(plan, field).ndim - 1],
                                 stacked=True)
            for field in plan_lib.PLAN_LEAVES})
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "hblk": hblk, "zblk": zblk,
        "htot": htot, "ztot": ztot,
        "kpool": kpool,
        "qpool": torch.zeros(shapes["qpool"], **f32),
        "plan": plan,
        "rows": tm_p,
        "live_lut": torch.zeros(shapes["live_lut"], **i32),
        "live_cnt": torch.zeros(shapes["live_cnt"], **i32),
        "live_marg": torch.zeros(shapes["live_marg"], **i32),
        "extends": torch.zeros(shapes["extends"], **i32),
        "replans": torch.zeros(shapes["replans"], **i32),
        "reuses": torch.zeros(shapes["reuses"], **i32),
        "retention": torch.ones(shapes["retention"], **f32),
    }


def _span_totals(parts: serving.SLAParts, hsum, zsum):
    """The running totals at their rule from this rank's sums over its own
    blocks, hsum (L, B, Hkv_c, D, D) and zsum (L, B, Hkv_c, D): each
    layer's sums of every span added in span order (so every rank gets the
    same bits), then cut to htot's D_k rows or gathered to ztot's heads."""
    kv = (parts.batch, parts.kv_heads)
    htot, ztot = [], []
    for li in range(hsum.shape[0]):
        totals = []
        for x in (hsum[li], zsum[li]):
            spans = serving.gather_spans(x, parts.kl)
            t = spans[0]
            for r in range(1, spans.shape[0]):
                t = t + spans[r]
            totals.append(t)
        htot.append(parts.to_leaf("htot", totals[0], kv + (None, None)))
        ztot.append(parts.to_leaf("ztot", totals[1], kv + (None,)))
    return torch.stack(htot), torch.stack(ztot)


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


def prefill(params, cfg: ArchConfig, tokens: Optional[torch.Tensor],
            compute_dtype=torch.bfloat16, backend: str = "gather",
            plans=None, drift_threshold=None, return_plans: bool = False,
            decode_max_len: Optional[int] = None,
            cache_len: Optional[int] = None,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Run the prompt; returns (last_hidden (B, d), cache dict).

    `return_plans=True` also returns the per-layer SLAPlan stack; pass it
    back as `plans=` (with `drift_threshold=`) on the next same-shape
    prefill. `decode_max_len=` sizes a static decode block grid, makes
    the KV caches that long, and seeds the cache with the incremental
    decode plan and the linear branch's running H/Z state, so that
    `decode_step` runs decode-time SLA. `cache_len=` makes the KV caches
    that long for dense decode (zero past the prompt). The VLM family's
    `prefix_embeds` (B, P, d) come before the tokens. Return order:
    (last_hidden, cache[, plans][, drift info]); cache["pos"] is the
    prompt length (prefix included).

    Under `activation_sharding(mesh, default_residual_spec(mesh, batch,
    cache length))` the batch is the global one: the last hidden rows are
    this rank's batch rows (every rank's under context parallelism, from
    the last data rank), and the cache, its decode-SLA state too, is this
    rank's part of it under `sharding.cache_shardings`; a sequence split
    over ranks needs `decode_max_len` in whole blocks of each rank's
    span. `plans=` and the returned plans are this rank's part of the
    stack (`forward`), the drift info the global decisions."""
    dcfg = None
    s = ((0 if tokens is None else tokens.shape[1])
         + (0 if prefix_embeds is None else prefix_embeds.shape[1]))
    bkv = cfg.sla.block_kv
    if decode_max_len is not None:
        _check_decode_grid(cfg, s, decode_max_len)
        batch = (tokens if tokens is not None else prefix_embeds).shape[0]
        kl = serving.active_kv_layout(batch, cfg.num_kv_heads)
        parts = _sla_parts(cfg, batch, decode_max_len, kl)
        dcfg = cfg.sla.decode_plan_cfg(decode_max_len // bkv)
        cache_len = decode_max_len
    out = forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                  compute_dtype=compute_dtype, backend=backend,
                  return_cache=True, plans=plans, return_plans=return_plans,
                  drift_threshold=drift_threshold, decode_plan_cfg=dcfg,
                  cache_len=cache_len)
    x, (kc, vc) = out[0], out[2]
    extras = list(out[3:])
    cache = {"k": kc, "v": vc, "pos": s}
    if decode_max_len is not None:
        decode_mcs = extras.pop(1 if return_plans else 0)
        # the prompt's positions in this rank's span: whole blocks from
        # its first
        lo, span = ((0, decode_max_len) if kl is None
                    else kl.span(decode_max_len))
        held = max(0, min(span, s - lo)) // bkv * bkv
        cache["sla"] = _seed_decode_state(cfg, kc[..., :held, :],
                                          vc[..., :held, :], decode_mcs,
                                          decode_max_len, parts)
    return (ctx.seq_last(x), cache) + tuple(extras)


# --------------------------------------------------------------------------
# chunked admission prefill: the prompt one block-aligned span at a time,
# so the scheduler can run decode ticks between chunks. The carry holds
# what later chunks and `_seed_decode_state` need: each layer's KV written
# so far, the mean-pooled q/k block features (every chunk re-scores the
# FULL block map from them with `masks.score_map_pooled`, which is what
# blocking prefill scores) and the decode-grid classification rows.
# Finalization goes through `_seed_decode_state`, as blocking prefill.
# --------------------------------------------------------------------------
def check_chunked_prefill(cfg: ArchConfig, backend: str = "gather"):
    """Refuse configs the chunked-prefill machine cannot serve as blocking
    prefill does. Chunk plan rows are sliced from a full-map
    classification, which is row-decomposable only without the
    column-capacity demotion (it couples rows); the execution path covers
    SLA layers on the gather and kernel backends only."""
    sla = cfg.sla
    if sla.mode != "sla":
        raise ValueError(
            f"chunked admission prefill requires sla.mode='sla' (got "
            f"{sla.mode!r})")
    if sorted(set(layer_kinds_list(cfg))) != [KIND_SLA]:
        raise ValueError(
            "chunked admission prefill requires an all-SLA layer stack "
            "(mixed full/swa stacks prefill blocking)")
    if sla.col_capacity_factor is not None:
        raise ValueError(
            "chunked admission prefill requires "
            "sla.col_capacity_factor=None: the column-capacity demotion "
            "pass couples query rows, so chunk plan rows could not be "
            "sliced from the full classification")
    if sla.window or cfg.sliding_window:
        raise ValueError(
            "chunked admission prefill does not support window-"
            "constrained SLA layers")
    if sla.block_q != sla.block_kv:
        raise ValueError(
            f"chunked admission prefill requires block_q == block_kv "
            f"(got {sla.block_q} vs {sla.block_kv})")
    if backend_lib.resolve(backend) not in ("gather", "kernel"):
        raise ValueError(
            f"chunked admission prefill supports backends "
            f"'gather'/'kernel' (got {backend!r})")


def make_prefill_carry(cfg: ArchConfig, bucket: int,
                       compute_dtype=torch.bfloat16,
                       decode_sla: bool = False, device=None) -> dict:
    """Zero chunked-prefill carry for a (1, bucket) admission, on `device`
    (the card unless the caller asks for the CPU). Leaves, stacked over
    layers; `prefill_chunk` writes them in place:
      k/v  (L, 1, Hkv, bucket, Dh)  KV written so far (later rows zero)
      qpm  (L, 1, H, Tm, Dh) f32    mean-pooled q per written block row
      kpm  (L, 1, H, Tm, Dh) f32    mean-pooled (GQA-repeated) k per block
      dmc  (L, 1, H, Tm, Tm) int8   decode-grid rows (decode_sla only)

    Under `activation_sharding(mesh, default_residual_spec(mesh, 1,
    bucket))` the carry is this rank's heads of the whole bucket: the KV
    heads its "model" rank projects (its own where "model" divides them,
    else all of them) and its query heads, every block of the bucket on
    every data rank (each chunk attends the whole carried prefix and
    re-scores every block's pooled rows, so the carry is held whole over
    the sequence, not gathered a chunk)."""
    sla = cfg.sla
    if bucket % sla.block_q:
        raise ValueError(
            f"chunked prefill needs a block-aligned bucket (got {bucket} "
            f"for block_q={sla.block_q})")
    dev = resolve_device(device)
    _, m = ctx.model_rank_size()
    nl, hkv, h, dh = (cfg.num_layers, cfg.num_kv_heads, cfg.num_heads // m,
                      cfg.head_dim)
    if hkv % m == 0:  # `common.kv_kind`: the KV heads "model" divides
        hkv //= m
    tm = bucket // sla.block_q
    carry = {
        "k": torch.zeros((nl, 1, hkv, bucket, dh), dtype=compute_dtype,
                         device=dev),
        "v": torch.zeros((nl, 1, hkv, bucket, dh), dtype=compute_dtype,
                         device=dev),
        "qpm": torch.zeros((nl, 1, h, tm, dh), dtype=torch.float32,
                           device=dev),
        "kpm": torch.zeros((nl, 1, h, tm, dh), dtype=torch.float32,
                           device=dev),
    }
    if decode_sla:
        carry["dmc"] = torch.full((nl, 1, h, tm, tm), -1, dtype=torch.int8,
                                  device=dev)
    return carry


def carry_rows(carry: dict, tokens: int, block: int) -> dict:
    """The written part of a carry after `tokens` prompt tokens: KV rows
    [:tokens] and block rows [:tokens // block] of the pooled features
    and decode rows (copies). Every later row of the carry is its zero
    (or -1) initial value, so this is all a snapshot has to keep."""
    rows = tokens // block
    return {key: (val[..., :tokens, :] if key in ("k", "v")
                  else val[..., :rows, :]).clone()
            for key, val in carry.items()}


def carry_restore(carry: dict, rows: dict) -> dict:
    """Write a `carry_rows` snapshot into the head of a fresh zero carry,
    in place; returns `carry`."""
    for key, val in rows.items():
        carry[key][..., :val.shape[-2], :] = val
    return carry


@torch.no_grad()
def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, carry: dict,
                  start: int, compute_dtype=torch.bfloat16,
                  backend: str = "gather",
                  decode_max_len: Optional[int] = None):
    """Consume one block-aligned span of prompt tokens against the prefix
    already in `carry`.

    tokens: (1, C) int, C a multiple of block_q; `start` the span's
    absolute, block-aligned token offset (a python int). Writes the span
    into the carry IN PLACE (the reference returns a new carry) and
    returns (carry, last_hidden (1, d)); the last chunk's hidden feeds
    `logits_from_hidden` for the admission's first token.

    Per layer the chunk (a) writes its KV and pooled q/k rows into the
    carry, (b) re-scores the full block map from the pooled carry
    (masked-softmax rows depend only on columns <= row, all written) and
    slices its rows, (c) runs the attention op on its rows against the
    full-bucket carried KV at row offset start // block_q (zero future
    blocks contribute exact zeros through the marginal mask), (d)
    classifies its decode-grid rows from the same pooled maps.
    `decode_max_len` must be the value blocking prefill would get
    (required when the carry has "dmc").

    Under `activation_sharding(mesh, default_residual_spec(mesh, 1,
    bucket))` the carry is this rank's (`make_prefill_carry`) and the
    chunk follows the sharded `prefill`'s scheme: each rank projects its
    heads of its rows of the chunk (its data rank's share under context
    parallelism: a chunk length the data ranks do not divide is refused),
    q, k and v are gathered to the whole chunk, every rank writes them
    into its carry, scores and attends its heads of the chunk's rows
    against the whole carried bucket, and keeps its own rows for the
    row-parallel output projection and the FFN. The last hidden row is
    every rank's (`ctx.seq_last`)."""
    from repro_torch.core.block_sparse_xla import sla_forward_gather
    from repro_torch.kernels import ops as kops

    check_chunked_prefill(cfg, backend)
    backend = backend_lib.resolve(backend)
    sla = cfg.sla
    bq = sla.block_q
    b, c = tokens.shape
    if b != 1:
        raise ValueError(f"prefill_chunk takes a batch-1 span (got {b})")
    if c % bq:
        raise ValueError(
            f"chunk length {c} must be a multiple of block_q={bq}")
    start = int(start)
    bucket = carry["k"].shape[-2]
    if start % bq or start + c > bucket:
        raise ValueError(
            f"chunk [{start}, {start + c}) must be block-aligned inside "
            f"the {bucket}-token bucket")
    tm = bucket // bq
    nb, sb = c // bq, start // bq
    decode_sla = "dmc" in carry
    if decode_sla and decode_max_len is None:
        raise ValueError(
            "carry tracks decode-grid rows ('dmc'): pass the same "
            "decode_max_len blocking prefill would use")
    plan_cfg = dataclasses.replace(sla, causal=True)
    dcfg = (sla.decode_plan_cfg(decode_max_len // sla.block_kv)
            if decode_sla else None)
    lay = ctx.layout()
    if lay is not None and c % lay.seq:
        raise ValueError(
            f"a chunk of {c} tokens at {start} cannot be split over the "
            f"{lay.seq} data ranks of context parallelism: give a chunk "
            f"length they divide")
    x = ctx.vocab_lookup(tokens, params.embed).to(compute_dtype)
    row0, _ = ctx.seq_span(c)
    x = ctx.seq_rows(x)
    dev = x.device
    positions = (start + row0 + torch.arange(x.shape[1], device=dev))[
        None, :]
    k_sel = plan_cfg.num_critical(tm)
    for li, p in enumerate(params.layers):
        xin = ctx.to_tp(rms_norm(x, ctx.fsdp_gather(p.ln1, "rep")))
        q, k, v = (ctx.gather_seq(t, 2) for t in _qkv(p, xin, cfg,
                                                       positions))
        kc, vc = carry["k"][li], carry["v"][li]
        kc[:, :, start:start + c] = k.to(kc.dtype)
        vc[:, :, start:start + c] = v.to(vc.dtype)
        h = q.shape[1]
        qpm, kpm = carry["qpm"][li], carry["kpm"][li]
        # pooled rows: the mean over each block's own tokens, so chunk-
        # local pooling equals full-prefill pooling (and GQA repeat and
        # pooling commute)
        qpm[:, :, sb:sb + nb] = masks_lib.pool_blocks(q, bq)
        kpm[:, :, sb:sb + nb] = masks_lib.pool_blocks(repeat_kv(
            local_kv_heads(k, cfg.num_heads, cfg.num_kv_heads), h),
            sla.block_kv)
        routing = _routing(p, sla)
        mc_rows = masks_lib.classify_blocks(
            masks_lib.score_map_pooled(routing, qpm, kpm, plan_cfg),
            plan_cfg)[:, :, sb:sb + nb]
        lut, counts = plan_lib.build_lut(mc_rows, k_sel)
        # inference only: the hard indicator is the forward value of the
        # learned-routing straight-through gates
        marginal = (mc_rows == 0).float()
        if decode_sla:
            mcd = masks_lib.classify_blocks(
                masks_lib.score_map_pooled(routing, qpm, kpm, dcfg), dcfg)
            carry["dmc"][li][:, :, sb:sb + nb] = mcd[:, :, sb:sb + nb]
            del mcd
        krf, vrf = (repeat_kv(local_kv_heads(t, cfg.num_heads,
                                             cfg.num_kv_heads), h)
                    for t in (kc, vc))
        qp, kp = phi(q, sla.phi), phi(krf, sla.phi)
        if backend == "gather":
            rows_plan = plan_lib.SLAPlan(
                mc=mc_rows, lut=lut, counts=counts,
                col_lut=torch.zeros((b, h, tm, 1), dtype=torch.int32,
                                    device=dev),
                col_counts=torch.zeros((b, h, tm), dtype=torch.int32,
                                       device=dev),
                marginal=marginal)
            o_s, o_l = sla_forward_gather(q, krf, vrf, qp, kp, rows_plan,
                                          plan_cfg, row_offset=sb)
        else:
            o_s, o_l = kops.sla_attention_rows(
                q, krf, vrf, qp, kp, marginal, lut, counts, plan_cfg,
                row_offset=sb)
        del krf, vrf, kp
        o = (o_s + torch.einsum(
            "bhnd,hde->bhne", o_l,
            ctx.fsdp_gather(p.sla_proj, "row").float())).to(x.dtype)
        o = ctx.seq_rows(o, dim=2)
        x = x + ctx.from_tp(o.transpose(1, 2).reshape(b, x.shape[1], -1)
                            @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))
        f, _ = _ffn(p, rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")), cfg)
        x = x + f
        del q, k, v, o_s, o_l, o, f
    x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    return carry, ctx.seq_last(x)


def finalize_chunked_prefill(cfg: ArchConfig, carry: dict,
                             decode_max_len: Optional[int] = None) -> dict:
    """Chunked-prefill carry -> the cache dict blocking `prefill` returns:
    the decode state is rebuilt with `_seed_decode_state` from the carried
    KV and decode rows (not grown with `plan_extend`, whose dead col_lut
    padding would differ), and the KV caches are padded to
    `decode_max_len`. The cache's k/v share the carry's storage when no
    padding is needed.

    Under the carry's scope (`make_prefill_carry`) the cache is this
    rank's part of what a sharded blocking `prefill(decode_max_len=)`
    returns: its span of the positions (whole blocks), its KV heads, and
    its part of the decode-SLA state, seeded from its span's blocks and
    its query heads' decode rows (`_seed_decode_state` under `parts`)."""
    kc, vc = carry["k"], carry["v"]
    bucket = kc.shape[-2]
    cache = {"k": kc, "v": vc, "pos": bucket}
    length = bucket if decode_max_len is None else decode_max_len
    kl = serving.active_kv_layout(1, cfg.num_kv_heads)
    if decode_max_len is not None:
        _check_decode_grid(cfg, bucket, decode_max_len)
    lo, span = 0, length
    if kl is not None:
        kl.check_length(length, 1 if decode_max_len is None
                        else cfg.sla.block_kv)
        lo, span = kl.span(length)
    grow = length - bucket
    if grow > 0:
        kc, vc = F.pad(kc, (0, 0, 0, grow)), F.pad(vc, (0, 0, 0, grow))
    if span < length:
        kc, vc = (t[..., lo:lo + span, :].clone() for t in (kc, vc))
    cache["k"], cache["v"] = kc, vc
    if decode_max_len is not None:
        # the prompt's positions in this rank's span: whole blocks from
        # its first
        bkv = cfg.sla.block_kv
        held = max(0, min(span, bucket - lo)) // bkv * bkv
        cache["sla"] = _seed_decode_state(
            cfg, kc[..., :held, :], vc[..., :held, :], carry["dmc"],
            decode_max_len, _sla_parts(cfg, 1, decode_max_len, kl))
    return cache


def _slot_positions(cache: dict):
    """The positions of a decode cache: (vec, pos, pos_host). A static
    cache holds one python int shared by the batch (vec False, pos_host
    the same int); a per-slot cache (`make_cache(per_slot=True)`,
    `make_paged_cache`) holds a (B,) int32 device tensor advanced in
    place and its host mirror, a (B,) numpy array, that the boundary
    branches read without syncing the stream."""
    pos = cache["pos"]
    if torch.is_tensor(pos) and pos.ndim > 0:
        return True, pos, cache["pos_host"]
    return False, int(pos), int(pos)


def _advance(cache: dict, vec: bool):
    if vec:
        cache["pos"] += 1
        cache["pos_host"] += 1
    else:
        cache["pos"] = cache["pos"] + 1


def _dense_decode_attn(q, kc, vc, pos, kind, cfg: ArchConfig):
    """Masked softmax over the full static cache, O(S) per token. q:
    (B, H, 1, Dh); kc, vc: (B, Hkv, Smax, Dh); pos: a python int (aligned
    static batch) or a (B,) tensor of per-slot positions. GQA folds the
    head group into the query. A sliding-window layer (KIND_SWA) also
    masks the columns at or before pos - window, at token level, as the
    reference's (its prefill band is block-granular); an SLA layer's
    dense decode applies no window. Returns (B, 1, H * Dh) in q.dtype."""
    b, h = q.shape[0], q.shape[1]
    hkv, smax = kc.shape[1], kc.shape[2]
    qg = q[:, :, 0, :].reshape(b, hkv, h // hkv, cfg.head_dim)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), kc.float()) \
        * (cfg.head_dim**-0.5)
    posb = pos if not torch.is_tensor(pos) else pos[:, None, None, None]
    idx = torch.arange(smax, device=q.device)
    ok = idx <= posb
    if kind == KIND_SWA:
        ok = ok & (idx > posb - (cfg.local_window or cfg.sliding_window))
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, dim=-1),
                     vc.float())
    return o.to(q.dtype).reshape(b, 1, h * cfg.head_dim)


def _cache_write(c, new, pos):
    """Write one new token's KV in place: c (B, Hn, S, D), new
    (B, Hn, 1, D). A python-int `pos` writes every row there; a (B,)
    tensor writes each slot at its own position, clamped to the last
    position as the reference's dynamic_update_slice clamps a runaway
    inactive slot."""
    if not torch.is_tensor(pos):
        c[:, :, pos] = new[:, :, 0].to(c.dtype)
        return
    b = torch.arange(c.shape[0], device=c.device)
    c[b, :, pos.long().clamp(0, c.shape[2] - 1)] = new[:, :, 0].to(c.dtype)


def _blk_update(buf, upd, row, first: int = 0, grid: Optional[int] = None):
    """Add `upd` (B, Hn, ...) into block `row` of a per-block running
    buffer (B, Hn, Tn, ...), in place; `row` a python int or a (B,)
    tensor (clamped into the grid, as the reference's dynamic slices).
    Under a mesh buf holds blocks [first, first + Tn_loc) of a `grid`-
    block grid: a slot's update lands where its block is held (an int
    `row` the caller has checked is)."""
    if not torch.is_tensor(row):
        buf[:, :, row - first] += upd
        return
    b = torch.arange(buf.shape[0], device=buf.device)
    n = buf.shape[2]
    r = row.long().clamp(0, (grid or n) - 1) - first
    if grid is None:
        buf[b, :, r] = buf[b, :, r] + upd
        return
    own = ((r >= 0) & (r < n)).reshape((-1,) + (1,) * (upd.ndim - 1))
    r = r.clamp(0, n - 1)
    cur = buf[b, :, r]
    buf[b, :, r] = torch.where(own, cur + upd, cur)


def _page_gather(pool, pt):
    """Per-layer page pool (P, Hkv, ...) -> per-slot block view
    (B, Hkv, Tn, ...) through the page table pt (B, Tn) int32 (a copy)."""
    return pool[pt.long()].movedim(2, 1)


def _page_gather_kv(pool, pt):
    """KV page pool (P, Hkv, bkv, Dh) -> the contiguous (B, Hkv, S, Dh)
    cache view a monolithic per-slot cache would hold."""
    g = _page_gather(pool, pt)                  # (B, Hkv, Tn, bkv, Dh)
    return g.reshape(g.shape[:2] + (g.shape[2] * g.shape[3], g.shape[4]))


def _page_write_kv(pool, new, pid, off, own=None):
    """Write one new-token KV into its page, in place: pool
    (P, Hkv, bkv, Dh), new (B, Hkv, 1, Dh), pid/off (B,) tensors. The
    scheduler's copy-on-write pass makes every active slot's write page
    private, so the pids are distinct and the scatter has no conflict.
    `own` (B,) bool, where a rank's span holds some slots' write blocks
    only: the other slots write back what their page holds."""
    new = new[:, :, 0, :].to(pool.dtype)
    if own is not None:
        new = _sel(own, new, pool[pid, :, off])
    pool[pid, :, off] = new


def _write_page(pt_rows: torch.Tensor, pos: torch.Tensor, bkv: int,
                span=None):
    """(page, offset, own) of each slot's write: the page table's entry
    (pt_rows (B, Tn), the slots' rows) for block pos // bkv, clamped to
    the last block (runaway inactive slots land on their scratch page),
    and pos % bkv. `span` (first, blocks) of a split grid: `own` marks
    the slots whose write block lies in it (None where the grid is
    whole)."""
    b, tn = pt_rows.shape
    blk = torch.clamp(pos.long() // bkv, max=tn - 1)
    wpid = pt_rows[torch.arange(b, device=pt_rows.device), blk].long()
    own = None
    if span is not None and span[1] < tn:
        own = (blk >= span[0]) & (blk < span[0] + span[1])
    return wpid, pos.long() % bkv, own


def _paged_part(cache: dict, kl: Optional[serving.KVLayout], bkv: int
                ) -> dict:
    """This rank's view of a paged cache's page table (`make_paged_cache`:
    `pt` (B, Tn) is whole on every rank, as `pos`): "rows" its batch
    rows' entries (B_loc, Tn), "pt" their entries for its span's logical
    blocks (B_loc, Tn_loc), the span as "span" (first block, blocks), and
    the slot index of its first row ("row0"). The whole table without a
    mesh. The rank's pools hold the pages of its rows at its span's
    blocks, indexed by the global page id."""
    pt = cache["pt"]
    b, tn = pt.shape
    if kl is None:
        return {"rows": pt, "pt": pt, "span": (0, tn), "row0": 0}
    rows = ctx.batch_rows(pt)
    first, n = kl.span(tn * bkv)
    first, n = first // bkv, n // bkv
    _, index = serving._axes_index(serving._spec_axes(kl.spec[1]), kl.mesh)
    return {"rows": rows, "pt": rows[:, first:first + n].contiguous(),
            "span": (first, n), "row0": index * rows.shape[0]}


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                compute_dtype=torch.bfloat16, backend: str = "gather",
                drift_threshold=None):
    """One decode step. token: (B,) int; cache k/v: (L, B, Hkv, S, Dh).
    cache["pos"] is the position shared by the batch (a python int,
    static serving) or a (B,) tensor of per-slot positions with its host
    mirror cache["pos_host"] (continuous batching: every slot advances
    through its own sequence). Caches made with `prefill(decode_max_len=)`
    or `make_cache(decode_sla=True)` carry decode-SLA state and run SLA
    decode (`_decode_step_sla`); otherwise dense masked attention over
    the full static cache.

    Paged caches (`make_paged_cache`) carry `kp`/`vp` page pools and a
    `pt` page table instead of monolithic k/v; the same step math runs
    against page-gathered views (dense) or the pools in place (SLA), so
    paged and monolithic decode are bitwise equal. Writes the new token
    into the cache in place and returns (logits (B, V) f32, cache) with
    the positions advanced.

    Under `activation_sharding(mesh, default_residual_spec(mesh, batch,
    cache length))` `token` is the global (B,) batch and the cache this
    rank's part of it under `sharding.cache_shardings` (`prefill`,
    `make_cache`): the step reads its batch rows of the token (and of a
    per-slot `pos`, which every rank holds whole), writes the new K/V
    where its part holds them, and attends by the layout
    (`distributed/serving.py`): heads over "model" as one device does, a
    split sequence by a partial softmax and a combine across its ranks.
    Decode-time SLA runs there too (`_decode_step_sla` on this rank's
    part of its state), for the aligned batch and for per-slot positions
    (each slot's boundary work at its own row, its plan rows and live row
    written where the rank holds them), under threshold or learned
    routing (the scorer read whole: every head's row is scored). It
    returns the logits of its batch rows over the whole vocabulary (every
    rank's rows under context parallelism)."""
    if "sla" in cache:
        return _decode_step_sla(params, cfg, token, cache, compute_dtype,
                                backend, drift_threshold)
    paged = "kp" in cache
    vec, pos, _ = _slot_positions(cache)
    bkv = cfg.sla.block_kv
    kl = serving.active_kv_layout(token.shape[0], cfg.num_kv_heads)
    sharded = serving.is_sharded(kl)
    if paged:
        part = _paged_part(cache, kl, bkv)
    if kl is not None:
        length = (cache["pt"].shape[1] * bkv if paged
                  else cache["k"].shape[3] * kl.seq_parts)
        token = ctx.batch_rows(token)
        if vec:
            pos = ctx.batch_rows(pos)  # every rank holds the whole (B,)
        _check_rows(part["rows"] if paged else cache["k"], token)
    # under context parallelism every data rank decodes every row
    with (ctx.replicated_tokens() if ctx.seq_parallel()
          else contextlib.nullcontext()):
        x = ctx.vocab_lookup(token[:, None], params.embed).to(compute_dtype)
        b, dev = x.shape[0], x.device
        positions = (pos.long()[:, None] if vec
                     else torch.full((b, 1), pos, device=dev))
        if paged:
            pt = part["pt"]
            wpid, woff, own = _write_page(part["rows"], pos, bkv,
                                          part["span"])
        kinds = layer_kinds_list(cfg)
        for li, p in enumerate(params.layers):
            q, k_new, v_new = _qkv(p, rms_norm(
                x, ctx.fsdp_gather(p.ln1, "rep")), cfg, positions)
            if paged:
                kc, vc = cache["kp"][li], cache["vp"][li]
                _page_write_kv(kc, k_new, wpid, woff, own)
                _page_write_kv(vc, v_new, wpid, woff, own)
                kc, vc = _page_gather_kv(kc, pt), _page_gather_kv(vc, pt)
            else:
                kc, vc = cache["k"][li], cache["v"][li]
            if sharded:
                start, _ = kl.span(length)
                if not paged:
                    serving.write_token(kc, k_new, pos, start, length)
                    serving.write_token(vc, v_new, pos, start, length)
                window = ((cfg.local_window or cfg.sliding_window)
                          if kinds[li] == KIND_SWA else 0)
                o = serving.sharded_decode_attn(
                    q[:, :, 0], kc, vc, pos, kl, length, window)
                o = o.to(q.dtype).reshape(b, 1, -1)
            else:
                if not paged:
                    _cache_write(kc, k_new, pos)
                    _cache_write(vc, v_new, pos)
                o = _dense_decode_attn(q, kc, vc, pos, kinds[li], cfg)
            x = x + ctx.from_tp(o @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))
            f, _ = _ffn(p, rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")), cfg)
            x = x + f
        x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    _advance(cache, vec)
    return logits_from_hidden(params, x[:, 0]), cache


def _sel(mask, new, old):
    """where(mask, new, old) with a (B,) slot mask broadcast over the
    trailing dims of new."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                       old)


def _check_rows(held: torch.Tensor, token: torch.Tensor) -> None:
    """Refuse a step whose batch rows on this rank (token's) are not the
    cache's (held's, dim 1 of a K/V leaf or dim 0 of a page table's
    rows)."""
    n = held.shape[0] if held.ndim == 2 else held.shape[1]
    if n != token.shape[0]:
        raise ValueError(
            f"the cache holds {n} batch rows on this rank, the step "
            f"{token.shape[0]}: make it under the same activation_sharding "
            f"scope")


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
    same result. It runs after the update: the new token's block is
    causally masked out of the completed row's scores.

    Per-slot positions (a (B,) `pos`) run all of this per slot: each slot
    crosses its own block boundaries, appends its own plan row and makes
    its own drift decision (the min over ITS heads; the scalar-pos static
    batch keeps the min over the whole batch). When any slot is at a
    boundary the boundary work runs for the whole batch and is selected
    per slot; the counters are (L, B) and `rows` (B,).

    Paged caches keep K/V and the per-block h/z/kpool partials in global
    page pools: every write lands in the slot's private current page and
    the decode backends read the pools in place through the page table,
    so the step stays bitwise equal to unpaged decode.

    Under a ("data", "model") mesh the same math runs on this rank's
    part of the state (`parts`, the
    placement `cache_shardings` gives each leaf; without a mesh every
    leaf is whole and every move between placements is the identity).
    The new token's K/V and its update of the per-block h_j, z_j and
    pooled k go to the rank whose span holds its block; each rank adds it
    to its D_k rows of Htot and, with every "model" rank's phi(k), to the
    whole Ztot. Every rank does the boundary work for its batch rows and
    every head, on every head's q (gathered over "model") and the pooled
    k of every block (gathered over the spans): the same bits on every
    rank that holds the same rows. The drift decision's min over the
    batch is an all-reduce MIN over the data ranks that split it (exact
    in any order); a slot's own decision needs none, each rank scoring
    all of its heads. The plan rows and the live row go to their leaves
    at their rules, a slot's at its own row (`_plan_extend_part`,
    `serving.read_row` of a (B,) row); the per-slot counters, whose
    layers the rules may split over the data ranks, are updated at the
    rank's batch rows and written back (`SLAParts.slot_rows`). Attention
    by the layout (`_sla_attn`, each slot's rows at its own position); a
    non-SLA layer attends as the dense mesh step does.
    """
    backend_lib.resolve_decode(backend)
    paged = "kp" in cache
    vec, pos, pos_h = _slot_positions(cache)
    if paged and not vec:
        raise ValueError("paged decode requires per-slot (B,) positions")
    st = cache["sla"]
    sla = cfg.sla
    bq, bkv = sla.block_q, sla.block_kv
    kl = serving.active_kv_layout(token.shape[0], cfg.num_kv_heads)
    if paged:
        part = _paged_part(cache, kl, bkv)
        pt = part["pt"]
        tn = cache["pt"].shape[1]
        slap = cache["slap"]
    else:
        tn = cache["k"].shape[3] * (1 if kl is None else kl.seq_parts) // bkv
    length = tn * bkv
    parts = _sla_parts(cfg, token.shape[0], length, kl, per_slot=vec)
    bat, kvh = parts.batch, parts.kv_heads
    start, _ = (0, length) if kl is None else kl.span(length)
    first = start // bkv
    grid = None if kl is None else tn  # a split grid masks per-slot rows
    rows_all = st["rows"]
    if kl is not None:
        token = ctx.batch_rows(token)
        if vec:  # every rank holds the whole (B,) pos and rows
            pos, rows_all = ctx.batch_rows(pos), ctx.batch_rows(rows_all)
        _check_rows(part["rows"] if paged else cache["k"], token)
    if paged:
        wpid, woff, own = _write_page(part["rows"], pos, bkv, part["span"])
    dcfg = sla.decode_plan_cfg(tn)
    kinds = layer_kinds_list(cfg)
    nl = cfg.num_layers
    if drift_threshold is None:
        drift_threshold = sla.drift_thresholds(nl)
    # host floats: a per-step host-to-device copy would sync the stream
    thresholds = torch.broadcast_to(torch.as_tensor(
        drift_threshold, dtype=torch.float32), (nl,)).tolist()
    g = cfg.num_heads // cfg.num_kv_heads
    # under context parallelism every data rank decodes every row
    with (ctx.replicated_tokens() if ctx.seq_parallel()
          else contextlib.nullcontext()):
        x = ctx.vocab_lookup(token[:, None], params.embed).to(compute_dtype)
        b, dev = x.shape[0], x.device
        blk = torch.arange(tn, device=dev)
        if vec:
            posl = pos.long()
            row = posl // bq                  # each slot's live query row
            # the whole batch's host mirror: every rank takes the branch
            any_boundary = bool((pos_h % bq == 0).any())
            positions = posl[:, None]
            if any_boundary:
                boundary = posl % bq == 0
                append = boundary & (rows_all.long() < row)
                blk_cnt = torch.clamp(torch.clamp(
                    (posl[:, None] + 1) - blk * bkv, max=bkv), 1, bkv)
                cnt_div = blk_cnt[:, None, :, None].float()
                prev = torch.clamp(row - 1, 0, tn - 1)
                diag = (blk == row[:, None])[:, None, :]
                # the per-slot counters, every layer at this rank's rows
                counters = {key: parts.slot_rows(key, st[key])
                            for key in COUNTER_KEYS}
                slots = dict(boundary=boundary, append=append, prev=prev,
                             diag=diag, counters=counters)
        else:
            row = pos // bq                   # the current (partial) query row
            any_boundary = pos % bq == 0      # a block was just completed
            append = any_boundary and st["rows"] < row
            slots = None
            positions = torch.full((b, 1), pos, device=dev)
            if any_boundary:
                # tokens per KV block after this step's write (pooled-k
                # means)
                cnt_div = torch.clamp(torch.clamp((pos + 1) - blk * bkv,
                                                  max=bkv), 1, bkv)[:, None]
                cnt_div = cnt_div.float()
        plan = st["plan"]
        for li, p in enumerate(params.layers):
            q, k_new, v_new = _qkv(p, rms_norm(
                x, ctx.fsdp_gather(p.ln1, "rep")), cfg, positions)
            if paged:
                kc, vc = cache["kp"][li], cache["vp"][li]
                _page_write_kv(kc, k_new, wpid, woff, own)
                _page_write_kv(vc, v_new, wpid, woff, own)
                hb, zb, kp_sum = (slap[key][li]
                                  for key in ("hblk", "zblk", "kpool"))
            else:
                kc, vc = cache["k"][li], cache["v"][li]
                if kl is None:
                    _cache_write(kc, k_new, pos)
                    _cache_write(vc, v_new, pos)
                else:
                    serving.write_token(kc, k_new, pos, start, length)
                    serving.write_token(vc, v_new, pos, start, length)
                hb, zb, kp_sum = (st["hblk"][li], st["zblk"][li],
                                  st["kpool"][li])
            q1 = q[:, :, 0]                   # (B, H_loc, D)
            q_all = serving.reshard(q1, (bat, parts.heads, None),
                                    (bat, None, None), parts.mesh)
            qf = q_all.float()                # (B, H, D), every head
            kf = k_new[:, :, 0, :].float()    # (B, Hkv_c, D)
            vf = v_new[:, :, 0, :].float()
            routing = _routing(p, dcfg, every=True)
            lplan = plan_lib.plan_map(lambda leaf: leaf[li], plan)  # views
            ht, zt, qp_sum = st["htot"][li], st["ztot"][li], st["qpool"][li]

            # 1. O(1) running-state update for the new token
            phik = phi(kf, sla.phi)           # (B, Hkv_c, D) f32
            hupd = phik[..., :, None] * vf[..., None, :]
            if paged:
                # distinct private write pages: a gather/add/set, as the
                # monolithic slice/add/write, so the partials stay bitwise
                # (a split grid's other slots write back what they read)
                for buf, upd in ((hb, hupd), (zb, phik), (kp_sum, kf)):
                    cur = buf[wpid]
                    buf[wpid] = (cur + upd if own is None
                                 else _sel(own, cur + upd, cur))
            elif vec or first <= row < first + hb.shape[2]:
                _blk_update(hb, hupd, row, first, grid)
                _blk_update(zb, phik, row, first, grid)
                _blk_update(kp_sum, kf, row, first, grid)
            ht += parts.to_leaf("htot", hupd, (bat, kvh, None, None))
            zt += parts.to_leaf("ztot", phik, (bat, kvh, None))

            if any_boundary:
                kp_all = parts.from_leaf(
                    "kpool", _page_gather(kp_sum, pt) if paged else kp_sum,
                    (bat, None, None, None))
                # 2. append the just-completed row
                if vec or append:
                    _append_row(st, li, lplan, parts, routing, kp_all, row, g,
                                dcfg, slots)
                # 3. the new live row's structure, drift-gated per layer
                kpm_live = torch.repeat_interleave(kp_all / cnt_div, g,
                                                   dim=1)
                _live_row(st, li, lplan, parts, routing, qf, kpm_live, row,
                          thresholds[li], dcfg, slots)
            else:
                qp_sum += qf

            # 4. attention: critical blocks + the O(1) linear state
            if kinds[li] == KIND_SLA:
                o = _sla_attn(p, q1, q_all, st, li, kc, vc, hb, zb, pos,
                              parts, dcfg, backend, pt if paged else None)
            else:
                if paged:
                    kc, vc = _page_gather_kv(kc, pt), _page_gather_kv(vc, pt)
                if serving.is_sharded(kl):
                    window = ((cfg.local_window or cfg.sliding_window)
                              if kinds[li] == KIND_SWA else 0)
                    o = serving.sharded_decode_attn(q1, kc, vc, pos, kl,
                                                    length, window)
                    o = o.to(q.dtype).reshape(b, 1, -1)
                else:
                    o = _dense_decode_attn(q, kc, vc, pos, kinds[li], cfg)
            x = x + ctx.from_tp(o @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))
            f, _ = _ffn(p, rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")), cfg)
            x = x + f
        if vec and any_boundary:
            for key in COUNTER_KEYS:
                parts.put_slot_rows(key, st[key], counters[key])
            st["rows"] += serving.reshard(append, (bat,), (None,),
                                          parts.mesh).to(st["rows"].dtype)
        elif not vec and append:
            st["rows"] += 1
        x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    _advance(cache, vec)
    return logits_from_hidden(params, x[:, 0]), cache


def _plan_extend_part(plan, mc_row: torch.Tensor, row,
                      parts: serving.SLAParts, append=None):
    """`plan_lib.plan_extend` of row `row` into this rank's part of a
    plan, in place (the whole plan where `parts` has no mesh): mc_row
    (B, H, Tn) is the row for this rank's batch rows and every head and
    column (the same on every rank that holds them). The row-indexed
    leaves are written by the ranks that hold row `row`, each at its own
    heads; the column LUT and the counts at their rules.

    Per slot (`plan_extend`'s per-slot form): `row` and `append` are (B,)
    tensors of this rank's batch rows, each slot's row written where
    append is set (a row past the grid clamped to the last), by the ranks
    that hold it, each column at that slot's own fill level."""
    rows3 = (parts.batch, None, None)
    mc_row = mc_row.to(plan.mc.dtype)
    lut_r, cnt_r = plan_lib.build_lut(mc_row[..., None, :], plan.k_sel)
    # the new row becomes the last critical entry of every column it is
    # critical in (`plan_extend`), at every column's global fill level
    cc = parts.from_leaf("plan/col_counts", plan.col_counts, rows3)
    can = (mc_row == 1) & (cc < plan.w_col)
    if append is not None:
        can = can & append[:, None, None]
    slot = torch.arange(plan.w_col, dtype=cc.dtype, device=cc.device)
    write = can[..., None] & (slot == cc[..., None])
    write_leaf = parts.to_leaf("plan/col_lut", write, rows3 + (None,))
    if append is None:
        plan.col_lut.masked_fill_(write_leaf, row)
    else:  # each slot's own row: its value at the leaf's placement
        rows = parts.to_leaf("plan/col_lut", row.to(plan.col_lut.dtype)[
            :, None, None, None].expand(write.shape), rows3 + (None,))
        plan.col_lut.copy_(torch.where(write_leaf, rows, plan.col_lut))
    plan.col_counts.add_(parts.to_leaf("plan/col_counts", can.to(cc.dtype),
                                       rows3))
    for name, val in (("mc", mc_row), ("lut", lut_r[..., 0, :]),
                      ("marginal", (mc_row == 0).to(plan.marginal.dtype)),
                      ("counts", cnt_r[..., 0])):
        leaf = getattr(plan, name)
        spec = parts.spec[f"plan/{name}"]
        val = serving.reshard(val, rows3[:val.ndim],
                              spec[:2] + spec[3:], parts.mesh)
        first = parts.start(f"plan/{name}", 2)
        n = leaf.shape[2]
        if append is None:
            if first <= row < first + n:
                leaf[:, :, row - first] = val
            continue
        b = torch.arange(leaf.shape[0], device=leaf.device)
        r = row.long().clamp(0, parts.shapes[f"plan/{name}"][3] - 1) - first
        on = append & (r >= 0) & (r < n)
        r = r.clamp(0, n - 1)
        leaf[b, :, r] = torch.where(
            on.reshape((-1,) + (1,) * (val.ndim - 1)), val.to(leaf.dtype),
            leaf[b, :, r])
    return plan


def _append_row(st: dict, li: int, plan, parts: serving.SLAParts,
                routing, kp_all, row, g: int, dcfg, slots=None):
    """Phase 2 of a decode-SLA token at a block boundary, layer li: the
    just-completed row row - 1 classified from its pooled q (the layer's
    qpool) and every block's pooled k (kp_all (B, Hkv, Tn, D), every
    head and block) and appended to this rank's part of the plan
    (`_plan_extend_part`). Per slot (`slots`, `_live_row`'s), each slot
    whose `append` is set, at its own row."""
    vec = slots is not None
    rowm = row[:, None] if vec else row  # row arg of the masks helpers
    kpm = torch.repeat_interleave(kp_all / dcfg.block_kv, g, dim=1)
    pc_prev = masks_lib.score_row(routing, st["qpool"][li] / dcfg.block_q,
                                  kpm, rowm - 1, dcfg)
    mc_prev = masks_lib.classify_row(pc_prev, rowm - 1, dcfg)
    if vec:
        _plan_extend_part(plan, mc_prev, row - 1, parts, slots["append"])
        slots["counters"]["extends"][li] += slots["append"].to(torch.int32)
    else:
        _plan_extend_part(plan, mc_prev, row - 1, parts)
        st["extends"][li] += 1


def _live_row(st: dict, li: int, plan, parts: serving.SLAParts, routing,
              qf, kpm_live, row, thr: float, dcfg, slots=None):
    """Phase 3 of a decode-SLA token at a block boundary, layer li: the
    new live row `row` (every head's, scored from the token's q qf (B, H,
    D) against every block's pooled k kpm_live), drift-gated: inherit the
    previous row's critical set plus the forced diagonal ("reuse") unless
    its drift against the fresh classification reaches `thr` ("replan").
    The decision's min over the aligned batch crosses the data ranks that
    split it (`ctx.min_over_ranks`). The live row goes to its leaves at
    their rules, with the counters and the pooled q restarted.

    Per slot (`slots`: the (B,) `boundary`, `append`, `prev` (each slot's
    previous row), `diag` mask and the per-slot `counters` of
    `SLAParts.slot_rows`): each slot at a boundary takes its own row and
    decision, the min over its own heads (all of them scored here on
    each rank that holds the slot: no rank is crossed); the other slots
    keep theirs and add to their pooled q."""
    bat = parts.batch
    vec = slots is not None
    rowm = row[:, None] if vec else row
    pc_live = masks_lib.score_row(routing, qf, kpm_live, rowm, dcfg)
    mc_fresh = masks_lib.classify_row(pc_live, rowm, dcfg)
    spec = parts.spec["plan/mc"]
    mc_inh = serving.reshard(
        serving.read_row(plan.mc, 2, slots["prev"] if vec else row - 1,
                         spec[2], parts.mesh),
        spec[:2] + (None,), (bat, None, None), parts.mesh).clone()
    if vec:
        mc_inh[slots["diag"].expand_as(mc_inh)] = 1
    else:
        mc_inh[..., row] = 1
    stale = (pc_live * (mc_inh == 1)).sum(dim=-1)
    fresh = (pc_live * (mc_fresh == 1)).sum(dim=-1)
    r = torch.clamp(stale / torch.clamp(fresh, min=plan_lib.EPS), 0.0, 1.0)
    retention = (r.min(dim=1).values if vec
                 else ctx.min_over_ranks(r.min(), heads=False))
    replan = ((1.0 - retention) >= thr) & (thr < 1.0)
    mc_live = torch.where(replan[:, None, None] if vec else replan,
                          mc_fresh, mc_inh)
    lut_n, cnt_n = plan_lib.build_lut(mc_live[..., None, :], plan.k_sel)
    live = {"live_lut": lut_n[..., 0, :], "live_cnt": cnt_n[..., 0],
            "live_marg": (mc_live == 0).sum(dim=-1, dtype=torch.int32)}
    for key, new in live.items():
        have = (bat,) + (None,) * (new.ndim - 1)
        if vec:  # the slots at a boundary take their new row
            new = _sel(slots["boundary"], new,
                       parts.from_leaf(key, st[key][li], have))
        st[key][li] = parts.to_leaf(key, new, have)
    qp_sum = st["qpool"][li]
    if vec:
        boundary, counters = slots["boundary"], slots["counters"]
        counters["replans"][li] += (boundary & replan).to(torch.int32)
        counters["reuses"][li] += (boundary & ~replan).to(torch.int32)
        counters["retention"][li] = torch.where(
            boundary, retention, counters["retention"][li])
        qp_sum.copy_(_sel(boundary, qf, qp_sum + qf))
    else:
        st["replans"][li] += replan.to(torch.int32)
        st["reuses"][li] += (~replan).to(torch.int32)
        st["retention"][li] = retention
        qp_sum.copy_(qf)


def _sla_attn(p, q, q_all, st: dict, li: int, kc, vc, hb, zb, pos,
              parts: serving.SLAParts, dcfg, backend: str, pt=None
              ) -> torch.Tensor:
    """Decode-time SLA attention of this rank's query heads q (B, H_loc,
    D) over its part of the layer's state (kc, vc, hb, zb: the layer's
    K/V and per-block h_j, z_j, or their page pools with the page table
    `pt`); q_all every head's. Returns (B, 1, H_loc * D) in q.dtype.

    The sequence whole (one device, or layout A): `backend_lib.
    decode_execute` on the rank's heads. A split sequence (layouts B and
    C): every span's partial records (kernel 4's partial mode) over the
    live row's blocks it holds (`sla_decode.span_lut`), for every head
    whose K/V it holds, gathered and combined in span order
    (`sla_decode.sla_decode_combine`) with phi(q) Htot summed over Htot's
    D_k rows and phi(q) Ztot; the rank keeps its own heads and applies
    their Proj (`_split_attn`, at C = 1)."""
    kl, bat, heads, kvh = parts.kl, parts.batch, parts.heads, parts.kv_heads
    b, h_loc, d = q.shape
    ht, zt = st["htot"][li], st["ztot"][li]
    proj = ctx.fsdp_gather(p.sla_proj, "row")
    if not serving.is_sharded(kl):
        state = {"k": kc, "v": vc, "hblk": hb, "zblk": zb, "htot": ht,
                 "ztot": parts.from_leaf("ztot", zt, (bat, kvh, None)),
                 "lut": parts.from_leaf("live_lut", st["live_lut"][li],
                                        (bat, heads, None)),
                 "cnt": parts.from_leaf("live_cnt", st["live_cnt"][li],
                                        (bat, heads)),
                 "marg": parts.from_leaf("live_marg", st["live_marg"][li],
                                         (bat, heads))}
        if pt is not None:
            state["pt"] = pt
        o = backend_lib.decode_execute(state, {"proj": proj}, q[:, :, None],
                                       pos, dcfg, backend=backend)
        return o.to(q.dtype).reshape(b, 1, h_loc * d)
    every = not kl.heads_split  # the K/V hold every head: attend them all
    have = (bat, None if every else heads)
    live = [parts.from_leaf(key, st[key][li], have + (None,) * extra)[
        :, :, None] for key, extra in (("live_lut", 1), ("live_cnt", 0),
                                       ("live_marg", 0))]
    o = _split_attn(p, q[:, :, None], q_all[:, :, None], kc, vc, hb, zb,
                    *live, ht[:, :, None], parts.from_leaf(
                        "ztot", zt, (bat, kvh, None))[:, :, None], pos,
                    parts, dcfg, backend, pt=pt)
    return o.to(q.dtype).reshape(b, 1, h_loc * d)


def _split_attn(p, q, q_all, kc, vc, hb, zb, lut, cnt, marg, ht, zt, pos,
                parts: serving.SLAParts, dcfg, backend: str, hdiag=None,
                zdiag=None, pt=None) -> torch.Tensor:
    """Decode-time SLA attention of C tokens over a split sequence
    (layouts B and C): this rank's query heads q (B, H_loc, C, D), every
    head's q_all; the span's K/V and per-block h_j, z_j (kc, vc, hb, zb)
    and, where a chunk fills its diagonal block, each token's partial of
    it (hdiag, zdiag (B, Hkv_c, C, D, D) / (..., D)); each token's live
    row lut (B, Hc, C, K), cnt and marg (B, Hc, C) for the heads the K/V
    hold (Hc: every head where the K/V hold every head, else this rank's),
    its totals ht (B, Hkv_c, C, Dk_loc, D) at Htot's rule and zt
    (B, Hkv_c, C, D). Every span's partial records (kernel 4's partial
    mode over the live row's blocks it holds, `sla_decode.span_lut`),
    gathered and combined in span order (`sla_decode.sla_decode_combine`)
    with phi(q) Htot summed over Htot's D_k rows and phi(q) Ztot; the rank
    keeps its own heads and applies their Proj. A paged span (`pt`, the
    span's page table (B, Tn_span), one token) passes the rank's page
    pools as kc, vc, hb, zb: kernel 5's partial mode. Returns (B, H_loc,
    C, D) f32."""
    from repro_torch.kernels import sla_decode

    if dcfg.mode not in ("sla", "sparse_only"):
        raise ValueError(f"decode-time SLA supports modes 'sla' / "
                         f"'sparse_only', got {dcfg.mode!r}")
    kl = parts.kl
    b, h_loc, cdim, d = q.shape
    every = not kl.heads_split
    qh = q_all if every else q
    first = parts.start("hblk", 2)
    blocks = hb.shape[2] if pt is None else pt.shape[1]
    lut_s, cnt_s = sla_decode.span_lut(lut, cnt, first, blocks)
    state = {"k": kc, "v": vc, "hblk": hb, "zblk": zb, "lut": lut_s,
             "cnt": cnt_s}
    if pt is not None:
        state["pt"] = pt
    if hdiag is not None:
        state.update(hdiag=hdiag, zdiag=zdiag)
    rec = backend_lib.decode_partial_execute(
        state, qh, pos - first * dcfg.block_kv, dcfg, backend=backend)
    records = serving.gather_spans(rec, kl)
    # the totals' products: phi(q) Htot over this rank's D_k rows, every
    # part of them in rank order; phi(q) Ztot where Ztot is whole
    hkv = kc.shape[1]
    hc = qh.shape[1]
    qp = phi(qh, dcfg.phi).float().reshape(b, hkv, hc // hkv, cdim, d)
    dk0, dkn = parts.start("htot", 2), ht.shape[-2]
    qht = torch.einsum("bngcd,bncde->bngce", qp[..., dk0:dk0 + dkn],
                       ht).reshape(b, hc, cdim, d)
    qht = serving.gather_axes(
        qht, serving._spec_axes(parts.spec["htot"][2]), parts.mesh)
    qzt = torch.einsum("bngcd,bncd->bngc", qp, zt).reshape(b, hc, cdim)
    o_s, o_l = sla_decode.sla_decode_combine(records, qht, qzt, marg)
    if every:
        rank = kl.mesh.get_local_rank("model")
        o_s = o_s[:, rank * h_loc:(rank + 1) * h_loc]
        o_l = o_l[:, rank * h_loc:(rank + 1) * h_loc]
    o = o_s
    if dcfg.mode == "sla":
        o = o + torch.einsum("bhcd,hde->bhce", o_l,
                             ctx.fsdp_gather(p.sla_proj, "row").float())
    return o


# --------------------------------------------------------------------------
# verify-style multi-token decode (speculative drafts)
# --------------------------------------------------------------------------
def _dense_decode_chunk_attn(q, kc, vc, pos_c, kind, cfg: ArchConfig):
    """Chunked `_dense_decode_attn`: q (B, H, C, Dh) against the full
    static cache, token c masked to columns <= pos_c[c] ((C,) tensor)
    and, in a sliding-window layer, to columns > pos_c[c] - window.
    Returns (B, C, H * Dh) in q.dtype."""
    b, h, cdim = q.shape[0], q.shape[1], q.shape[2]
    hkv, smax = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, hkv, h // hkv, cdim, cfg.head_dim)
    s = torch.einsum("bkgcd,bksd->bkgcs", qg.float(), kc.float()) \
        * (cfg.head_dim**-0.5)
    idx = torch.arange(smax, device=q.device)[None, :]
    ok = idx <= pos_c[:, None]
    if kind == KIND_SWA:
        ok = ok & (idx > pos_c[:, None]
                   - (cfg.local_window or cfg.sliding_window))
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bkgcs,bksd->bkgcd", torch.softmax(s, dim=-1),
                     vc.float())
    return (o.to(q.dtype).permute(0, 3, 1, 2, 4)
            .reshape(b, cdim, h * cfg.head_dim))


@torch.no_grad()
def decode_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                 compute_dtype=torch.bfloat16, backend: str = "gather",
                 drift_threshold=None, chunk: Optional[int] = None):
    """Score a chunk of C given tokens against the cache in one pass
    (verify-style multi-token decode, for speculative drafts).

    tokens: (B, C) int. Returns (logits (B, C, V) f32, cache): logits[:, c]
    are the next-token logits after consuming tokens[:, :c + 1], the
    values C successive `decode_step` calls give, and the cache (updated
    IN PLACE, as `decode_step` updates it) holds the state after all C
    tokens. Under decode-time SLA one attention call per layer covers the
    chunk, each token with its own plan row, running totals and diagonal
    partials (`backends.decode_execute_chunk`).

    `chunk=` splits a longer token run into sub-chunks of that size.
    Requires a scalar cache["pos"] (aligned static batch); the
    continuous-batching scheduler decodes one token at a time.

    Under `activation_sharding(mesh, default_residual_spec(mesh, batch,
    cache length))` `tokens` is the global batch and the cache this rank's
    part of it (`prefill`, `make_cache`), as for `decode_step`: the C new
    K/V rows go where the rank's part holds them (a chunk may cross from
    one rank's span into the next), the boundary work and the running
    state run per token on the rank's part of the decode-SLA state, and
    attention follows the layout, over a split sequence through kernel
    4's partial records of the C tokens (their diagonal partials
    included) and a combine across ranks. Returns the logits of the
    rank's batch rows (every rank's under context parallelism)."""
    if torch.is_tensor(cache["pos"]) and cache["pos"].ndim > 0:
        raise ValueError(
            "decode_chunk requires a scalar cache['pos'] (aligned "
            "static-batch decode); per-slot continuous batching decodes "
            "one token at a time via decode_step")
    cdim = tokens.shape[1]
    if chunk is not None and cdim > chunk:
        outs = []
        for lo in range(0, cdim, chunk):
            logits, cache = decode_chunk(
                params, cfg, tokens[:, lo:lo + chunk], cache,
                compute_dtype, backend, drift_threshold)
            outs.append(logits)
        return torch.cat(outs, dim=1), cache
    pos = int(cache["pos"])
    kl = serving.active_kv_layout(tokens.shape[0], cfg.num_kv_heads)
    smax = cache["k"].shape[-2] * (1 if kl is None else kl.seq_parts)
    if pos + cdim > smax:
        raise ValueError(f"decode_chunk: {cdim} tokens from position {pos} "
                         f"overrun the {smax}-position cache")
    if "sla" in cache:
        return _decode_chunk_sla(params, cfg, tokens, cache, compute_dtype,
                                 backend, drift_threshold)
    tokens = _chunk_rows(tokens, cache, kl)
    # under context parallelism every data rank decodes every row
    with (ctx.replicated_tokens() if ctx.seq_parallel()
          else contextlib.nullcontext()):
        x = ctx.vocab_lookup(tokens, params.embed).to(compute_dtype)
        b, dev = x.shape[0], x.device
        positions = (pos + torch.arange(cdim, device=dev))[None, :] \
            .expand(b, cdim)
        kinds = layer_kinds_list(cfg)
        for li, p in enumerate(params.layers):
            q, k_new, v_new = _qkv(p, rms_norm(
                x, ctx.fsdp_gather(p.ln1, "rep")), cfg, positions)
            kc, vc = cache["k"][li], cache["v"][li]
            _chunk_write(kc, vc, k_new, v_new, pos, kl, smax)
            o = _dense_chunk_attn(q, kc, vc, pos, kinds[li], cfg, kl, smax)
            x = x + ctx.from_tp(o @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))
            f, _ = _ffn(p, rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")), cfg)
            x = x + f
        x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    cache["pos"] = pos + cdim
    return logits_from_hidden(params, x), cache


def _chunk_rows(tokens, cache: dict, kl):
    """A chunk's tokens at this rank's batch rows (the global batch
    without a mesh), held to the cache's rows."""
    if kl is None:
        return tokens
    tokens = ctx.batch_rows(tokens)
    if cache["k"].shape[1] != tokens.shape[0]:
        raise ValueError(
            f"the cache holds {cache['k'].shape[1]} batch rows on this "
            f"rank, the chunk {tokens.shape[0]}: make it under the same "
            f"activation_sharding scope")
    return tokens


def _chunk_write(kc, vc, k_new, v_new, pos: int, kl, length: int):
    """Write a chunk's C new K/V rows (B, Hkv_c, C, D) from position pos,
    in place: into the whole sequence, or the rows this rank's span holds
    where the layout splits it."""
    if serving.is_sharded(kl):
        start, _ = kl.span(length)
        serving.write_token(kc, k_new, pos, start, length)
        serving.write_token(vc, v_new, pos, start, length)
        return
    cdim = k_new.shape[2]
    kc[:, :, pos:pos + cdim] = k_new.to(kc.dtype)
    vc[:, :, pos:pos + cdim] = v_new.to(vc.dtype)


def _dense_chunk_attn(q, kc, vc, pos: int, kind, cfg: ArchConfig, kl,
                      length: int):
    """Dense attention of a chunk q (B, H_loc, C, Dh), token c at pos + c,
    over the cache (its K/V already written): one device's masked softmax
    (`_dense_decode_chunk_attn`), or the flash-decoding partials and
    combine where the layout splits the sequence. Returns (B, C,
    H_loc * Dh) in q.dtype."""
    b, _, cdim, _ = q.shape
    if not serving.is_sharded(kl):
        return _dense_decode_chunk_attn(
            q, kc, vc, pos + torch.arange(cdim, device=q.device), kind, cfg)
    window = ((cfg.local_window or cfg.sliding_window)
              if kind == KIND_SWA else 0)
    o = serving.sharded_decode_attn(q, kc, vc, pos, kl, length, window)
    return o.to(q.dtype).transpose(1, 2).reshape(b, cdim, -1)


def _decode_chunk_sla(params, cfg: ArchConfig, tokens, cache, compute_dtype,
                      backend: str, drift_threshold=None):
    """Chunked decode-time SLA on a static (scalar-pos) cache.

    Per layer a loop over the C tokens runs `_decode_step_sla`'s
    boundary and state phases 1-3 in the same order on the same tensors
    (so the cache ends as C steps leave it), recording each token's live
    plan row (lut/cnt/marg) and its at-time-c totals; then ONE chunked
    attention call covers all C tokens.

    Snapshot protocol (why the end-of-chunk hblk serves every token):
    token c's marginal set holds only completed blocks j < row_c, and no
    later chunk token writes those (tokens write their own row, >= row_c).
    The one exception is the forced critical diagonal block row_c, still
    filling inside the chunk: its at-time partial rides per token
    (state["hdiag"] / ["zdiag"]) and the kernel substitutes it for the
    stored block at the LUT's diagonal entry. The sparse branch needs no
    protocol: the chunk's KV is written before attention and token c
    masks columns > pos + c.

    Under a mesh the phases run on this rank's part of the state as the
    scalar-pos `_decode_step_sla` runs them (the per-block update where
    the rank's span holds the token's block, the boundary work for every
    head, the drift gate's MIN across the data ranks); a token's diagonal
    partial is the span's that holds its block (zeros elsewhere, where no
    LUT entry of the token is its diagonal)."""
    backend_lib.resolve_decode(backend)
    b_all, cdim = tokens.shape
    pos = int(cache["pos"])
    st = cache["sla"]
    sla = cfg.sla
    bq, bkv = sla.block_q, sla.block_kv
    kl = serving.active_kv_layout(b_all, cfg.num_kv_heads)
    tn = cache["k"].shape[-2] * (1 if kl is None else kl.seq_parts) // bkv
    length = tn * bkv
    parts = _sla_parts(cfg, b_all, length, kl)
    bat, heads, kvh = parts.batch, parts.heads, parts.kv_heads
    first = parts.start("hblk", 2)
    tokens = _chunk_rows(tokens, cache, kl)
    dcfg = sla.decode_plan_cfg(tn)
    kinds = layer_kinds_list(cfg)
    nl = cfg.num_layers
    if drift_threshold is None:
        drift_threshold = sla.drift_thresholds(nl)
    thresholds = torch.broadcast_to(torch.as_tensor(
        drift_threshold, dtype=torch.float32), (nl,)).tolist()
    g = cfg.num_heads // cfg.num_kv_heads
    pos_c = [pos + c for c in range(cdim)]
    row_c = [p_ // bq for p_ in pos_c]
    bnd_c = [p_ % bq == 0 for p_ in pos_c]
    # the rows bookkeeping is layer-independent: replay the appends
    rows = st["rows"]
    app_c = []
    for c in range(cdim):
        app_c.append(bnd_c[c] and rows < row_c[c])
        rows += int(app_c[-1])
    plan = st["plan"]
    # under context parallelism every data rank decodes every row
    with (ctx.replicated_tokens() if ctx.seq_parallel()
          else contextlib.nullcontext()):
        x = ctx.vocab_lookup(tokens, params.embed).to(compute_dtype)
        b, dev = x.shape[0], x.device
        positions = torch.tensor(pos_c, device=dev)[None, :].expand(b, cdim)
        blk = torch.arange(tn, device=dev)
        for li, p in enumerate(params.layers):
            q, k_new, v_new = _qkv(p, rms_norm(
                x, ctx.fsdp_gather(p.ln1, "rep")), cfg, positions)
            kc, vc = cache["k"][li], cache["v"][li]
            _chunk_write(kc, vc, k_new, v_new, pos, kl, length)
            hb, zb, kp_sum = st["hblk"][li], st["zblk"][li], st["kpool"][li]
            q_all = serving.reshard(q, (bat, heads, None, None),
                                    (bat, None, None, None), parts.mesh)
            qf, kf, vf = q_all.float(), k_new.float(), v_new.float()
            phik = phi(kf, sla.phi)                  # (B, Hkv_c, C, D)
            routing = _routing(p, dcfg, every=True)
            lplan = plan_lib.plan_map(lambda leaf: leaf[li], plan)  # views
            ht, zt = st["htot"][li], st["ztot"][li]
            qp_sum = st["qpool"][li]
            luts, cnts, margs, hts, zts, hds, zds = [], [], [], [], [], [], []
            for c in range(cdim):
                row = row_c[c]
                own = first <= row < first + hb.shape[2]
                qf_c = qf[:, :, c]
                # 1. append the just-completed row (pooled k before the
                # current block's new token)
                if app_c[c]:
                    _append_row(st, li, lplan, parts, routing,
                                parts.from_leaf("kpool", kp_sum,
                                                (bat, None, None, None)),
                                row, g, dcfg)
                # 2. O(1) running-state update
                hupd = phik[:, :, c, :, None] * vf[:, :, c, None, :]
                if own:
                    _blk_update(hb, hupd, row, first)
                    _blk_update(zb, phik[:, :, c], row, first)
                    _blk_update(kp_sum, kf[:, :, c], row, first)
                ht += parts.to_leaf("htot", hupd, (bat, kvh, None, None))
                zt += parts.to_leaf("ztot", phik[:, :, c], (bat, kvh, None))
                at = row - first if own else 0
                hds.append(hb[:, :, at].clone() if own
                           else torch.zeros_like(hb[:, :, at]))
                zds.append(zb[:, :, at].clone() if own
                           else torch.zeros_like(zb[:, :, at]))
                # 3. the live row's structure, at a boundary only
                if bnd_c[c]:
                    kp_all = parts.from_leaf("kpool", kp_sum,
                                             (bat, None, None, None))
                    cnt_div = torch.clamp(torch.clamp(
                        (pos_c[c] + 1) - blk * bkv, max=bkv), 1, bkv)[:, None]
                    kpm_live = torch.repeat_interleave(
                        kp_all / cnt_div.float(), g, dim=1)
                    _live_row(st, li, lplan, parts, routing, qf_c, kpm_live,
                              row, thresholds[li], dcfg)
                else:
                    qp_sum += qf_c
                luts.append(st["live_lut"][li].clone())
                cnts.append(st["live_cnt"][li].clone())
                margs.append(st["live_marg"][li].clone())
                hts.append(ht.clone())
                zts.append(zt.clone())

            # 4. attention: one chunked call over the C tokens
            if kinds[li] == KIND_SLA:
                split = serving.is_sharded(kl)
                # the live rows of the heads attended here: the rank's own,
                # every head where a split sequence's K/V hold them all
                hq = None if split and not kl.heads_split else heads

                def per_token(key, snaps):
                    have = (bat, hq) + (None,) * (snaps[0].ndim - 2)
                    return torch.stack([parts.from_leaf(key, s_, have)
                                        for s_ in snaps], dim=2)

                lut, cnt, marg = (per_token(key, snaps) for key, snaps in (
                    ("live_lut", luts), ("live_cnt", cnts),
                    ("live_marg", margs)))
                ztc = torch.stack([parts.from_leaf("ztot", z_,
                                                   (bat, kvh, None))
                                   for z_ in zts], dim=2)
                htc = torch.stack(hts, dim=2)
                hdiag, zdiag = torch.stack(hds, dim=2), torch.stack(zds, 2)
                del hds, zds, hts, zts
                if split:
                    o = _split_attn(p, q, q_all, kc, vc, hb, zb, lut, cnt,
                                    marg, htc, ztc, pos, parts, dcfg,
                                    backend, hdiag, zdiag)
                else:
                    state = {"k": kc, "v": vc, "hblk": hb, "zblk": zb,
                             "hdiag": hdiag, "zdiag": zdiag, "htot": htc,
                             "ztot": ztc, "lut": lut, "cnt": cnt,
                             "marg": marg}
                    o = backend_lib.decode_execute_chunk(
                        state, {"proj": ctx.fsdp_gather(p.sla_proj, "row")},
                        q, pos, dcfg, backend=backend)
                    del state
                o = o.transpose(1, 2).reshape(b, cdim, -1).to(x.dtype)
            else:
                o = _dense_chunk_attn(q, kc, vc, pos, kinds[li], cfg, kl,
                                      length)
            x = x + ctx.from_tp(o @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))
            f, _ = _ffn(p, rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")), cfg)
            x = x + f
        st["rows"] = rows
        x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    cache["pos"] = pos + cdim
    return logits_from_hidden(params, x), cache


# --------------------------------------------------------------------------
# per-slot caches (continuous batching)
# --------------------------------------------------------------------------
COUNTER_KEYS = ("extends", "replans", "reuses", "retention")


def _empty_decode_state(cfg: ArchConfig, batch: int, max_len: int, device,
                        per_slot: bool, pooled: bool) -> dict:
    """The decode-SLA state of an empty cache: what `_seed_decode_state`
    gives for an empty prompt (an all-negligible plan, zero partials and
    totals), built directly so that no (L, B, Hkv, Tn, D, D) block
    buffer is made when `pooled` keeps the partials in page pools. Under
    a mesh each leaf is this rank's part, allocated at that shape only."""
    shapes = serving.local_shapes(
        decode_state_shapes(cfg, batch, max_len, per_slot, pooled), batch)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    # plan_from_mask of an all-negligible mask: every index LUT pads
    # with block 0 and nothing is counted or marginal
    plan = plan_lib.SLAPlan(
        mc=torch.full(shapes["plan/mc"], -1, dtype=torch.int8,
                      device=device),
        lut=torch.zeros(shapes["plan/lut"], **i32),
        counts=torch.zeros(shapes["plan/counts"], **i32),
        col_lut=torch.zeros(shapes["plan/col_lut"], **i32),
        col_counts=torch.zeros(shapes["plan/col_counts"], **i32),
        marginal=torch.zeros(shapes["plan/marginal"], **f32))
    st = {"htot": torch.zeros(shapes["htot"], **f32),
          "ztot": torch.zeros(shapes["ztot"], **f32),
          "qpool": torch.zeros(shapes["qpool"], **f32),
          "plan": plan,
          "rows": torch.zeros((batch,), **i32) if per_slot else 0,
          "live_lut": torch.zeros(shapes["live_lut"], **i32),
          "live_cnt": torch.zeros(shapes["live_cnt"], **i32),
          "live_marg": torch.zeros(shapes["live_marg"], **i32),
          "extends": torch.zeros(shapes["extends"], **i32),
          "replans": torch.zeros(shapes["replans"], **i32),
          "reuses": torch.zeros(shapes["reuses"], **i32),
          "retention": torch.ones(shapes["retention"], **f32)}
    if not pooled:
        for key in ("hblk", "zblk", "kpool"):
            st[key] = torch.zeros(shapes[key], **f32)
    return st


def _slot_pos(cache: dict, batch: int, per_slot: bool, device):
    if per_slot:
        cache["pos"] = torch.zeros((batch,), dtype=torch.int32,
                                   device=device)
        cache["pos_host"] = np.zeros((batch,), np.int64)
    else:
        cache["pos"] = 0


def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, decode_sla: Optional[bool] = None,
               per_slot: bool = False, device=None) -> dict:
    """Empty decode cache on `device` (the card unless the caller asks
    for the CPU). `decode_sla` (default: cfg.sla.decode_mode == "sla")
    adds the decode-time SLA state (an empty incremental plan and zero
    running H/Z); a filled decode cache comes from
    `prefill(decode_max_len=)`.

    `per_slot=True` lays the cache out for continuous batching: `pos`
    becomes a (B,) int32 tensor (with its host mirror `pos_host`) and the
    decode-SLA `rows` and counters per-slot (B,) / (L, B), so each batch
    row advances through its own sequence and `insert_slot` can copy a
    fresh prefill into any slot.

    Under `activation_sharding(mesh, ...)` `batch` is the global batch and
    the K/V leaves, and the decode-SLA state's, come out as this rank's
    part under `sharding.cache_shardings`, allocated at that shape only
    (the per-slot counters (L, B) too; `pos`, `pos_host` and a per-slot
    `rows` stay whole on every rank; a split sequence holds whole KV
    blocks of decode-time SLA in each rank's span)."""
    dev = resolve_device(device)
    if decode_sla is None:
        decode_sla = cfg.sla.decode_mode == "sla"
    if decode_sla:
        kl = serving.active_kv_layout(batch, cfg.num_kv_heads)
        if kl is not None:  # refuses spans of part blocks
            kl.check_length(max_len, cfg.sla.block_kv)
    kc, vc, _ = _kv_cache(cfg, batch, max_len, dtype, dev, zeros=True)
    cache = {"k": kc, "v": vc}
    _slot_pos(cache, batch, per_slot, dev)
    if decode_sla:
        _check_decode_grid(cfg, max_len, max_len)
        cache["sla"] = _empty_decode_state(cfg, batch, max_len, dev,
                                           per_slot, pooled=False)
    return cache


def _put_slot(slot: int):
    """The whole-leaf copy of an admission: `put(name, live, one)` writes a
    batch-1 leaf (L, 1, ...) into batch row `slot` of a (L, B, ...) live
    leaf, in place (values only: no storage is shared)."""
    def put(name: str, live: torch.Tensor, one: torch.Tensor) -> None:
        live[:, slot] = one[:, 0].to(live.dtype)
    return put


def _insert_slot_state(cache: dict, single: dict, slot: int, keys, put):
    """The per-slot half of an admission: pos, and under decode-SLA the
    listed state leaves, the plan rows ("plan/<field>"), `rows` and the
    counters (each (L,) counter as an (L, 1) leaf), every leaf copied by
    `put(name, live, one)`."""
    if ("sla" in cache) != ("sla" in single):
        raise ValueError(
            "decode-SLA 'sla' state mismatch: the slot cache and the "
            "prefill cache must both (or neither) carry it")
    cache["pos"][slot] = int(single["pos"])
    cache["pos_host"][slot] = int(single["pos"])
    if "sla" not in cache:
        return
    s, t = cache["sla"], single["sla"]
    for key in keys:
        put(key, s[key], t[key])
    for name in plan_lib.PLAN_LEAVES:
        put(f"plan/{name}", getattr(s["plan"], name),
            getattr(t["plan"], name))
    s["rows"][slot] = int(t["rows"])
    for key in COUNTER_KEYS:
        put(key, s[key], t[key][:, None])


def insert_slot(cache: dict, single: dict, slot: int,
                cfg: ArchConfig) -> dict:
    """Copy a batch-1 prefill cache into decode slot `slot` of a per-slot
    cache (`make_cache(..., per_slot=True)`), in place; returns `cache`.

    `single` comes from `prefill(params, cfg, prompt[None, :], ...)` over
    the SAME max_len (decode-SLA prefills size their caches with
    `decode_max_len`; dense callers pad k/v first). Every piece of
    request state rides along: KV rows, the incremental decode plan's
    rows, the running H/Z state and the pooled q/k features, so the
    admitted request decodes exactly as in a fresh aligned batch. `cfg`
    gives the leaves' global shapes.

    Under `activation_sharding(mesh, default_residual_spec(mesh, batch,
    max_len))`, the cache's scope, `slot` is the global slot and `cache`
    this rank's part; `single` is what that prefill returns under the
    same mesh at batch 1 (its leaves at the batch-1 placement: the
    sequence over "data"). Every leaf (K/V, h_j, z_j, the pooled k and q,
    the totals, the plan rows, the live row, the counters) is moved from
    the one placement to the other one layer at a time (`serving.put_row`)
    and written by the ranks that hold slot `slot`'s rows. Without a mesh
    every leaf is whole, the move is the identity and the copy plain."""
    if single["k"].shape[1] != 1:
        raise ValueError(
            f"insert_slot takes a batch-1 prefill cache (got batch "
            f"{single['k'].shape[1]})")
    kl_c = _scope_layout(cache["pos"].shape[0], cfg)
    length = cache["k"].shape[3] * (1 if kl_c is None else kl_c.seq_parts)
    _, _, put = _slot_movers(cfg, cache, single, slot, length)
    _insert_slot_state(cache, single, slot,
                       ("hblk", "zblk", "htot", "ztot", "kpool", "qpool",
                        "live_lut", "live_cnt", "live_marg"), put)
    put("k", cache["k"], single["k"])
    put("v", cache["v"], single["v"])
    return cache


def _scope_layout(batch: int, cfg: ArchConfig
                  ) -> Optional[serving.KVLayout]:
    """The layout the rules give a `batch`-row KV cache on the active
    mesh (None without one), read without the residual spec's check: an
    admission runs under the cache's scope or the prefill's."""
    lay = ctx.layout()
    return None if lay is None else serving.kv_layout(lay.mesh, batch,
                                                      cfg.num_kv_heads)


def _slot_movers(cfg: ArchConfig, cache: dict, single: dict, slot: int,
                 length: int, prompt_only: bool = False):
    """(many, one, put) of an admission into slot `slot` of a per-slot or
    paged cache of `length` positions (global): the placements of the
    batch's cache (`many`, per-slot counters) and of the batch-1 prefill
    (`one`) on the active mesh (every leaf whole without one), and
    `put(name, live, new)`, which moves each layer of a batch-1 leaf from
    the one placement to the other (`serving.put_row`; a counter's
    column `slot` at the layers the rank holds) and writes it where the
    rank holds slot `slot`. Refuses a prefill of another length (a
    `slot_state_from_prefill` snapshot holds no K/V to tell it by),
    except for its K/V with `prompt_only` (a paged admission reads only
    its prompt's pages: `one` places them at the prefill's own length)."""
    batch = cache["pos"].shape[0]  # the per-slot positions are whole
    lay = ctx.layout()
    mesh = None if lay is None else lay.mesh
    kl_c, kl_s = (_scope_layout(b, cfg) for b in (batch, 1))
    have = length if "k" not in single else single["k"].shape[3] * (
        1 if kl_s is None else kl_s.seq_parts)
    if have != length and not (prompt_only and "sla" not in cache):
        raise ValueError(
            f"cache length mismatch: the slot cache holds {length} "
            f"positions but the prefill cache has {have}; prefill with "
            f"decode_max_len (or pad k/v) to the scheduler's max_len first")

    def parts(kl, b, per_slot, n):
        kv = (cfg.num_layers, b, cfg.num_kv_heads, n, cfg.head_dim)
        shapes = {"k": kv, "v": kv}
        if "sla" in cache:
            shapes.update(decode_state_shapes(cfg, b, length, per_slot))
        return serving.SLAParts(kl, shapes, b)

    many, one = parts(kl_c, batch, True, length), parts(kl_s, 1, False, have)

    def put(name, live, new):
        if name in COUNTER_KEYS:
            # (L, B), its layers split by the rule: column `slot` at the
            # layers this rank holds
            live[:, slot] = serving.reshard(
                new[:, 0], one.full[name], many.full[name][:1],
                mesh).to(live.dtype)
            return
        for li in range(live.shape[0]):
            serving.put_row(live[li], new[li], slot, one.spec[name],
                            many.spec[name], mesh)

    return many, one, put


# --------------------------------------------------------------------------
# paged serving: page pools + page table. Host-side refcounting and CoW
# live in serving/pages.py; these are the device-side constructors and
# copies, all in place.
# --------------------------------------------------------------------------
PAGED_POOL_KEYS = ("hblk", "zblk", "kpool")  # per-block leaves that move
#                                              from per-slot state into the
#                                              global page pools under paging
PAGED_SLOT_KEYS = ("htot", "ztot", "qpool", "live_lut", "live_cnt",
                   "live_marg")


def make_paged_cache(cfg: ArchConfig, batch: int, max_len: int,
                     num_pages: int, dtype=torch.bfloat16,
                     decode_sla: Optional[bool] = None, device=None) -> dict:
    """Paged decode cache on `device` (the card unless the caller asks
    for the CPU): global pools of block_kv-sized pages plus a per-slot
    page table, in place of make_cache(per_slot=True)'s monolithic
    (L, B, Hkv, max_len, Dh) slabs.

      kp/vp   (L, P, Hkv, bkv, Dh)  KV page pools
      pt      (B, Tn) int32         logical block -> physical page, shared
                                    by every layer
      slap.*  (L, P, Hkv, ...)      decode-SLA per-block h (D x D), z and
                                    kpool (D) partials at the same ids

    Physical page 0 is the permanent all-zero page; the scheduler pins
    one private scratch page per slot on top so inactive slots (which
    keep stepping through every batched dispatch) write somewhere
    harmless. Per-slot decode-SLA state (plan rows, totals, live-row LUT,
    counters) keeps the per-slot layout; `pos` is a (B,) tensor with its
    host mirror `pos_host`.

    Under `activation_sharding(mesh, default_residual_spec(mesh, batch,
    max_len))` `batch` is the global batch, and each rank's pools hold
    what its part of the per-slot cache the paged one stands for would
    (`serving.kv_layout`): the pages of its batch rows (layout A: a data
    rank's slots, its KV heads over "model"; layouts B and C: every slot's
    pages at the logical blocks of its span, whole pages, every KV head
    or its own). The pools keep the global page ids (page 0 the zero page
    on every rank, each slot's scratch page in its own data rank's pool),
    so P is whole on every rank, at the rank's KV heads; `pt`, `pos` and
    `pos_host` are whole on every rank (the host pushes the whole table),
    and the per-slot decode-SLA state is the rank's part of its rules
    (`make_cache(per_slot=True)`'s). Where the batch is split over data
    ranks the cache records which data rank last wrote each page
    (`page_owner`, host numpy: an admission's pages are its slot's data
    rank's, `copy_page` gives a page its source's, and a copy of the zero
    page is every rank's), and `set_page_table` refuses a table that
    would read a page from another rank's pool."""
    sla = cfg.sla
    if max_len % sla.block_kv:
        raise ValueError(
            f"paged cache needs block-aligned max_len (got {max_len} "
            f"for block_kv={sla.block_kv})")
    dev = resolve_device(device)
    tn = max_len // sla.block_kv
    nl, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kl = serving.active_kv_layout(batch, hkv)
    if kl is not None:  # whole pages in each span
        kl.check_length(max_len, sla.block_kv)
        hkv = kl.local_shape((nl, batch, hkv, max_len, dh))[2]
    pshape = (nl, num_pages, hkv, sla.block_kv, dh)
    cache = {"kp": torch.zeros(pshape, dtype=dtype, device=dev),
             "vp": torch.zeros(pshape, dtype=dtype, device=dev),
             "pt": torch.zeros((batch, tn), dtype=torch.int32, device=dev)}
    _slot_pos(cache, batch, True, dev)
    if kl is not None and kl.dp > 1:
        cache["page_owner"] = np.full((num_pages,), -1, np.int64)
        cache["page_owner"][0] = -2  # the zero page, on every rank
    if decode_sla is None:
        decode_sla = sla.decode_mode == "sla"
    if decode_sla:
        _check_decode_grid(cfg, max_len, max_len)
        f32 = dict(dtype=torch.float32, device=dev)
        cache["slap"] = {
            "hblk": torch.zeros((nl, num_pages, hkv, dh, dh), **f32),
            "zblk": torch.zeros((nl, num_pages, hkv, dh), **f32),
            "kpool": torch.zeros((nl, num_pages, hkv, dh), **f32)}
        cache["sla"] = _empty_decode_state(cfg, batch, max_len, dev, True,
                                           pooled=True)
    return cache


def insert_slot_state_paged(cache: dict, single: dict, slot: int,
                            cfg: ArchConfig) -> dict:
    """Copy only the PER-SLOT half of a batch-1 prefill (or a
    `slot_state_from_prefill` snapshot) into `slot` of a paged cache, in
    place: pos and, under decode-SLA, plan rows, running totals, pooled
    q and counters. Page contents are written by `insert_slot_paged`, or
    not at all when every prompt page was a prefix-cache hit (the
    full-prompt snapshot fast path). `cfg` gives the leaves' global
    shapes. Returns `cache`.

    Under a mesh (the cache's scope, as `insert_slot`) each leaf moves
    from the batch-1 prefill's placement to the cache's and is written
    where the rank holds the slot. The pages of the hit fast path must
    be in the slot's data rank's pool: `set_page_table` refuses a row
    that names another data rank's."""
    length = cache["pt"].shape[1] * cfg.sla.block_kv
    _, _, put = _slot_movers(cfg, cache, single, slot, length)
    _insert_slot_state(cache, single, slot, PAGED_SLOT_KEYS, put)
    return cache


def slot_state_from_prefill(single: dict) -> dict:
    """The per-slot half of a batch-1 prefill cache (what
    `insert_slot_state_paged` consumes): everything except KV rows and
    per-block partials, so a snapshot keeps no (1, Hkv, S, ...) buffer
    alive. This is the full-prompt snapshot the scheduler caches for
    exact prefix hits. Its leaves are the prefill's own tensors, which
    nothing writes: admissions copy them into the live cache."""
    out = {"pos": single["pos"]}
    if "sla" in single:
        st = single["sla"]
        out["sla"] = {key: st[key] for key in st
                      if key not in PAGED_POOL_KEYS}
    return out


def insert_slot_paged(cache: dict, single: dict, slot: int,
                      page_ids, cfg: ArchConfig) -> dict:
    """Copy a batch-1 prefill cache into `slot` of a paged cache, in place.

    `page_ids` (n_prompt_pages,) names the physical page of each prompt
    block, host-allocated or interned before the call. KV rows and (under
    decode-SLA) the per-block h/z/kpool partials land in the pools at
    those ids; the per-slot state goes through `insert_slot_state_paged`.
    Prefix-interned hit pages are rewritten with the same contents
    (causal attention makes page j a pure function of the padded tokens
    below its end). The page table itself is host-owned and pushed
    separately (`set_page_table`). `cfg` gives the leaves' global shapes.
    Returns `cache`.

    Under a mesh (the cache's scope; `single` the batch-1 prefill under
    its own, as for `insert_slot`) each K/V and per-block leaf is
    gathered a layer at a time to the cache's KV heads over its whole
    sequence (`serving.reshard`; the identity without a mesh), and the
    ranks that hold slot `slot`'s rows write the pages of the logical
    blocks in their span. Where the batch is split over data ranks, the
    pages become the slot's data rank's (`page_owner`)."""
    if single["k"].shape[1] != 1:
        raise ValueError(
            f"insert_slot_paged takes a batch-1 prefill cache (got "
            f"batch {single['k'].shape[1]})")
    bkv = cfg.sla.block_kv
    batch, tn = cache["pt"].shape
    ids = [int(i) for i in np.asarray(page_ids).reshape(-1)]
    npp = len(ids)
    many, one, put = _slot_movers(cfg, cache, single, slot, tn * bkv,
                                  prompt_only=True)
    have = one.shapes["k"][3]
    if have < npp * bkv:
        raise ValueError(
            f"prefill cache holds {have} positions but {npp} pages of "
            f"{bkv} were requested")
    part = _paged_part(cache, _scope_layout(batch, cfg), bkv)
    rows = part["rows"].shape[0]
    first, n = part["span"]
    held = part["row0"] <= slot < part["row0"] + rows
    owner = cache.get("page_owner")
    if owner is not None:  # the zero page stays every rank's
        owner[[pid for pid in ids if pid]] = slot // rows
    _insert_slot_state(cache, single, slot, PAGED_SLOT_KEYS, put)
    # this rank's blocks of the prompt's pages: those of its span below npp
    mine = list(range(first, min(first + n, npp)))
    dev = cache["kp"].device
    sel = torch.tensor(mine, dtype=torch.long, device=dev)
    pids = torch.tensor([ids[j] for j in mine], dtype=torch.long, device=dev)
    pools = [("k", cache["kp"], single["k"]), ("v", cache["vp"], single["v"])]
    if "sla" in cache:
        pools += [(key, cache["slap"][key], single["sla"][key])
                  for key in PAGED_POOL_KEYS]
    for name, pool, leaf in pools:
        # batch whole, the cache's KV heads, the sequence (blocks) whole
        want = (None, many.spec[name][1], None) + tuple(many.spec[name][3:])
        for li in range(pool.shape[0]):
            x = serving.reshard(leaf[li], one.spec[name], want, many.mesh)[0]
            if not held or not mine:
                continue
            if name in ("k", "v"):  # (Hkv_c, S, Dh) -> (Hkv_c, Tn, bkv, Dh)
                x = x[:, :npp * bkv].reshape(x.shape[0], npp, bkv, -1)
            pool[li, pids] = x.index_select(1, sel).movedim(1, 0).to(
                pool.dtype)
    return cache


def set_page_table(cache: dict, table) -> dict:
    """Publish the host-owned page table `table` (B, Tn) to a paged cache,
    in place (the scheduler owns the table and overwrites it between
    dispatches). Returns `cache`.

    Where the batch is split over data ranks (under the cache's scope;
    the cache records which data rank wrote each page, `page_owner`), a
    row that names a page another data rank's pool holds is refused
    (ValueError): prefix pages are not shared across data ranks, and a
    rank reads only its own pool. Every rank checks the whole table, so
    all refuse alike."""
    table = np.asarray(table, np.int32)
    owner = cache.get("page_owner")
    if owner is not None:
        lay = ctx.layout()
        if lay is None:
            raise ValueError("set_page_table of a cache split over data "
                             "ranks runs under the cache's scope")
        b = table.shape[0]
        rank = np.arange(b)[:, None] // (b // lay.dp)
        held = owner[table]
        bad = np.argwhere((held >= 0) & (held != rank))
        if len(bad):
            slot, blk = bad[0]
            page = int(table[slot, blk])
            raise ValueError(
                f"slot {slot} (data rank {int(rank[slot, 0])}) names page "
                f"{page}, which data rank {int(owner[page])}'s pool "
                f"holds: prefix pages are not shared across data ranks")
    cache["pt"].copy_(torch.from_numpy(table))
    return cache


def copy_page(cache: dict, dst: int, src: int) -> dict:
    """Device-side page copy `src -> dst` across every pool (KV and, under
    decode-SLA, the h/z/kpool partials), in place. The scheduler's
    copy-on-write pass uses it both to duplicate a shared page before a
    divergent write and to ZERO a freshly allocated decode page (src =
    the permanent zero page: the partials accumulate onto the page, so a
    recycled page must start clean). Returns `cache`."""
    pools = [cache["kp"], cache["vp"]] + list(cache.get("slap", {}).values())
    for pool in pools:
        pool[:, dst] = pool[:, src]
    owner = cache.get("page_owner")
    if owner is not None:  # a mesh: every rank copies its own pool's page
        owner[dst] = owner[src]
    return cache


def paged_dense_view(cfg: ArchConfig, cache: dict) -> dict:
    """The monolithic per-slot cache a paged cache represents (page-
    gathered KV slabs and per-block partials, copies). Test and debugging
    aid: the paged-vs-monolithic checks compare this view bitwise with
    the unpaged cache, and `chip_smoke.py` runs the monolithic decode
    kernel on it. Under a mesh (the cache's scope) it is this rank's part
    of that cache: its batch rows, its KV heads, its span's blocks."""
    kl = serving.active_kv_layout(cache["pt"].shape[0], cfg.num_kv_heads)
    pt = _paged_part(cache, kl, cfg.sla.block_kv)["pt"]

    def view(pool):  # (L, P, Hkv, ...) -> (L, B, Hkv, Tn, ...)
        return backend_lib.gather_pages(pool, pt, axis=1)

    out = {"k": view(cache["kp"]).flatten(-3, -2),  # (L, B, Hkv, S, Dh)
           "v": view(cache["vp"]).flatten(-3, -2), "pos": cache["pos"],
           "pos_host": cache["pos_host"]}
    if "sla" in cache:
        st = dict(cache["sla"])
        for key in PAGED_POOL_KEYS:
            st[key] = view(cache["slap"][key])
        out["sla"] = st
    return out


class _SlotPlaces:
    """Where a slot's entries of a per-slot or paged cache's leaves sit on
    this rank: `loc(name, dim, index)` is the local index of a global
    `index` along dim `dim` of leaf `name` (the per-slot cache a paged one
    stands for: "k", "v", the "sla" leaves and "plan/<field>"), or None
    where another rank holds it; `length` the cache's positions, `tm` the
    plan's rows and `bq` its block. The leaves' rules (`serving.SLAParts`,
    from `cfg`'s global shapes) place them; without a mesh (`parts` None)
    every index is its own."""

    def __init__(self, cache: dict, cfg: ArchConfig):
        batch = cache["pos"].shape[0]
        kl = _scope_layout(batch, cfg)
        self.bq = cfg.sla.block_q
        self.length = (cache["pt"].shape[1] * cfg.sla.block_kv
                       if "kp" in cache else cache["k"].shape[3]
                       * (1 if kl is None else kl.seq_parts))
        self.tm = self.length // self.bq
        self.parts = None
        if kl is None:
            return
        kv = (cfg.num_layers, batch, cfg.num_kv_heads, self.length,
              cfg.head_dim)
        shapes = {"k": kv, "v": kv}
        if "sla" in cache:
            shapes.update(decode_state_shapes(cfg, batch, self.length,
                                              per_slot=True))
        self.parts = serving.SLAParts(kl, shapes, batch)

    def loc(self, name: str, dim: int, index: int) -> Optional[int]:
        if self.parts is None:
            return index
        parts, at = serving._axes_index(serving._spec_axes(
            self.parts.full[name][dim]), self.parts.mesh)
        n = self.parts.shapes[name][dim] // parts
        local = index - at * n
        return local if 0 <= local < n else None


def snapshot_slots(cache: dict, slots, cfg: ArchConfig) -> dict:
    """Copies of everything one decode step writes for the batch rows
    `slots` of a per-slot or paged cache: the K/V row at each slot's
    position (its page and offset, paged), the h/z/kpool partials of its
    live block, the plan row that block boundary would append, the
    slot's column LUT (an append writes the entry at each column's fill
    level), and every smaller per-slot leaf (totals, pooled q, live row,
    column fill levels, rows, counters, positions). `restore_slots` puts
    them back, so a step over the whole batch can leave these slots as
    they were. Reads the page table on the host (a sync) for paged
    caches. `cfg` gives the leaves' global shapes.

    Under a mesh (the cache's scope) each rank copies its part: the
    entries its leaves hold of each slot (`_SlotPlaces`) and its pools'
    pages."""
    paged = "kp" in cache
    st = cache.get("sla")
    places = _SlotPlaces(cache, cfg)
    loc = places.loc
    snap = []
    for j in slots:
        p = int(cache["pos_host"][j])
        one = {"slot": j, "pos": p, "kv": {}, "blk": {}, "row": {},
               "whole": {}}
        if paged:
            bkv, tn = cache["kp"].shape[3], cache["pt"].shape[1]
            blk = min(p // bkv, tn - 1)
            page, off = int(cache["pt"][j, blk]), p % bkv
            for key in ("kp", "vp"):
                one["kv"][key] = (page, off, cache[key][:, page, :,
                                                        off].clone())
            for key, pool in cache.get("slap", {}).items():
                one["blk"][key] = (page, pool[:, page].clone())
        else:
            at = min(p, places.length - 1)
            for key in ("k", "v"):
                jl, al = loc(key, 1, j), loc(key, 3, at)
                if jl is not None and al is not None:
                    one["kv"][key] = (jl, al,
                                      cache[key][:, jl, :, al].clone())
        if st is not None:
            plan = st["plan"]
            live = min(p // places.bq, places.tm - 1)
            prev = min(max(p // places.bq - 1, 0), places.tm - 1)
            if not paged:
                for key in PAGED_POOL_KEYS:
                    jl, ll = loc(key, 1, j), loc(key, 3, live)
                    if jl is not None and ll is not None:
                        one["blk"][key] = (jl, ll, st[key][:, jl, :,
                                                           ll].clone())
            for name in ("mc", "lut", "counts", "marginal"):
                jl, pl = loc(f"plan/{name}", 1, j), loc(f"plan/{name}", 3,
                                                        prev)
                if jl is not None and pl is not None:
                    one["row"][name] = (jl, pl, getattr(plan, name)[
                        :, jl, :, pl].clone())
            for key in ("col_lut", "col_counts") + PAGED_SLOT_KEYS \
                    + COUNTER_KEYS:
                plan_leaf = key in ("col_lut", "col_counts")
                leaf = getattr(plan, key) if plan_leaf else st[key]
                jl = loc(f"plan/{key}" if plan_leaf else key, 1, j)
                if jl is not None:
                    one["whole"][key] = (jl, leaf[:, jl].clone())
            one["rows"] = st["rows"][j].clone()
        snap.append(one)
    return {"slots": snap}


def restore_slots(cache: dict, snap: dict) -> dict:
    """Put back what `snapshot_slots` copied (each entry at the place it
    was copied from), in place; returns `cache`."""
    paged = "kp" in cache
    st = cache.get("sla")
    for one in snap["slots"]:
        j = one["slot"]
        cache["pos"][j] = one["pos"]
        cache["pos_host"][j] = one["pos"]
        if paged:
            for key, (page, off, val) in one["kv"].items():
                cache[key][:, page, :, off] = val
            for key, (page, val) in one["blk"].items():
                cache["slap"][key][:, page] = val
        else:
            for key, (jl, at, val) in one["kv"].items():
                cache[key][:, jl, :, at] = val
        if st is None:
            continue
        if not paged:
            for key, (jl, live, val) in one["blk"].items():
                st[key][:, jl, :, live] = val
        plan = st["plan"]
        for name, (jl, prev, val) in one["row"].items():
            getattr(plan, name)[:, jl, :, prev] = val
        for name, (jl, val) in one["whole"].items():
            leaf = (getattr(plan, name) if name in ("col_lut", "col_counts")
                    else st[name])
            leaf[:, jl] = val
        st["rows"][j] = one["rows"]
    return cache
