"""Zamba2-style hybrid: a Mamba2 backbone plus one *shared* SLA-attention
transformer block applied after every `attn_every` layers
(arXiv:2411.15242).

Counterpart of `repro.models.hybrid`. The shared block has one parameter
set reused at every application point, so the Mamba stack runs in
segments of `attn_every` layers (38 at 6: 6,6,6,6,6,6,2) with the shared
block after every segment, 7 times. In training only the Mamba layers
are rematerialized (`distributed.ctx.maybe_remat`, the reference's remat
of its segment scan); the shared block is not, so a step plans and runs
its SLA forward once per application. Decode runs masked dense attention
over the block's KV cache, as the reference.

Under a DeviceMesh (`distributed.ctx`) the Mamba2 layers run their heads
over "model" (`models/mamba2.py`) and the shared block is tensor-parallel
as the transformer's layers are (`wq` / `wk` / `wv` and `mlp_wi`
column-parallel, `wo`, `mlp_wo` and `sla_proj` row-parallel); under
context parallelism its attention plans and attends over the whole
sequence (`ctx.gather_seq`), and the Mamba2 layers pass their conv tail
and scan state along it. Serving (`prefill`, `make_cache`, `decode_step`)
runs over the mesh too: each rank keeps its part of the cache under
`sharding.cache_shardings` (its SSM heads, the whole conv tail, the K/V
in the layouts of `distributed/serving.py`).

The parameters live in `nn.Module`s in the reference's layout (`x @ W`);
the reference's segment scans are Python loops. `decode_step` writes the
new token's state, conv tail and K/V into the cache IN PLACE (the
reference returns a new cache) and returns the same dict with `pos`
advanced.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import masks as masks_lib
from repro_torch.core import plan as plan_lib
from repro_torch.distributed import ctx, serving
from repro_torch.models import mamba2
from repro_torch.models.common import (attention, cache_attention,
                                       chunked_softmax_xent, dense_init,
                                       embed_init, local_kv_heads,
                                       logits_from_hidden, qkv_heads,
                                       rms_norm, rope, routing_of)


class SharedAttn(nn.Module):
    """The shared SLA-attention block's one parameter set."""

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
        self.mlp_wi = dense(d, 2 * cfg.d_ff)
        self.mlp_wo = dense(cfg.d_ff, d)
        if cfg.sla.routing_mode == "learned":
            r = masks_lib.routing_init(h, dh, dtype, device)
            self.routing = nn.ParameterDict(
                {name: nn.Parameter(w) for name, w in r.items()})


class Hybrid(nn.Module):
    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            mamba2.MambaLayer(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))
        self.shared_attn = SharedAttn(cfg, generator, dtype, device)
        self.embed = nn.Parameter(embed_init(
            generator, cfg.vocab_size, cfg.d_model, dtype, device))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                             device=device))


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         dtype=torch.float32, device=None) -> Hybrid:
    """Random parameters drawn from `generator` on the target device (the
    card unless `device` says otherwise). Not bitwise the reference's
    init; tests carry its weights over with `repro_torch.bridge`."""
    return Hybrid(cfg, generator, dtype, resolve_device(device))


def segments(cfg: ArchConfig) -> list:
    """Static split of the Mamba stack into attn_every-sized segments."""
    n, every = cfg.num_layers, cfg.attn_every or cfg.num_layers
    return [min(every, n - start) for start in range(0, n, every)]


def _shared_block(p, x, cfg: ArchConfig, positions, backend,
                  kv_cache=None, pos=None, kl=None, length=None):
    """The shared SLA-attention transformer block. Returns (x, (k, v)):
    the K/V this call computed at the heads a cache holds (prefill), or
    the cache it wrote into (decode, `kv_cache` given). Under a mesh,
    this "model" rank's query heads, and its KV heads or all of them
    (`common.qkv_heads(pick=False)`); under context parallelism q, k and
    v are gathered to the whole sequence and this rank keeps its rows of
    the output. In decode `kl` is the cache's layout on the mesh (None
    without one) and `length` its global positions: a split sequence or
    whole KV heads attend by the partial softmax and combine
    (`distributed/serving.py`)."""
    b, s, _ = x.shape
    xn = ctx.to_tp(rms_norm(x, ctx.fsdp_gather(p.ln1, "rep")))
    q, k, v = qkv_heads(xn, xn, p.wq, p.wk, p.wv, cfg, pick=False)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        kc, vc = kv_cache
        if serving.is_sharded(kl):
            start, _ = kl.span(length)
            serving.write_token(kc, k, pos, start, length)
            serving.write_token(vc, v, pos, start, length)
            o = serving.sharded_decode_attn(q[:, :, 0], kc, vc, pos, kl,
                                            length)
            o = o.to(q.dtype)[:, :, None]
        else:
            kc[:, :, pos] = k[:, :, 0].to(kc.dtype)
            vc[:, :, pos] = v[:, :, 0].to(vc.dtype)
            o = cache_attention(q, kc, vc, pos)
        new_cache = (kc, vc)
    else:
        q, k, v = (ctx.gather_seq(t, 2) for t in (q, k, v))
        new_cache = (k, v)
        k = local_kv_heads(k, cfg.num_heads, cfg.num_kv_heads)
        v = local_kv_heads(v, cfg.num_heads, cfg.num_kv_heads)
        routing = routing_of(p)
        sla = cfg.sla.replace(causal=True)
        plan = (None if sla.mode in ("full", "linear_only")
                else plan_lib.plan_attention(q, k, sla, routing=routing))
        o = attention({"proj": ctx.fsdp_gather(p.sla_proj, "row")}, q, k,
                      v, "sla", cfg.sla, causal=True, backend=backend,
                      plan=plan, routing=routing)
        o = ctx.seq_rows(o, dim=2)
    o = o.transpose(1, 2).reshape(b, s, -1)
    x = x + ctx.from_tp(o @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))
    xn2 = ctx.to_tp(rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")))
    g, u = (xn2 @ ctx.fsdp_gather(p.mlp_wi, "col", chunks=2)
            .to(x.dtype)).chunk(2, dim=-1)
    x = x + ctx.from_tp((F.silu(g) * u)
                        @ ctx.fsdp_gather(p.mlp_wo, "row").to(x.dtype))
    return x, new_cache


def _mamba_layer(x, p, cfg):
    out, (st, tail) = mamba2.mamba_apply(
        p, rms_norm(x, ctx.fsdp_gather(p.ln, "rep")), cfg)
    return ctx.shard_residual(x + out), st, tail


def _whole_tail(tail: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The cache's whole conv tail from this "model" rank's channels:
    every rank's gathered over "model" and put in the reference's order
    (`mamba2.whole_tail`)."""
    return mamba2.whole_tail(ctx.gather_model(tail), cfg)


def _cache_leaves(cfg: ArchConfig, batch: int, length: int) -> dict:
    """{leaf: global shape} of a decode cache of `batch` rows whose K/V
    hold `length` positions."""
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    kv = (len(segments(cfg)), batch, cfg.num_kv_heads, length,
          cfg.head_dim)
    return {"ssm": (cfg.num_layers, batch, h, n, pd),
            "conv": (cfg.num_layers, batch, cfg.conv_kernel - 1,
                     h * pd + 2 * n),
            "attn_k": kv, "attn_v": kv}


def _alloc(cfg: ArchConfig, batch: int, length: int, dtype, device,
           zeros: bool = True):
    """A decode cache (no `pos`) with each leaf at this rank's shape under
    `sharding.cache_shardings` on the active mesh (the whole cache
    without one): the SSM state in f32, the rest in `dtype`. Returns it
    and this rank's span of the K/V positions (first, count)."""
    kl = serving.active_kv_layout(batch, cfg.num_kv_heads)
    span = (0, length)
    if kl is not None:
        kl.check_length(length)
        span = kl.span(length)
    shapes = serving.local_shapes(_cache_leaves(cfg, batch, length), batch)
    make = torch.zeros if zeros else torch.empty
    return {name: make(shape, dtype=torch.float32 if name == "ssm"
                       else dtype, device=device)
            for name, shape in shapes.items()}, span


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            return_cache: bool = False, cache_len: Optional[int] = None):
    """Hidden states (B, S, d) and a zero aux loss; with `return_cache`
    also the decode cache: per-layer SSM states and conv tails, and the
    shared block's K/V at each application (nseg, B, Hkv, L, Dh), L the
    prompt's length or `cache_len` (zero past the prompt). Under
    `activation_sharding(mesh, ...)` the batch is the global one and this
    rank keeps its rows of it (or of the sequence, with global rope
    positions); the hidden states returned are those rows, and the cache
    is this rank's part under `sharding.cache_shardings`: its batch rows,
    its SSM heads, the whole conv tail, its KV heads or all of them and
    its span of the positions. Under context parallelism the states and
    tails are the whole sequence's (the last data rank's) on every
    rank."""
    global_batch, s_all = tokens.shape
    tokens = ctx.batch_rows(tokens)
    x = ctx.vocab_lookup(tokens, params.embed).to(compute_dtype)
    start, _ = ctx.seq_span(x.shape[1])
    x = ctx.seq_rows(x)
    b, s = x.shape[:2]
    positions = torch.arange(start, start + s,
                             device=x.device)[None, :].expand(b, s)
    if return_cache:
        length = max(s_all, cache_len or s_all)
        cache, (lo, span) = _alloc(cfg, global_batch, length,
                                   compute_dtype, x.device,
                                   zeros=length > s_all)
        # the prompt's positions in this rank's span
        written = min(span, max(0, s_all - lo))
        states, tails = [], []
    layer = ctx.maybe_remat(lambda x, p: _mamba_layer(x, p, cfg))
    start = 0
    for si, seg in enumerate(segments(cfg)):
        for p in params.layers[start:start + seg]:
            x, st, tail = layer(x, p)
            if return_cache:
                states.append(st)
                tails.append(tail)
            del st, tail
        x, (k, v) = _shared_block(params.shared_attn, x, cfg, positions,
                                  backend)
        if return_cache and written:
            cache["attn_k"][si, :, :, :written] = k[:, :, lo:lo + written]
            cache["attn_v"][si, :, :, :written] = v[:, :, lo:lo + written]
        del k, v
        start += seg
    x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_cache:
        cache["ssm"].copy_(ctx.last_span(torch.stack(states)))
        cache["conv"].copy_(_whole_tail(ctx.last_span(torch.stack(tails)),
                                        cfg))
        return x, aux, cache
    return x, aux


def loss_fn(params, cfg: ArchConfig, batch: dict,
            compute_dtype=torch.bfloat16, backend: str = "gather"
            ) -> torch.Tensor:
    """Next-token cross-entropy over the tied `embed`. batch: `tokens`,
    `targets` (B, S) and an optional `mask`; under a mesh the global
    batch, each rank scoring its own rows."""
    x, _ = forward(params, cfg, batch["tokens"], compute_dtype, backend)
    mask = batch.get("mask")
    return chunked_softmax_xent(
        x, params.embed, ctx.local_tokens(batch["targets"]),
        None if mask is None else ctx.local_tokens(mask))


def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty decode cache on `device` (the card unless asked otherwise).
    Under `activation_sharding(mesh, ...)` `batch` is the global batch and
    each leaf is allocated at this rank's shape under
    `sharding.cache_shardings` only (`pos` stays whole on every rank)."""
    cache, _ = _alloc(cfg, batch, max_len, dtype, resolve_device(device))
    cache["pos"] = 0
    return cache


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            cache_len: Optional[int] = None):
    """Run the prompt; returns (last hidden (B, d), cache) with
    cache["pos"] the prompt length. The K/V caches are the prompt's
    length, as the reference's, or `cache_len` long (zero past the
    prompt) for the decode steps that follow. Under
    `activation_sharding(mesh, default_residual_spec(mesh, batch, cache
    length))` the batch is the global one: the last hidden rows are this
    rank's batch rows (every rank's under context parallelism) and the
    cache is this rank's part (`forward`)."""
    x, _, cache = forward(params, cfg, tokens, compute_dtype, backend,
                          return_cache=True, cache_len=cache_len)
    cache["pos"] = tokens.shape[1]
    return ctx.seq_last(x), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                compute_dtype=torch.bfloat16):
    """One token: O(1) Mamba state updates plus O(S) shared-attention
    reads of the cache. token: (B,) int. Writes the cache in place and
    returns (logits (B, V) f32, cache) with `pos` advanced.

    Under `activation_sharding(mesh, default_residual_spec(mesh, batch,
    cache length))` `token` is the global batch and the cache this rank's
    part of it (`prefill`, `make_cache`): the Mamba layers step this
    rank's SSM heads from its channels of the whole conv tail and put
    every rank's new channels back; the shared block attends by the K/V
    layout (`distributed/serving.py`). Under context parallelism every
    data rank decodes every row. Returns the logits of this rank's rows
    over the whole vocabulary."""
    kl = serving.active_kv_layout(token.shape[0], cfg.num_kv_heads)
    length = cache["attn_k"].shape[3] * (kl.seq_parts if kl else 1)
    token = ctx.batch_rows(token)
    if cache["attn_k"].shape[1] != token.shape[0]:
        raise ValueError(
            f"the cache holds {cache['attn_k'].shape[1]} batch rows on "
            f"this rank, the step {token.shape[0]}: make it under the same "
            f"activation_sharding scope")
    pos = int(cache["pos"])
    # under context parallelism every data rank decodes every row
    with (ctx.replicated_tokens() if ctx.seq_parallel()
          else contextlib.nullcontext()):
        rank, m = ctx.model_rank_size()
        x = ctx.vocab_lookup(token[:, None], params.embed).to(compute_dtype)
        b = x.shape[0]
        positions = torch.full((b, 1), pos, device=x.device)
        start = 0
        for si, seg in enumerate(segments(cfg)):
            for li in range(start, start + seg):
                p = params.layers[li]
                out, (st, tail) = mamba2.mamba_apply(
                    p, rms_norm(x, ctx.fsdp_gather(p.ln, "rep")), cfg,
                    conv_tail=mamba2.rank_tail(cache["conv"][li], cfg, rank,
                                               m),
                    state=cache["ssm"][li])
                x = x + out
                cache["ssm"][li] = st
                cache["conv"][li] = _whole_tail(tail, cfg).to(
                    cache["conv"].dtype)
            x, _ = _shared_block(
                params.shared_attn, x, cfg, positions, "gather",
                kv_cache=(cache["attn_k"][si], cache["attn_v"][si]),
                pos=pos, kl=kl, length=length)
            start += seg
        x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    cache["pos"] = pos + 1
    return logits_from_hidden(params, x[:, 0]), cache
