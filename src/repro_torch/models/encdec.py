"""Whisper-style encoder-decoder backbone (the audio frontend is a stub:
the batch carries precomputed frame embeddings `audio_embeds`).

Counterpart of `repro.models.encdec`. Encoder: bidirectional
self-attention over the frames, SLA when `cfg.attention_kind == "sla"`
(the paper's own non-causal setting), with the learned routing head on
encoder blocks only. Decoder: causal full self-attention over the text
plus non-causal full cross-attention into the encoder states. Rope
rotates q at its positions and k at arange(Sk); cross-attention has no
rope. Both stacks are rematerialized layer by layer in training
(`distributed.ctx.maybe_remat`); an encoder layer's SLA plan is built in
its first pass and reused by the recompute, so each encoder layer plans
once a step and runs the SLA forward twice.

Under a DeviceMesh (`distributed.ctx`) both stacks are tensor-parallel
as the dense family's layers are: the self- and cross-attention's
`wq` / `wk` / `wv` and `xq` / `xk` / `xv` column-parallel, `wo`, `xo`,
`mlp_wo` and `sla_proj` row-parallel, `mlp_wi` column-parallel. Under
context parallelism the frames and the text split over "data": the
self-attention plans and attends over the whole sequence
(`ctx.gather_seq`), and the decoder's cross-attention reads the whole
encoder output (its K and V gathered over "data") from this rank's text
rows.

Serving: `prefill` encodes the audio and computes every decoder layer's
cross K/V; `decode_step` runs one text token with masked dense attention
over the self cache and dense attention over the cross cache, writing
the self cache IN PLACE (the reference returns a new cache). Over the
mesh each rank keeps its part of both caches under
`sharding.cache_shardings` (the layouts of `distributed/serving.py`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import masks as masks_lib
from repro_torch.core import plan as plan_lib
from repro_torch.distributed import ctx, serving
from repro_torch.models.common import (attention, cache_attention,
                                       chunked_softmax_xent, dense_init,
                                       embed_init, kv_kind,
                                       logits_from_hidden, qkv_heads,
                                       rms_norm, rope, routing_of)


class EncDecBlock(nn.Module):
    """One encoder (cross=False) or decoder (cross=True) block."""

    def __init__(self, cfg: ArchConfig, cross: bool, generator=None,
                 dtype=torch.float32, device=None):
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
        if cfg.sla.routing_mode == "learned" and not cross:
            # encoder blocks only: decode runs exact attention for the
            # decoder's self- and cross-attention
            r = masks_lib.routing_init(h, dh, dtype, device)
            self.routing = nn.ParameterDict(
                {name: nn.Parameter(w) for name, w in r.items()})
        if cross:
            self.ln_x = zeros(d)
            self.xq, self.xk = dense(d, h * dh), dense(d, hkv * dh)
            self.xv, self.xo = dense(d, hkv * dh), dense(h * dh, d)


class EncDec(nn.Module):
    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.enc = nn.ModuleList(
            EncDecBlock(cfg, False, generator, dtype, device)
            for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(
            EncDecBlock(cfg, True, generator, dtype, device)
            for _ in range(cfg.decoder_layers))
        self.embed = nn.Parameter(embed_init(
            generator, cfg.vocab_size, cfg.d_model, dtype, device))
        self.ln_enc = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                               device=device))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                             device=device))


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         dtype=torch.float32, device=None) -> EncDec:
    """Random parameters drawn from `generator` on the target device (the
    card unless `device` says otherwise). Not bitwise the reference's
    init; tests carry its weights over with `repro_torch.bridge`."""
    return EncDec(cfg, generator, dtype, resolve_device(device))


def _proj(x, w, heads: int, dh: int):
    b, s, _ = x.shape
    return (x @ w.to(x.dtype)).reshape(b, s, heads, dh).transpose(1, 2)


def _mha(p, pre: str, x, kv_x, cfg: ArchConfig, causal: bool, kind: str,
         positions, backend, kept: Optional[dict] = None):
    """Attention sub-block: q from x, k and v from kv_x through the
    `pre`-prefixed weights ("w" self, "x" cross). An SLA call plans on
    its first pass and keeps the plan in `kept` for a rematerializing
    recompute. Under a mesh, this "model" rank's heads; a cross
    attention's `kv_x` has entered the tensor-parallel region already
    (`decode`: once for every layer). Under context parallelism k and v
    are gathered to the whole sequence, and so is q for self-attention
    (`positions`: the whole sequence's), of whose output this rank keeps
    its rows."""
    b, s, _ = x.shape
    self_attn = kv_x is x
    x = ctx.to_tp(x)
    q, k, v = qkv_heads(x, x if self_attn else kv_x, getattr(p, pre + "q"),
                        getattr(p, pre + "k"), getattr(p, pre + "v"), cfg)
    k, v = ctx.gather_seq(k, 2), ctx.gather_seq(v, 2)
    if self_attn:
        q = ctx.gather_seq(q, 2)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, torch.arange(k.shape[2], device=k.device),
                 cfg.rope_theta)
    if kind == "sla":
        routing = routing_of(p)
        sla = cfg.sla.replace(causal=causal)
        plan = None
        if sla.mode not in ("full", "linear_only"):
            if "plan" not in kept:
                # planning's saved tensors (the learned router's gates)
                # stay out of the remat checkpoint; the recompute reuses
                # the plan
                with torch.autograd.graph.saved_tensors_hooks(
                        lambda t: t.detach(), lambda t: t):
                    kept["plan"] = plan_lib.plan_attention(
                        q, k, sla, routing=routing)
            plan = kept["plan"]
        o = attention({"proj": ctx.fsdp_gather(p.sla_proj, "row")}, q, k,
                      v, "sla", cfg.sla, causal=causal, backend=backend,
                      plan=plan, routing=routing)
    else:
        o = attention(None, q, k, v, kind, cfg.sla, causal=causal)
    if self_attn:
        o = ctx.seq_rows(o, dim=2)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return ctx.from_tp(o @ ctx.fsdp_gather(getattr(p, pre + "o"), "row")
                       .to(x.dtype))


def _mlp(p, x):
    g, u = (ctx.to_tp(x) @ ctx.fsdp_gather(p.mlp_wi, "col", chunks=2)
            .to(x.dtype)).chunk(2, dim=-1)
    return ctx.from_tp((F.silu(g) * u)
                       @ ctx.fsdp_gather(p.mlp_wo, "row").to(x.dtype))


def _norm(x, w):
    return rms_norm(x, ctx.fsdp_gather(w, "rep"))


def encode(params, cfg: ArchConfig, audio_embeds: torch.Tensor,
           compute_dtype=torch.bfloat16, backend: str = "gather"
           ) -> torch.Tensor:
    """audio_embeds: (B, T, d) stub frame embeddings -> encoder states
    (under a mesh, this rank's rows of them)."""
    x = ctx.seq_rows(ctx.batch_rows(audio_embeds)).to(compute_dtype)
    b, t = x.shape[0], audio_embeds.shape[1]
    pos = torch.arange(t, device=x.device)[None].expand(b, t)
    kind = "sla" if cfg.attention_kind == "sla" else "full"

    def body(x, p, kept):
        xn = _norm(x, p.ln1)
        x = ctx.shard_residual(
            x + _mha(p, "w", xn, xn, cfg, False, kind, pos, backend, kept))
        return ctx.shard_residual(x + _mlp(p, _norm(x, p.ln2)))

    for p in params.enc:
        x = ctx.maybe_remat(functools.partial(body, p=p, kept={}))(x)
    return _norm(x, params.ln_enc)


def decode(params, cfg: ArchConfig, tokens: torch.Tensor,
           enc_states: torch.Tensor, compute_dtype=torch.bfloat16,
           backend: str = "gather") -> torch.Tensor:
    """Teacher-forced decoder over text tokens (B, S) -> hidden states.
    Under a mesh `tokens` is the global batch and `enc_states` this
    rank's rows of the encoder output; the hidden states are this rank's
    rows."""
    x = ctx.vocab_lookup(ctx.batch_rows(tokens), params.embed) \
        .to(compute_dtype)
    b, s = x.shape[:2]
    x = ctx.seq_rows(x)
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    # the cross-attention's K / V input, each "model" rank's share of its
    # gradient from its own heads: summed over "model" once, after every
    # layer added its own (as one device sums them)
    enc = ctx.to_tp(enc_states.to(compute_dtype))

    def body(x, p):
        xn = _norm(x, p.ln1)
        x = ctx.shard_residual(
            x + _mha(p, "w", xn, xn, cfg, True, "full", pos, backend))
        x = ctx.shard_residual(
            x + _mha(p, "x", _norm(x, p.ln_x), enc, cfg, False, "full",
                     None, backend))
        return ctx.shard_residual(x + _mlp(p, _norm(x, p.ln2)))

    for p in params.dec:
        x = ctx.maybe_remat(functools.partial(body, p=p))(x)
    return _norm(x, params.ln_f)


def loss_fn(params, cfg: ArchConfig, batch: dict,
            compute_dtype=torch.bfloat16, backend: str = "gather"
            ) -> torch.Tensor:
    """batch: audio_embeds (B, T, d), tokens (B, S), targets (B, S);
    cross-entropy over the tied `embed`. Under a mesh the global batch,
    each rank scoring its own rows."""
    enc = encode(params, cfg, batch["audio_embeds"], compute_dtype, backend)
    x = decode(params, cfg, batch["tokens"], enc, compute_dtype, backend)
    mask = batch.get("mask")
    return chunked_softmax_xent(
        x, params.embed, ctx.local_tokens(batch["targets"]),
        None if mask is None else ctx.local_tokens(mask))


# --------------------------------------------------------------------------
# serving: cross K/V computed at prefill; the decoder's self cache grows
# --------------------------------------------------------------------------
def make_cache(cfg: ArchConfig, batch: int, enc_len: int,
               dec_len: Optional[int] = None, dtype=torch.bfloat16,
               device=None) -> dict:
    """Empty decode cache on `device` (the card unless asked otherwise);
    `dec_len` defaults to max(enc_len // 8, 64). Under
    `activation_sharding(mesh, ...)` `batch` is the global batch and each
    leaf is allocated at this rank's shape under
    `sharding.cache_shardings` only (`pos` stays whole on every rank)."""
    dev = resolve_device(device)
    dec_len = dec_len or max(enc_len // 8, 64)
    kl = serving.active_kv_layout(batch, cfg.num_kv_heads)
    if kl is not None:
        kl.check_length(enc_len)
        kl.check_length(dec_len)
    dl, hkv, dh = cfg.decoder_layers, cfg.num_kv_heads, cfg.head_dim
    shapes = serving.local_shapes({
        "self_k": (dl, batch, hkv, dec_len, dh),
        "self_v": (dl, batch, hkv, dec_len, dh),
        "cross_k": (dl, batch, hkv, enc_len, dh),
        "cross_v": (dl, batch, hkv, enc_len, dh)}, batch)
    cache = {name: torch.zeros(shape, dtype=dtype, device=dev)
             for name, shape in shapes.items()}
    cache["pos"] = 0
    return cache


def prefill(params, cfg: ArchConfig, batch: dict,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            dec_len: Optional[int] = None):
    """Encode the audio and compute every decoder layer's cross K/V.
    Returns (encoder states (B, T, d), cache).

    Under `activation_sharding(mesh, default_residual_spec(mesh, batch,
    frames))` the batch is the global one: the encoder states returned
    are this rank's rows of them (of the frames under context
    parallelism), and the cache is this rank's part under
    `sharding.cache_shardings`: each rank projects the cross K/V of the
    encoder rows in its span of the cross cache only, at the heads its
    cache holds."""
    audio = batch["audio_embeds"]
    b, t = audio.shape[:2]
    enc = encode(params, cfg, audio, compute_dtype, backend)
    cache = make_cache(cfg, b, t, dec_len, dtype=compute_dtype,
                       device=enc.device)
    kl = serving.active_kv_layout(b, cfg.num_kv_heads)
    lo, n = (0, t) if kl is None else kl.span(t)
    e0, _ = ctx.seq_span(t)  # the first frame of this rank's rows
    xs = enc[:, lo - e0:lo - e0 + n]
    kind = kv_kind(cfg.num_kv_heads)
    hk = cache["cross_k"].shape[2]
    for li, p in enumerate(params.dec):
        cache["cross_k"][li] = _proj(xs, ctx.fsdp_gather(p.xk, kind), hk,
                                     cfg.head_dim)
        cache["cross_v"][li] = _proj(xs, ctx.fsdp_gather(p.xv, kind), hk,
                                     cfg.head_dim)
    return enc, cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                compute_dtype=torch.bfloat16):
    """One text token (B,): causal self-attention over the (small) text
    cache plus cross-attention over the (long) audio cross K/V. Writes
    the self cache in place; returns (logits (B, V) f32, cache) with
    `pos` advanced.

    Under `activation_sharding(mesh, ...)` `token` is the global batch and
    the cache this rank's part (`prefill`, `make_cache`): the step reads
    its batch rows, writes the new K/V where its part of the self cache
    holds them and attends by the layout (`distributed/serving.py`); the
    cross-attention is the same partial softmax with every column
    visible. Under context parallelism every data rank decodes every row.
    Returns this rank's rows' logits over the whole vocabulary."""
    kl = serving.active_kv_layout(token.shape[0], cfg.num_kv_heads)
    parts = kl.seq_parts if kl is not None else 1
    dec_len = cache["self_k"].shape[3] * parts
    enc_len = cache["cross_k"].shape[3] * parts
    sharded = serving.is_sharded(kl)
    token = ctx.batch_rows(token)
    if cache["self_k"].shape[1] != token.shape[0]:
        raise ValueError(
            f"the cache holds {cache['self_k'].shape[1]} batch rows on this "
            f"rank, the step {token.shape[0]}: make it under the same "
            f"activation_sharding scope")
    pos = int(cache["pos"])
    with (ctx.replicated_tokens() if ctx.seq_parallel()
          else contextlib.nullcontext()):
        x = ctx.vocab_lookup(token[:, None], params.embed).to(compute_dtype)
        b = x.shape[0]
        positions = torch.full((b, 1), pos, device=x.device)
        for li, p in enumerate(params.dec):
            sk, sv = cache["self_k"][li], cache["self_v"][li]
            ck, cv = cache["cross_k"][li], cache["cross_v"][li]
            xn = ctx.to_tp(_norm(x, p.ln1))
            q, kn, vn = qkv_heads(xn, xn, p.wq, p.wk, p.wv, cfg, pick=False)
            q = rope(q, positions, cfg.rope_theta)
            kn = rope(kn, positions, cfg.rope_theta)
            if sharded:
                start, _ = kl.span(dec_len)
                serving.write_token(sk, kn, pos, start, dec_len)
                serving.write_token(sv, vn, pos, start, dec_len)
                o = serving.sharded_decode_attn(q[:, :, 0], sk, sv, pos, kl,
                                                dec_len).to(q.dtype)
            else:
                sk[:, :, pos] = kn[:, :, 0].to(sk.dtype)
                sv[:, :, pos] = vn[:, :, 0].to(sv.dtype)
                o = cache_attention(q, sk, sv, pos)[:, :, 0]
            x = x + ctx.from_tp(o.reshape(b, 1, -1) @ ctx.fsdp_gather(
                p.wo, "row").to(x.dtype))
            xq = ctx.to_tp(_norm(x, p.ln_x))
            xq = _proj(xq, ctx.fsdp_gather(p.xq, "col"), q.shape[1],
                       cfg.head_dim)
            if sharded:
                # no mask: the last position leaves every column visible
                xo = serving.sharded_decode_attn(
                    xq[:, :, 0], ck, cv, enc_len - 1, kl, enc_len
                ).to(xq.dtype)
            else:
                xo = cache_attention(xq, ck, cv)[:, :, 0]
            x = x + ctx.from_tp(xo.reshape(b, 1, -1) @ ctx.fsdp_gather(
                p.xo, "row").to(x.dtype))
            x = x + _mlp(p, _norm(x, p.ln2))
        x = _norm(x, params.ln_f)
    cache["pos"] = pos + 1
    return logits_from_hidden(params, x[:, 0]), cache
