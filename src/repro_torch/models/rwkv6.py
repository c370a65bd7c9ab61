"""RWKV6 ("Finch"): an attention-free LM with data-dependent decay.

Counterpart of `repro.models.rwkv6`: token-shift mixing, the WKV6
recurrence with per-channel data-dependent decay w_t = -exp(clip(w0 +
lora(x), -8, 5)) (rank-32 LoRA, in f32), the bonus u, a per-head group
norm (population variance), and the squared-ReLU channel mix. The head
width is d_model // ssm_heads. The recurrence runs through
`linear_scan.decayed_la_chunked` (exclusive convention, per-channel
decay), or one `decayed_la_step` for a single token with a state. SLA
does not apply: there is no softmax attention, so no SLA kernel runs.

Under a DeviceMesh (`distributed.ctx`) the heads split over "model":
`wr` / `wk` / `wv` / `wg` column-parallel, `u` and this rank's slices of
`w0` and `gn` by head, the decay LoRA read whole (`wb`'s columns of this
rank's heads), the group norm local to each head, `wo` row-parallel; the
channel mix's `ck` column- and `cv` row-parallel, its receptance gate
computed whole on every rank (`cr` read alike: it multiplies the whole
d). Under context parallelism the token shifts read the previous rank's
last row (`ctx.halo`) and the scan starts from the state entering this
rank (`linear_scan`). Serving runs over the mesh too: each rank's cache
is its part under `sharding.cache_shardings` (the state's heads over
"model", the token shifts whole on every "model" rank).

The parameters live in `nn.Module`s in the reference's layout; its layer
scan is a Python loop, each layer rematerialized in training
(`distributed.ctx.maybe_remat`). `decode_step` writes the cache in place
and returns the same dict with `pos` advanced.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ctx, serving
from repro_torch.models.common import (chunked_softmax_xent, dense_init,
                                       embed_init, logits_from_hidden,
                                       rms_norm)
from repro_torch.models.linear_scan import (decayed_la_chunked,
                                            decayed_la_step)

LORA_RANK = 32


def _heads(cfg: ArchConfig) -> int:
    return cfg.ssm_heads or cfg.num_heads


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = cfg.d_model
        h = _heads(cfg)
        dh = d // h

        def dense(i, o):
            return nn.Parameter(dense_init(generator, i, o, dtype, device))

        def full(shape, value):
            return nn.Parameter(torch.full(shape, value, dtype=dtype,
                                           device=device))

        self.ln1, self.ln2 = full((d,), 0.0), full((d,), 0.0)
        self.mix = full((5, d), 0.5)  # token-shift mixes for r, k, v, w, g
        self.wr, self.wk, self.wv = dense(d, d), dense(d, d), dense(d, d)
        self.wg, self.wo = dense(d, d), dense(d, d)
        # decay: w = w0 + tanh(x A) B (rank-32 LoRA)
        self.w0 = full((d,), -6.0)
        self.wa = dense(d, LORA_RANK)
        self.wb = nn.Parameter(
            dense_init(generator, LORA_RANK, d, dtype, device) * 0.1)
        self.u = nn.Parameter(torch.randn(
            (h, dh), generator=generator, dtype=torch.float32,
            device=device).to(dtype) * 0.1)
        self.gn = full((d,), 0.0)  # per-head group norm scale
        self.cmix = full((1, d), 0.5)
        self.ck, self.cv = dense(d, cfg.d_ff), dense(cfg.d_ff, d)
        self.cr = dense(d, d)


class RWKV6(nn.Module):
    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            RWKVLayer(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))
        self.embed = nn.Parameter(embed_init(
            generator, cfg.vocab_size, cfg.d_model, dtype, device))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                             device=device))


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         dtype=torch.float32, device=None) -> RWKV6:
    """Random parameters drawn from `generator` on the target device (the
    card unless `device` says otherwise). Not bitwise the reference's
    init; tests carry its weights over with `repro_torch.bridge`."""
    return RWKV6(cfg, generator, dtype, resolve_device(device))


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None):
    """Token shift: x_{t-1}, with zeros (or `last`, (B, 1, D)) at t = 0."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _time_mix(p, x, cfg: ArchConfig, prev=None, state=None):
    """The WKV6 block. x: (B, S, d). Returns (out, (new_state, x_last)).
    Under a mesh, this "model" rank's heads: the state is theirs."""
    b, s, d = x.shape
    _, m = ctx.model_rank_size()
    h = _heads(cfg) // m
    dh = d // _heads(cfg)
    dl = h * dh
    # the region's input: each rank's share of its gradient comes from
    # its own heads (the halo's too, which goes back to the rank before)
    x = ctx.to_tp(x)
    if prev is None:
        prev = ctx.halo(x, 1)
    xprev = _shift(x, prev)
    mix = ctx.fsdp_gather(p.mix, "tp").to(x.dtype)
    xr, xk, xv, xw, xg = (mix[i] * x + (1 - mix[i]) * xprev
                          for i in range(5))
    r = xr @ ctx.fsdp_gather(p.wr, "col").to(x.dtype)
    k = xk @ ctx.fsdp_gather(p.wk, "col").to(x.dtype)
    v = xv @ ctx.fsdp_gather(p.wv, "col").to(x.dtype)
    g = F.silu(xg @ ctx.fsdp_gather(p.wg, "col").to(x.dtype))
    lora = torch.tanh(xw @ ctx.fsdp_gather(p.wa, "tp").to(x.dtype)) \
        @ ctx.fsdp_gather(p.wb, "col").to(x.dtype)
    w0 = ctx.fsdp_gather(p.w0, "col")
    logw = -torch.exp(torch.clamp(w0.float() + lora.float(), -8.0, 5.0))

    def heads(t):
        return t.reshape(b, s, h, dh).transpose(1, 2)

    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(logw)
    u = ctx.fsdp_gather(p.u, "row").float()
    if s == 1 and state is not None:
        o, new_state = decayed_la_step(rh[:, :, 0], kh[:, :, 0],
                                       vh[:, :, 0], wh[:, :, 0], state, u=u)
        o = o[:, :, None, :]
    else:
        o, new_state = decayed_la_chunked(rh, kh, vh, wh, u=u, s0=state)
    # per-head group norm (population variance, as jnp.var)
    o = o.transpose(1, 2)  # (B, S, H, dh)
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, correction=0)
    o = (o - mu) * torch.rsqrt(var + 1e-5)
    o = o.reshape(b, s, dl) * (1.0 + ctx.fsdp_gather(p.gn, "col").float())
    o = (o * g.float()).to(x.dtype)
    return (ctx.from_tp(o @ ctx.fsdp_gather(p.wo, "row").to(x.dtype)),
            (new_state, x[:, -1:]))


def _channel_mix(p, x, prev=None):
    if prev is None:
        prev = ctx.halo(x, 1)
    xprev = _shift(x, prev)
    mix = ctx.fsdp_gather(p.cmix, "rep").to(x.dtype)[0]
    xk = mix * x + (1 - mix) * xprev
    k = torch.square(F.relu(ctx.to_tp(xk)
                            @ ctx.fsdp_gather(p.ck, "col").to(x.dtype)))
    # the gate multiplies the whole d: every rank computes all of it
    rgate = torch.sigmoid(xk @ ctx.fsdp_gather(p.cr, "rep").to(x.dtype))
    return (rgate * ctx.from_tp(k @ ctx.fsdp_gather(p.cv, "row")
                                .to(x.dtype)), x[:, -1:])


def _layer(x, p, cfg):
    a, (st, xl1) = _time_mix(
        p, rms_norm(x, ctx.fsdp_gather(p.ln1, "rep")), cfg)
    x = ctx.shard_residual(x + a)
    f, xl2 = _channel_mix(p, rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")))
    return ctx.shard_residual(x + f), st, xl1, xl2


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            return_cache: bool = False):
    """Hidden states (B, S, d) and a zero aux loss; with `return_cache`
    also each layer's (state, time-mix last input, channel-mix last
    input) stacked over layers. `backend` is accepted and unused: no
    layer attends. Under `activation_sharding(mesh, ...)` the batch is
    the global one and this rank keeps its rows of it (or of the
    sequence); the hidden states returned are those rows, the states
    this rank's heads of its rows, the token shifts whole. Under context
    parallelism the caches are the whole sequence's (the last data
    rank's) on every rank."""
    x = ctx.vocab_lookup(ctx.batch_rows(tokens), params.embed) \
        .to(compute_dtype)
    x = ctx.seq_rows(x)
    layer = ctx.maybe_remat(lambda x, p: _layer(x, p, cfg))
    caches = []
    for p in params.layers:
        x, st, xl1, xl2 = layer(x, p)
        if return_cache:
            caches.append((st, xl1, xl2))
        del st, xl1, xl2
    x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_cache:
        return x, aux, tuple(ctx.last_span(torch.stack(t))
                             for t in zip(*caches))
    return x, aux


def loss_fn(params, cfg: ArchConfig, batch: dict,
            compute_dtype=torch.bfloat16, backend: str = "gather"
            ) -> torch.Tensor:
    """Next-token cross-entropy over the tied `embed`; under a mesh the
    global batch, each rank scoring its own rows."""
    x, _ = forward(params, cfg, batch["tokens"], compute_dtype)
    mask = batch.get("mask")
    return chunked_softmax_xent(
        x, params.embed, ctx.local_tokens(batch["targets"]),
        None if mask is None else ctx.local_tokens(mask))


def _cache_leaves(cfg: ArchConfig, batch: int) -> dict:
    """{leaf: global shape} of a decode cache of `batch` rows."""
    d, h, nl = cfg.d_model, _heads(cfg), cfg.num_layers
    return {"state": (nl, batch, h, d // h, d // h),
            "x1": (nl, batch, 1, d), "x2": (nl, batch, 1, d)}


def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty decode cache (a constant-size recurrent state whatever
    `max_len`) on `device` (the card unless asked otherwise). Under
    `activation_sharding(mesh, ...)` `batch` is the global batch and each
    leaf is allocated at this rank's shape under
    `sharding.cache_shardings` only: the state's heads over "model", the
    token shifts whole, both over the batch's data ranks."""
    dev = resolve_device(device)
    shapes = serving.local_shapes(_cache_leaves(cfg, batch), batch)
    cache = {name: torch.zeros(shape, dtype=torch.float32 if name == "state"
                               else dtype, device=dev)
             for name, shape in shapes.items()}
    cache["pos"] = 0
    return cache


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, backend: str = "gather"):
    """Run the prompt; returns (last hidden (B, d), cache). Under
    `activation_sharding(mesh, default_residual_spec(...))` the batch is
    the global one: the last hidden rows are this rank's batch rows
    (every rank's under context parallelism) and the cache this rank's
    part under `sharding.cache_shardings` (`forward`)."""
    x, _, (st, x1, x2) = forward(params, cfg, tokens, compute_dtype,
                                 return_cache=True)
    cache = {"state": st, "x1": x1, "x2": x2, "pos": tokens.shape[1]}
    return ctx.seq_last(x), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                compute_dtype=torch.bfloat16):
    """O(1)-state decode of one token (B,). Writes the cache in place and
    returns (logits (B, V) f32, cache) with `pos` advanced. Under
    `activation_sharding(mesh, ...)` `token` is the global batch, the
    cache this rank's part, and the logits this rank's rows over the
    whole vocabulary; under context parallelism every data rank decodes
    every row."""
    token = ctx.batch_rows(token)
    if cache["x1"].shape[1] != token.shape[0]:
        raise ValueError(
            f"the cache holds {cache['x1'].shape[1]} batch rows on this "
            f"rank, the step {token.shape[0]}: make it under the same "
            f"activation_sharding scope")
    with (ctx.replicated_tokens() if ctx.seq_parallel()
          else contextlib.nullcontext()):
        x = ctx.vocab_lookup(token[:, None], params.embed).to(compute_dtype)
        for li, p in enumerate(params.layers):
            a, (st, x1) = _time_mix(
                p, rms_norm(x, ctx.fsdp_gather(p.ln1, "rep")), cfg,
                prev=cache["x1"][li], state=cache["state"][li])
            x = x + a
            f, x2 = _channel_mix(p, rms_norm(
                x, ctx.fsdp_gather(p.ln2, "rep")), prev=cache["x2"][li])
            x = x + f
            cache["state"][li] = st
            cache["x1"][li] = x1.to(cache["x1"].dtype)
            cache["x2"][li] = x2.to(cache["x2"].dtype)
        x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    cache["pos"] = int(cache["pos"]) + 1
    return logits_from_hidden(params, x[:, 0]), cache
