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
and scan state along it.

The parameters live in `nn.Module`s in the reference's layout (`x @ W`);
the reference's segment scans are Python loops. `decode_step` writes the
new token's state, conv tail and K/V into the cache IN PLACE (the
reference returns a new cache) and returns the same dict with `pos`
advanced.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import masks as masks_lib
from repro_torch.core import plan as plan_lib
from repro_torch.distributed import ctx
from repro_torch.models import mamba2
from repro_torch.models.common import (attention, cache_attention,
                                       chunked_softmax_xent, dense_init,
                                       embed_init, logits_from_hidden,
                                       qkv_heads, rms_norm, rope,
                                       routing_of)


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
                  kv_cache=None, pos=None):
    """The shared SLA-attention transformer block. Returns (x, (k, v)):
    the K/V this call computed (prefill), or the cache it wrote into
    (decode, `kv_cache` given). Under a mesh, this "model" rank's heads;
    under context parallelism q, k and v are gathered to the whole
    sequence and this rank keeps its rows of the output."""
    b, s, _ = x.shape
    xn = ctx.to_tp(rms_norm(x, ctx.fsdp_gather(p.ln1, "rep")))
    q, k, v = qkv_heads(xn, xn, p.wq, p.wk, p.wv, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        kc, vc = kv_cache
        kc[:, :, pos] = k[:, :, 0].to(kc.dtype)
        vc[:, :, pos] = v[:, :, 0].to(vc.dtype)
        new_cache = (kc, vc)
        o = cache_attention(q, kc, vc, pos)
    else:
        q, k, v = (ctx.gather_seq(t, 2) for t in (q, k, v))
        routing = routing_of(p)
        sla = cfg.sla.replace(causal=True)
        plan = (None if sla.mode in ("full", "linear_only")
                else plan_lib.plan_attention(q, k, sla, routing=routing))
        o = attention({"proj": ctx.fsdp_gather(p.sla_proj, "row")}, q, k,
                      v, "sla", cfg.sla, causal=True, backend=backend,
                      plan=plan, routing=routing)
        o = ctx.seq_rows(o, dim=2)
        new_cache = (k, v)
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


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            return_cache: bool = False):
    """Hidden states (B, S, d) and a zero aux loss; with `return_cache`
    also the decode cache: per-layer SSM states and conv tails, and the
    shared block's K/V at each application (nseg, B, Hkv, S, Dh). Under
    `activation_sharding(mesh, ...)` the batch is the global one and this
    rank keeps its rows of it (or of the sequence, with global rope
    positions); the hidden states returned are those rows."""
    if return_cache:
        ctx.require_unsharded(
            "the hybrid family's serving (forward(return_cache=))")
    tokens = ctx.batch_rows(tokens)
    x = ctx.vocab_lookup(tokens, params.embed).to(compute_dtype)
    start, _ = ctx.seq_span(x.shape[1])
    x = ctx.seq_rows(x)
    b, s = x.shape[:2]
    positions = torch.arange(start, start + s,
                             device=x.device)[None, :].expand(b, s)
    states, tails, ks, vs = [], [], [], []
    layer = ctx.maybe_remat(lambda x, p: _mamba_layer(x, p, cfg))
    start = 0
    for seg in segments(cfg):
        for p in params.layers[start:start + seg]:
            x, st, tail = layer(x, p)
            if return_cache:
                states.append(st)
                tails.append(tail)
            del st, tail
        x, (k, v) = _shared_block(params.shared_attn, x, cfg, positions,
                                  backend)
        if return_cache:
            ks.append(k)
            vs.append(v)
        del k, v
        start += seg
    x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_cache:
        cache = {"ssm": torch.stack(states), "conv": torch.stack(tails),
                 "attn_k": torch.stack(ks), "attn_v": torch.stack(vs)}
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
    """Empty decode cache on `device` (the card unless asked otherwise)."""
    dev = resolve_device(device)
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    nseg = len(segments(cfg))
    d_conv = h * pd + 2 * n
    kv = (nseg, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {
        "ssm": torch.zeros((cfg.num_layers, batch, h, n, pd),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.num_layers, batch, cfg.conv_kernel - 1,
                             d_conv), dtype=dtype, device=dev),
        "attn_k": torch.zeros(kv, dtype=dtype, device=dev),
        "attn_v": torch.zeros(kv, dtype=dtype, device=dev),
        "pos": 0,
    }


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, backend: str = "gather"):
    """Run the prompt; returns (last hidden (B, d), cache) with
    cache["pos"] the prompt length. The K/V caches are the prompt's
    length: grow them along axis 3 before decoding past it."""
    x, _, cache = forward(params, cfg, tokens, compute_dtype, backend,
                          return_cache=True)
    cache["pos"] = tokens.shape[1]
    return x[:, -1], cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                compute_dtype=torch.bfloat16):
    """One token: O(1) Mamba state updates plus O(S) shared-attention
    reads of the cache. token: (B,) int. Writes the cache in place and
    returns (logits (B, V) f32, cache) with `pos` advanced."""
    ctx.require_unsharded("the hybrid family's serving (decode_step)")
    x = F.embedding(token[:, None], params.embed).to(compute_dtype)
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, device=x.device)
    start = 0
    for si, seg in enumerate(segments(cfg)):
        for li in range(start, start + seg):
            p = params.layers[li]
            out, (st, tail) = mamba2.mamba_apply(
                p, rms_norm(x, p.ln), cfg, conv_tail=cache["conv"][li],
                state=cache["ssm"][li])
            x = x + out
            cache["ssm"][li] = st
            cache["conv"][li] = tail.to(cache["conv"].dtype)
        x, _ = _shared_block(
            params.shared_attn, x, cfg, positions, "gather",
            kv_cache=(cache["attn_k"][si], cache["attn_v"][si]), pos=pos)
        start += seg
    x = rms_norm(x, params.ln_f)
    cache["pos"] = pos + 1
    return logits_from_hidden(params, x[:, 0]), cache
