"""Shared model building blocks. Counterpart of `repro.models.common`.

Conventions: weights keep the reference's layout (`x @ W` with W of shape
(in, out)); norms, softmax and losses in f32; attention tensors are
(B, H, N, Dh).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import reference as sref
from repro_torch.core.config import SLAConfig
from repro_torch.core.sla import sla_attention


def dense_init(generator: Optional[torch.Generator], in_dim: int,
               out_dim: int, dtype=torch.float32, device=None
               ) -> torch.Tensor:
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=device) * scale
    return w.to(dtype)


def embed_init(generator: Optional[torch.Generator], vocab: int, dim: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=generator,
                        dtype=torch.float32, device=device)
            * dim**-0.5).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the (1 + w) scale: statistics in f32, the elementwise
    math in x.dtype (as the reference's forward)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    wp1 = (1.0 + w.float()).to(x.dtype)
    return x * r.to(x.dtype) * wp1


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
         ) -> torch.Tensor:
    """Rotary embedding with the half-split rotation, angles in f32.
    x: (B, H, N, D); positions: (B, N) or (N,)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # (B, N, half)
    cos = torch.cos(ang)[:, None]
    sin = torch.sin(ang)[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(sla_params: Optional[dict], q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, kind: str, sla_cfg: SLAConfig,
              window: int = 0, causal: bool = True, backend: str = "gather",
              plan=None, routing: Optional[dict] = None) -> torch.Tensor:
    """Unified attention entry. kind: "sla" | "full" ("swa" arrives with
    the gemma3 family). k, v may have fewer (GQA) heads."""
    if kind == "full":
        h = q.shape[1]
        kk = (torch.repeat_interleave(k, h // k.shape[1], 1)
              if k.shape[1] != h else k)
        vv = (torch.repeat_interleave(v, h // v.shape[1], 1)
              if v.shape[1] != h else v)
        return sref.full_attention(q, kk, vv, causal).to(q.dtype)
    if kind == "sla":
        cfg = dataclasses.replace(sla_cfg, causal=causal)
        return sla_attention(sla_params, q, k, v, cfg, backend=backend,
                             plan=plan, routing=routing)
    if kind == "swa":
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP.md "
            "queue 1, item 15: gemma3)")
    raise ValueError(f"unknown attention kind {kind!r}")


def logits_from_hidden(params, hidden: torch.Tensor) -> torch.Tensor:
    """Unembed final hidden states: (..., D) -> (..., V) f32 logits over
    the `unembed` table, or the tied `embed` table when there is none.
    `params` is the model module or its compute copy."""
    table = getattr(params, "unembed", None)
    if table is None:
        table = params.embed
    return hidden.float() @ table.float().t()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    diff = pred.float() - target.float()
    return (diff * diff).mean()
