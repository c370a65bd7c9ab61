"""SLA attention module — functional public API (plan/execute wrapper).

Usage:
    cfg = SLAConfig(kh_frac=0.05, kl_frac=0.10, phi="softmax")
    params = sla_init(num_heads, head_dim, cfg)
    out = sla_attention(params, q, k, v, cfg)                 # (B, H, N, D)

    # plan once, execute many times (cross-timestep reuse):
    plan = plan_attention(q, k, cfg)
    out = sla_attention(params, q, k, v, cfg, plan=plan)

Counterpart of `repro.core.sla`. `backend` selects "reference" (dense
oracle), "gather" (LUT gather) or "kernel" (fused CUDA kernel).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import backends
from repro_torch.core.config import SLAConfig
from repro_torch.core.plan import SLAPlan

Params = Dict[str, torch.Tensor]


def sla_init(num_heads: int, head_dim: int, cfg: SLAConfig,
             dtype=torch.float32, device=None) -> Params:
    """Learnable parameters: the per-head d x d Proj on the linear branch
    (deterministic, so unlike the reference it takes no random key)."""
    if cfg.proj_init == "identity":
        proj = torch.eye(head_dim, dtype=dtype, device=device)[None]
        proj = proj.repeat(num_heads, 1, 1)
    elif cfg.proj_init == "zeros":
        proj = torch.zeros((num_heads, head_dim, head_dim), dtype=dtype,
                           device=device)
    else:
        raise ValueError(cfg.proj_init)
    return {"proj": proj}


def sla_attention(params: Optional[Params], q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, cfg: SLAConfig,
                  scale: Optional[float] = None, backend: str = "reference",
                  plan: Optional[SLAPlan] = None,
                  routing: Optional[Params] = None) -> torch.Tensor:
    """SLA attention. q: (B, H, N, D); k, v: (B, Hkv, N, D) with Hkv | H.
    `plan`: a precomputed SLAPlan; None plans inline from (q, k).
    Returns (B, H, N, D) in q.dtype."""
    return backends.execute(plan, params, q, k, v, cfg, scale=scale,
                            backend=backend, routing=routing)
