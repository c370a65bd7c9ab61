"""Mamba2 (SSD) block: scalar-per-head decay state-space model.

Counterpart of `repro.models.mamba2`. A fused in-projection gives
(z, x, B, C, dt); a depthwise causal conv runs over (x, B, C); the SSD
recurrence h_t = a_t h_{t-1} + b_t x_t with a_t = exp(-softplus(dt_t +
bias) exp(A_log)), y_t = C_t h_t + D x_t, is gated by silu(z), RMS-normed
and out-projected. The recurrence runs through the chunk-parallel
masked-matmul path (`linear_scan.decayed_la_chunked`, scalar decay),
or one `decayed_la_step` for a single token with a state. The casts
follow the reference's: dt, its softplus and the decay in f32, the
recurrence in f32, y rounded to the compute dtype before the norm.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.linear_scan import (decayed_la_chunked,
                                            decayed_la_step)

SCAN_CHUNK = 64


class MambaLayer(nn.Module):
    """One Mamba2 layer's parameters (the reference's `layers` leaves at
    one layer index). `a_log`, `dt_bias` and `d_skip` are f32 whatever
    the dtype, as in the reference."""

    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        d, h, n = cfg.d_model, cfg.ssm_heads, cfg.ssm_state
        d_inner = h * cfg.ssm_head_dim
        proj_out = 2 * d_inner + 2 * n + h  # z, x, B, C, dt

        def param(t):
            return nn.Parameter(t)

        f32 = dict(dtype=torch.float32, device=device)
        self.ln = param(torch.zeros(d, dtype=dtype, device=device))
        self.in_proj = param(dense_init(generator, d, proj_out, dtype,
                                        device))
        self.conv = param((torch.randn(
            (cfg.conv_kernel, d_inner + 2 * n), generator=generator, **f32)
            * 0.1).to(dtype))
        self.a_log = param(torch.zeros(h, **f32))
        self.dt_bias = param(torch.zeros(h, **f32))
        self.d_skip = param(torch.ones(h, **f32))
        self.out_norm = param(torch.zeros(d_inner, dtype=dtype,
                                          device=device))
        self.out_proj = param(dense_init(generator, d_inner, d, dtype,
                                         device))


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); tail: (B, K-1, C),
    the previous K-1 input rows (zeros without one). Returns (out, the
    new tail: the last K-1 rows of the padded input)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
           if tail is None else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out, xp[:, -(k - 1):]


def mamba_apply(p, x: torch.Tensor, cfg: ArchConfig,
                conv_tail: Optional[torch.Tensor] = None,
                state: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> (out, (new_state (B, H, N, P) f32, new conv tail)).
    With S == 1 and a state, one recurrence step; otherwise the chunked
    form from `state` (zeros without one)."""
    b, s, _ = x.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner = h * pd
    zxbcdt = x @ p.in_proj.to(x.dtype)
    z, xc, bb, cc, dt = torch.split(zxbcdt, [d_inner, d_inner, n, n, h],
                                    dim=-1)
    conv_out, tail = causal_conv(torch.cat([xc, bb, cc], dim=-1), p.conv,
                                 conv_tail)
    conv_out = F.silu(conv_out)
    xc, bb, cc = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt_soft = F.softplus(dt.float() + p.dt_bias[None, None, :])  # (B,S,H)
    loga = -dt_soft * torch.exp(p.a_log)[None, None, :]
    xh = xc.reshape(b, s, h, pd).transpose(1, 2)  # v-role: (B, H, S, P)
    # B, C shared across heads (a single group)
    bh = bb[:, None].expand(b, h, s, n)
    ch = cc[:, None].expand(b, h, s, n)
    # dt folded into the input (the SSD discretization)
    xin = xh * dt_soft.transpose(1, 2)[..., None].to(xh.dtype)
    la = loga.transpose(1, 2)  # (B, H, S)
    if s == 1 and state is not None:
        y, new_state = decayed_la_step(
            ch[:, :, 0], bh[:, :, 0], xin[:, :, 0],
            la[..., 0:1].expand(b, h, n), state, inclusive=True)
        y = y[:, :, None, :]
    else:
        y, new_state = decayed_la_chunked(ch, bh, xin, la, inclusive=True,
                                          scalar_decay=True, s0=state,
                                          chunk=SCAN_CHUNK)
    y = y + p.d_skip[None, :, None, None] * xh.float()
    y = y.transpose(1, 2).reshape(b, s, d_inner)
    y = y * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), p.out_norm)
    return y @ p.out_proj.to(x.dtype), (new_state, tail)
