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

Under a DeviceMesh (`distributed.ctx`) the heads split over "model":
each rank takes its heads' z, x and dt columns of the packed in-projection
and all of B and C (one group, shared by the heads), the same channels of
the conv and its heads of `a_log`, `dt_bias`, `d_skip` and `out_norm`.
Those weights are read whole and sliced (`fsdp_gather` kind "tp": their
gradients sum over "model"). The output norm's mean of squares over the
whole d_inner sums over "model" (`ctx.sum_model`); `out_proj` is
row-parallel. Under context parallelism the conv's tail is the previous
rank's last K - 1 inputs (`ctx.halo`) and the scan starts from the state
entering this rank (`linear_scan`). Without a mesh the slices are the
whole tensors. In serving the cache holds the whole conv tail on every
"model" rank: `rank_tail` slices a rank's channels out of it and
`whole_tail` puts every rank's back in the reference's order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ctx
from repro_torch.models.common import dense_init
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


def _cols(t: torch.Tensor, spans) -> torch.Tensor:
    """The (start, width) column spans of t's last dim, concatenated."""
    return torch.cat([t.narrow(-1, a, w) for a, w in spans], dim=-1)


def conv_spans(cfg: ArchConfig, rank: int, m: int) -> list:
    """(start, width) spans of the conv channels (x of every head, then B,
    then C: the reference's order) that "model" rank `rank` of `m` runs:
    its heads' x channels, and all of B and C."""
    di = cfg.ssm_heads // m * cfg.ssm_head_dim
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    return [(rank * di, di), (d_inner, 2 * cfg.ssm_state)]


def rank_tail(whole: torch.Tensor, cfg: ArchConfig, rank: int, m: int
              ) -> torch.Tensor:
    """This "model" rank's channels of a whole conv tail (..., d_conv):
    the tail `mamba_apply` reads under the mesh."""
    if m == 1:
        return whole
    return _cols(whole, conv_spans(cfg, rank, m))


def whole_tail(parts, cfg: ArchConfig) -> torch.Tensor:
    """The whole conv tail (..., d_conv) in the reference's channel order
    from every "model" rank's tail (`rank_tail`'s layout), in rank order:
    each rank's x channels in turn, then B and C from rank 0, so that
    every rank that assembles them holds the same bits."""
    if len(parts) == 1:
        return parts[0]
    di = cfg.ssm_heads // len(parts) * cfg.ssm_head_dim
    return torch.cat([p[..., :di] for p in parts] + [parts[0][..., di:]],
                     dim=-1)


def _split_rms_norm(y: torch.Tensor, w: torch.Tensor, width: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """`common.rms_norm` over a last dim of `width` columns of which y
    holds this "model" rank's: the sum of squares is summed over
    "model"."""
    y32 = y.float()
    var = ctx.sum_model((y32 * y32).sum(dim=-1, keepdim=True)) / width
    r = torch.rsqrt(var + eps)
    return y * r.to(y.dtype) * (1.0 + w.float()).to(y.dtype)


def mamba_apply(p, x: torch.Tensor, cfg: ArchConfig,
                conv_tail: Optional[torch.Tensor] = None,
                state: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> (out, (new_state (B, H, N, P) f32, new conv tail)).
    With S == 1 and a state, one recurrence step; otherwise the chunked
    form from `state` (zeros without one). Under a mesh, this "model"
    rank's heads (module docstring): the state and the tail are its
    heads' and channels'."""
    b, s, _ = x.shape
    rank, m = ctx.model_rank_size()
    hh, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner = hh * pd
    h = hh // m
    di = h * pd
    # this rank's z, x, B, C, dt columns of the packed projection
    spans = [(rank * di, di), (d_inner + rank * di, di), (2 * d_inner, 2 * n),
             (2 * d_inner + 2 * n + rank * h, h)]
    x = ctx.to_tp(x)
    w_in = _cols(ctx.fsdp_gather(p.in_proj, "tp"), spans)
    zxbcdt = x @ w_in.to(x.dtype)
    z, xc, bb, cc, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_w = _cols(ctx.fsdp_gather(p.conv, "tp"), conv_spans(cfg, rank, m))
    xbc = torch.cat([xc, bb, cc], dim=-1)
    if conv_tail is None:
        conv_tail = ctx.halo(xbc, conv_w.shape[0] - 1)
    conv_out, tail = causal_conv(xbc, conv_w, conv_tail)
    conv_out = F.silu(conv_out)
    xc, bb, cc = torch.split(conv_out, [di, n, n], dim=-1)

    def heads(w):
        return ctx.fsdp_gather(w, "tp").narrow(0, rank * h, h)

    dt_soft = F.softplus(dt.float() + heads(p.dt_bias)[None, None, :])
    loga = -dt_soft * torch.exp(heads(p.a_log))[None, None, :]
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
    y = y + heads(p.d_skip)[None, :, None, None] * xh.float()
    y = y.transpose(1, 2).reshape(b, s, di)
    y = y * F.silu(z.float())
    norm_w = ctx.fsdp_gather(p.out_norm, "tp").narrow(0, rank * di, di)
    y = _split_rms_norm(y.to(x.dtype), norm_w, d_inner)
    return (ctx.from_tp(y @ ctx.fsdp_gather(p.out_proj, "row").to(x.dtype)),
            (new_state, tail))
