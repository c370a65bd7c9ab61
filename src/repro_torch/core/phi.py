"""Feature maps phi(.) for the linear-attention branch of SLA.

The paper ablates softmax (best), elu+1, and hedgehog; we provide softmax,
elu+1 and relu. All maps produce non-negative features so the linear-branch
denominator phi(Q) . Z is positive whenever any marginal block exists.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def phi(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Apply the feature map along the head dimension (last axis).

    Computed in f32 regardless of input dtype (returned in f32; callers cast).
    """
    x = x.float()
    if kind == "softmax":
        return torch.softmax(x, dim=-1)
    if kind == "elu1":
        return F.elu(x) + 1.0
    if kind == "relu":
        return F.relu(x) + 1e-6
    raise ValueError(f"unknown phi kind: {kind!r}")


PHI_KINDS = ("softmax", "elu1", "relu")
