"""Dense oracle with the signature of `ops.sla_attention_core`.

Counterpart of `repro.kernels.ref`: the kernel path (plain twin on the
CPU, CUDA kernel on the card) must match it at small sizes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import reference as _ref
from repro_torch.core.config import SLAConfig


def sla_attention_core_reference(q, k, v, qp, kp, mc, cfg: SLAConfig,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reference for (O^s, O^l)."""
    return _ref.sla_forward_reference(q, k, v, qp, kp, mc, cfg, scale)


full_attention = _ref.full_attention
full_linear = _ref.full_linear
sparse_component = _ref.sparse_component
linear_component = _ref.linear_component
