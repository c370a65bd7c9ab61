"""Core SLA library: config, classification, planning, execution.

Counterpart of `repro.core`, with the same public names:
  masks.py    — P_c prediction + three-way block classification (Eq. 2-3)
  plan.py     — SLAPlan: LUTs + aggregation structure, built once
  backends.py — execution backend registry (reference / gather / kernel)
  sla.py      — the public `sla_attention` wrapper
  flops.py    — FLOPs accounting (paper Tables 1-3)
Importing it builds no kernel: the kernel backend builds its CUDA source
at its first launch.
"""
from repro_torch.core.backends import (
    available_backends,
    decode_execute,
    execute,
    get_backend,
    register_backend,
    register_decode_backend,
    resolve,
    resolve_decode,
)
from repro_torch.core.config import SLAConfig
from repro_torch.core.masks import (
    check_routing_mode,
    classify_blocks,
    classify_row,
    compute_mask,
    expand_mask,
    pool_blocks,
    predict_pc,
    predict_pc_row,
    predict_routing,
    predict_routing_row,
    routing_gates,
    routing_init,
    row_valid,
    score_map,
    score_row,
    sparsity_stats,
)
from repro_torch.core.phi import PHI_KINDS, phi
from repro_torch.core.plan import (
    SLAPlan,
    build_col_lut,
    build_lut,
    empty_plan,
    plan_attention,
    plan_drift,
    plan_extend,
    plan_from_mask,
    plan_retention,
    refresh_plan,
    refresh_plan_per_sample,
)
from repro_torch.core.sla import sla_attention, sla_init
from repro_torch.core import reference, flops

__all__ = [
    "SLAConfig", "phi", "PHI_KINDS",
    "pool_blocks", "predict_pc", "classify_blocks", "compute_mask",
    "expand_mask", "sparsity_stats",
    "predict_pc_row", "classify_row", "row_valid",
    "predict_routing", "predict_routing_row", "routing_gates",
    "routing_init", "check_routing_mode", "score_map", "score_row",
    "SLAPlan", "plan_attention", "plan_from_mask",
    "plan_drift", "plan_retention", "refresh_plan",
    "refresh_plan_per_sample",
    "empty_plan", "plan_extend",
    "build_lut", "build_col_lut",
    "execute", "get_backend", "register_backend", "available_backends",
    "resolve",
    "decode_execute", "register_decode_backend", "resolve_decode",
    "sla_attention", "sla_init", "reference", "flops",
]
