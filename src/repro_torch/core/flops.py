"""FLOPs accounting for attention variants (paper Tables 1-3 'FLOPs' column).

Convention: 1 multiply-accumulate = 2 FLOPs, matching XLA cost_analysis.
Counts are per (batch element x layer), summed over heads, forward only,
unless stated otherwise. `d` is the head dim, `h` heads, `n` tokens.

Counterpart of `repro.core.flops`: the same arithmetic in the same order,
so every count is the same Python float.
"""
from __future__ import annotations

from repro_torch.core.config import SLAConfig


def full_attention_flops(n: int, d: int, h: int) -> float:
    """QK^T + PV: 2 matmuls of (n x d x n) each => 4 n^2 d per head."""
    return 4.0 * n * n * d * h


def linear_attention_flops(n: int, d: int, h: int) -> float:
    """phi(K)^T V (2nd^2) + phi(Q) H (2nd^2) + normalizer (~2nd)."""
    return (4.0 * n * d * d + 2.0 * n * d) * h


def sla_flops(n: int, d: int, h: int, cfg: SLAConfig,
              include_overheads: bool = True) -> dict:
    """FLOPs breakdown of SLA at sequence length n.

    sparse   : 4 n^2 d * (critical fraction)
    linear   : h_j/z_j precompute + per-row phi(Q_i)H_i  (Eq. 5)
    mask     : pooled score map  pool(Q)pool(K)^T + softmax (Eq. 2)
    routing  : learned-routing head only (cfg.routing_mode == "learned"):
               per-head d x d projections of the pooled Q (Tm rows) and
               pooled K (Tn rows) block features; 0 under "threshold"
    aggregate: marginal-indicator matmul A @ h (TPU pre-aggregation form)
    proj     : learnable d x d on the linear output (Eq. 6)
    """
    tm, tn = n // cfg.block_q, n // cfg.block_kv
    crit_frac = cfg.num_critical(tn) / tn
    sparse = 4.0 * n * n * d * crit_frac * h
    linear = (4.0 * n * d * d) * h
    mask = (2.0 * tm * tn * d + 5.0 * tm * tn) * h
    routing = (2.0 * (tm + tn) * d * d * h
               if cfg.routing_mode == "learned" else 0.0)
    agg = (2.0 * tm * tn * (d * d + d)) * h if include_overheads else 0.0
    proj = 2.0 * n * d * d * h
    total = sparse + linear + mask + routing + agg + proj
    return {
        "sparse": sparse,
        "linear": linear,
        "mask": mask,
        "routing": routing,
        "aggregate": agg,
        "proj": proj,
        "total": total,
        "full": full_attention_flops(n, d, h),
        "reduction_x": full_attention_flops(n, d, h) / total,
        "sparsity": 1.0 - crit_frac,
    }


def dense_decode_flops(n: int, d: int, h: int) -> float:
    """Per-token dense masked decode: q K^T (2nd) + p V (2nd) per head —
    O(S) in the context length (the decode_* cells' old cost model)."""
    return 4.0 * n * d * h


def sla_decode_flops(n: int, d: int, h: int, cfg: SLAConfig,
                     num_critical: int | None = None) -> dict:
    """Per-token decode-SLA attention FLOPs (DESIGN.md "Decode-time SLA").

    sparse : attend the live row's K critical blocks (4 K b_kv d)
    state  : O(1) running-state update phi(k) v^T + totals (~4 d^2)
    linear : subtractive aggregation H - sum_crit h_j (2 K d^2) plus the
             phi(q) H / phi(q) Z apply (2 d^2 + 2 d)
    proj   : learned d x d merge (Eq. 6)
    plan   : amortized block-boundary row classification — one O(Tn d)
             pooled-score row + top-k every b_q tokens
    routing: learned-routing head only: projecting the pooled q row and
             the Tn pooled-k features at each block boundary, amortized
             like `plan`; 0 under "threshold"

    Everything except `plan`/`routing` is independent of the context
    length n: the O(S) dense term is replaced by critical-blocks + an
    O(1) linear term, with planning amortized to O(Tn / b_q) per token.
    """
    tn = max(1, n // cfg.block_kv)
    if num_critical is not None:
        k_sel = num_critical
    elif cfg.decode_budget is not None:
        k_sel = cfg.decode_budget  # the static decode budget
    else:
        k_sel = cfg.num_critical(tn)
    k_sel = max(1, min(k_sel, tn))
    sparse = 4.0 * k_sel * cfg.block_kv * d * h
    state = 4.0 * d * d * h
    linear = (2.0 * k_sel * d * d + 2.0 * d * d + 2.0 * d) * h
    proj = 2.0 * d * d * h
    plan = (2.0 * tn * d + 5.0 * tn) * h / cfg.block_q
    routing = (2.0 * (tn + 1) * d * d * h / cfg.block_q
               if cfg.routing_mode == "learned" else 0.0)
    total = sparse + state + linear + proj + plan + routing
    dense = dense_decode_flops(n, d, h)
    return {
        "sparse": sparse,
        "state": state,
        "linear": linear,
        "proj": proj,
        "plan": plan,
        "routing": routing,
        "total": total,
        "dense": dense,
        "reduction_x": dense / total,
    }


def sla_subtractive_agg_flops(n: int, d: int, h: int, cfg: SLAConfig) -> float:
    """Aggregation cost with the subtract-non-marginal optimization:
    H_i = H_total - sum_{crit+neg j} h_j   (paper App. A.3, gather form).
    """
    tm, tn = n // cfg.block_q, n // cfg.block_kv
    sub_frac = (cfg.num_critical(tn) + cfg.num_negligible(tn)) / tn
    return (2.0 * tm * tn * (d * d + d)) * sub_frac * h
