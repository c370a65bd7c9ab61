"""Block classification for SLA (paper Sec. 4, Eq. 2-3) — full-map half.

Predicts a compressed attention map P_c = softmax(pool(Q) pool(K)^T / sqrt(d))
over (T_m x T_n) blocks and classifies every block into
  critical (+1, top k_h% per row)  -> exact block-sparse attention,
  negligible (-1, bottom k_l%)     -> skipped,
  marginal (0, the rest)           -> linear attention.

Two routers produce the score map the classification ranks
(`SLAConfig.routing_mode`): "threshold" ranks the paper's pooled P_c;
"learned" ranks a per-head scorer over projected pooled features
(`predict_routing`), whose identity init reproduces the threshold rule.

Counterpart of `repro.core.masks`. Sorts are stable and use the same keys
as the reference, so equal score maps give bitwise-equal classifications.
The row-local decode half arrives with the LM slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config import SLAConfig

NEG_INF = -1e30


def pool_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Mean-pool tokens into blocks. (..., N, D) -> (..., N // block, D)."""
    n, d = x.shape[-2], x.shape[-1]
    if n % block:
        raise ValueError(f"seq len {n} not divisible by block {block}")
    xb = x.reshape(*x.shape[:-2], n // block, block, d)
    return xb.float().mean(dim=-2)


def block_causal_valid(tm: int, tn: int, block_q: int, block_kv: int,
                       device=None) -> torch.Tensor:
    """(tm, tn) bool: block (i, j) contains at least one valid causal pair."""
    qi = (torch.arange(tm, device=device) + 1) * block_q - 1
    kj = torch.arange(tn, device=device) * block_kv
    return qi[:, None] >= kj[None, :]


def block_valid(cfg: SLAConfig, tm: int, tn: int,
                device=None) -> torch.Tensor:
    """(tm, tn) bool validity combining causal + sliding-window constraints
    (window applied at block granularity; see SLAConfig.window)."""
    valid = torch.ones((tm, tn), dtype=torch.bool, device=device)
    if cfg.causal:
        valid = valid & block_causal_valid(tm, tn, cfg.block_q,
                                           cfg.block_kv, device)
    if cfg.window:
        qi = torch.arange(tm, device=device)[:, None] * cfg.block_q
        kj = torch.arange(tn, device=device)[None, :] * cfg.block_kv
        valid = valid & ((qi - kj).abs() < cfg.window + cfg.block_kv)
    return valid


def _pooled_scores(qp: torch.Tensor, kp: torch.Tensor, cfg: SLAConfig,
                   scale: float) -> torch.Tensor:
    """Shared scoring tail over pooled block features: the pooled
    dot-product map, validity masking, row softmax."""
    s = torch.matmul(qp, kp.transpose(-1, -2)) * scale
    if cfg.causal or cfg.window:
        valid = block_valid(cfg, s.shape[-2], s.shape[-1], s.device)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1)


def predict_pc(q: torch.Tensor, k: torch.Tensor, cfg: SLAConfig,
               scale: Optional[float] = None) -> torch.Tensor:
    """Compressed attention map P_c (Eq. 2).
    q, k: (B, H, N, D) -> (B, H, Tm, Tn)."""
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    qp = pool_blocks(q, cfg.block_q)
    kp = pool_blocks(k, cfg.block_kv)
    return _pooled_scores(qp, kp, cfg, scale)


# ---------------------------------------------------------------------------
# learned routing: a per-head scorer over pooled (Q, K) block features
# ---------------------------------------------------------------------------
def check_routing_mode(cfg: SLAConfig, routing=...) -> None:
    """The one loud-failure path for routing selection. Pass `routing`
    to additionally require the learned head's parameters under
    routing_mode == "learned"."""
    if cfg.routing_mode not in ("threshold", "learned"):
        raise ValueError(
            f"unknown routing_mode {cfg.routing_mode!r}; expected "
            "'threshold' or 'learned'")
    if routing is None and cfg.routing_mode == "learned":
        raise ValueError(
            "routing_mode='learned' needs routing parameters "
            "(core.masks.routing_init) — none were passed")


def routing_init(num_heads: int, head_dim: int, dtype=torch.float32,
                 device=None) -> dict:
    """Learnable routing-head parameters: per-head projections applied to
    the pooled block features before scoring. Identity init makes
    `predict_routing` equal `predict_pc`."""
    eye = torch.eye(head_dim, dtype=dtype, device=device)[None]
    eye = eye.repeat(num_heads, 1, 1)
    return {"wq": eye, "wk": eye.clone()}


def predict_routing(routing: dict, q: torch.Tensor, k: torch.Tensor,
                    cfg: SLAConfig,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Learned-routing score map: softmax of projected-pooled scores.
    q, k: (B, H, N, D) -> (B, H, Tm, Tn); routing wq/wk: (H, D, D)."""
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    qp = pool_blocks(q, cfg.block_q)
    kp = pool_blocks(k, cfg.block_kv)
    qp = torch.einsum("bhmd,hde->bhme", qp, routing["wq"].float())
    kp = torch.einsum("bhnd,hde->bhne", kp, routing["wk"].float())
    return _pooled_scores(qp, kp, cfg, scale)


def routing_gates(pc: torch.Tensor, mc: torch.Tensor,
                  cfg: SLAConfig) -> torch.Tensor:
    """Straight-through marginal-aggregation gates for learned routing.

    The forward value is exactly the hard indicator (mc == 0): the soft
    term cancels itself bitwise. The backward sees a sigmoid relaxation
    of the two per-row top-k cuts (levels gradient-stopped)."""
    tn = pc.shape[-1]
    n_crit = cfg.num_critical(tn)
    n_neg = cfg.num_negligible(tn)
    temp = max(float(cfg.routing_temp), 1e-6)
    hard = (mc == 0).float()
    srt = torch.sort(pc, dim=-1).values.detach()  # ascending
    tau_crit = srt[..., tn - n_crit][..., None]
    soft = 1.0 - torch.sigmoid((pc - tau_crit) / temp)
    if n_neg > 0:
        tau_neg = srt[..., n_neg - 1][..., None]
        soft = soft * torch.sigmoid((pc - tau_neg) / temp)
    # (soft - soft.detach()) is exactly 0.0, so the value is bitwise `hard`
    return hard + (soft - soft.detach())


def score_map(routing: Optional[dict], q: torch.Tensor, k: torch.Tensor,
              cfg: SLAConfig, scale: Optional[float] = None) -> torch.Tensor:
    """The routing-mode dispatch for full score maps."""
    check_routing_mode(cfg, routing)
    if cfg.routing_mode == "learned":
        return predict_routing(routing, q, k, cfg, scale)
    return predict_pc(q, k, cfg, scale)


def classify_blocks(pc: torch.Tensor, cfg: SLAConfig) -> torch.Tensor:
    """Three-way block classification M_c (Eq. 3). pc: (..., Tm, Tn) -> int8.

    +1 critical / 0 marginal / -1 negligible. Causal-invalid blocks are -1.
    The diagonal block is forced critical when cfg.force_diagonal.
    """
    tm, tn = pc.shape[-2], pc.shape[-1]
    dev = pc.device
    n_crit = cfg.num_critical(tn)
    n_neg = cfg.num_negligible(tn)

    score = pc
    if cfg.causal or cfg.window:
        valid = block_valid(cfg, tm, tn, dev)
        score = torch.where(valid, score, torch.full_like(score, -1.0))
    force_diag = cfg.force_diagonal or cfg.causal
    if cfg.causal and cfg.block_q != cfg.block_kv:
        raise ValueError("causal SLA requires b_q == b_kv")
    if force_diag and tm <= tn:
        # the (block-)diagonal gets a score above any probability
        if cfg.block_q != cfg.block_kv:
            qi = torch.arange(tm, device=dev) * cfg.block_q // cfg.block_kv
            diag = qi[:, None] == torch.arange(tn, device=dev)[None, :]
        else:
            diag = torch.eye(tm, tn, dtype=torch.bool, device=dev)
        score = torch.where(diag, torch.full_like(score, 2.0), score)

    # Descending rank of every block within its row (stable).
    order = torch.argsort(-score, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)

    one = torch.ones((), dtype=torch.int8, device=dev)
    mc = torch.zeros(pc.shape, dtype=torch.int8, device=dev)
    mc = torch.where(rank < n_crit, one, mc)
    if n_neg > 0:
        mc = torch.where(rank >= tn - n_neg, -one, mc)
    if cfg.causal or cfg.window:
        mc = torch.where(block_valid(cfg, tm, tn, dev), mc, -one)

    if cfg.col_capacity_factor is not None:
        # static per-column critical budget: over-budget blocks demote to
        # marginal (the boosted `score` keeps forced-diagonal blocks first)
        cap = cfg.col_capacity(tm, tn)
        is_crit = mc == 1
        col_key = torch.where(is_crit, score, torch.full_like(score, -2.0))
        col_order = torch.argsort(-col_key, dim=-2, stable=True)
        col_rank = torch.argsort(col_order, dim=-2, stable=True)
        demote = is_crit & (col_rank >= cap)
        mc = torch.where(demote, torch.zeros_like(mc), mc)
    return mc


def compute_mask(q: torch.Tensor, k: torch.Tensor, cfg: SLAConfig,
                 scale: Optional[float] = None,
                 routing: Optional[dict] = None) -> torch.Tensor:
    """Score-map prediction + classification, gradient-stopped."""
    pc = score_map(routing, q.detach(), k.detach(), cfg, scale)
    return classify_blocks(pc, cfg)


def expand_mask(mc: torch.Tensor, block_q: int, block_kv: int
                ) -> torch.Tensor:
    """Expand a (..., Tm, Tn) block classification to (..., N, M)."""
    out = torch.repeat_interleave(mc, block_q, dim=-2)
    return torch.repeat_interleave(out, block_kv, dim=-1)


def sparsity_stats(mc: torch.Tensor) -> dict:
    """Fractions of critical / marginal / negligible blocks."""
    total = mc.numel()
    crit = (mc == 1).sum() / total
    marg = (mc == 0).sum() / total
    neg = (mc == -1).sum() / total
    return {
        "critical_frac": crit,
        "marginal_frac": marg,
        "negligible_frac": neg,
        "sparsity": 1.0 - crit,
    }
