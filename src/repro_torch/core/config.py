"""SLA configuration (a copy of `repro.core.config`; the JAX package
imports JAX on `import repro.core`, so the port keeps its own).

Block-size / classification hyper-parameters follow the paper (Sec. 6.1):
b_q = b_kv = 64, k_h = 5% critical, k_l = 10% negligible, phi = softmax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class SLAConfig:
    """Hyper-parameters for Sparse-Linear Attention.

    Attributes:
      block_q: query block size b_q (token rows per block).
      block_kv: key/value block size b_kv.
      kh_frac: fraction of KV blocks per query row classified *critical*
        (computed with exact block-sparse attention). Paper default 5%.
      kl_frac: fraction of KV blocks per query row classified *negligible*
        (skipped entirely). Paper default 10%.
      phi: feature map for the linear branch: "softmax" | "elu1" | "relu".
      mode: "sla" (paper), "sparse_only", "linear_only", "l_plus_s"
        (ablation baselines of Table 2), or "full" (exact attention).
      causal: causal (LM) vs bidirectional (DiT) attention.
      force_diagonal: force the diagonal block critical (guarantees every
        query row has >= 1 critical block; standard in block-sparse attn).
      fixed_budget: if set, overrides kh_frac with a *constant* number of
        critical blocks per row -> O(N) total sparse cost (beyond-paper
        long-context variant; see DESIGN.md).
      proj_init: init for the learnable Proj on the linear branch:
        "zeros" (SLA starts as pure sparse; compensation is learned) or
        "identity".
      col_capacity_factor: TPU adaptation (DESIGN.md §3): cap the number of
        critical blocks per KV *column* at cf * (average per-column count).
        Rows over capacity demote their lowest-score critical blocks to
        *marginal* (still covered by the linear branch — graceful, not
        lossy-skip). Gives the dK/dV kernel a static column-LUT width.
        None disables (pure-paper mask; reference path only).
      plan_refresh_interval: cross-timestep plan reuse (DESIGN.md
        "Plan/execute split"): during diffusion sampling, recompute the
        per-layer SLAPlan every this-many denoising steps and reuse it in
        between (DiT block-sparsity patterns are stable across adjacent
        timesteps). 1 = plan every step (exact paper behavior). Only
        consulted when plan_refresh_mode == "fixed".
      plan_refresh_mode: "fixed" re-plans on the static
        plan_refresh_interval schedule; "adaptive" measures plan drift
        (core/plan.plan_drift — the critical-mass retention of the
        reused structure) every step and re-plans a layer only when its
        drift reaches plan_drift_threshold (DESIGN.md "Plan lifetime &
        drift").
      plan_drift_threshold: drift level (1 - retention, in [0, 1]) at
        which an adaptive refresh rebuilds the plan. 0.0 re-plans every
        step (exact paper behavior); 1.0 never re-plans after the first
        (blind reuse). A tuple gives one threshold PER LAYER (applied
        layer-by-layer, not min-reduced across the stack; see
        `drift_thresholds`).
      decode_mode: autoregressive decode attention path: "dense" runs
        masked softmax over the full static KV cache (O(S) per token);
        "sla" runs decode-time SLA — incremental block plans
        (`core/plan.plan_extend`) + an O(1)-per-token running linear
        state (DESIGN.md "Decode-time SLA").
      decode_budget: number of critical KV blocks per decode query row
        (the static decode LUT width). None derives it from kh_frac at
        the decode cache's maximum block count. A *fixed* budget keeps
        the incremental row classification invariant to the block-grid
        width, which is what makes `plan_extend` provably equal to
        `plan_from_mask` on the full mask.
      routing_mode: how (query-block, kv-block) pairs are scored before
        the top-k classification (DESIGN.md "Learned routing"):
        "threshold" ranks the paper's pooled map P_c (Eq. 2);
        "learned" ranks a trainable SLA2-style per-head scorer
        (`core/masks.predict_routing` — pooled Q/K projected through
        learnable per-head maps). Identity-initialized learned routing
        reproduces the threshold rule bitwise, so every conformance /
        parity guarantee holds unchanged at init; fine-tuning then
        moves the routing with the model (straight-through gradients
        through the plan's marginal aggregation matrix).
      routing_temp: temperature of the straight-through sigmoid
        relaxation around the top-k cuts (learned routing only).
        Smaller = sharper surrogate gradients near the cut.
    """

    block_q: int = 64
    block_kv: int = 64
    kh_frac: float = 0.05
    kl_frac: float = 0.10
    phi: str = "softmax"
    mode: str = "sla"
    causal: bool = False
    force_diagonal: bool = True
    fixed_budget: Optional[int] = None
    proj_init: str = "zeros"
    col_capacity_factor: Optional[float] = 2.0
    plan_refresh_interval: int = 1
    plan_refresh_mode: str = "fixed"
    plan_drift_threshold: Union[float, Tuple[float, ...]] = 0.1
    decode_mode: str = "dense"
    decode_budget: Optional[int] = None
    routing_mode: str = "threshold"
    routing_temp: float = 1.0
    window: int = 0  # sliding-window constraint in TOKENS (0 = none);
    #                  applied at block granularity: out-of-window blocks are
    #                  forced negligible (exact-zero weight under SWA).
    paged: bool = False  # serving: page the per-slot KV cache into a global
    #                      pool of block_kv-sized pages with copy-on-write
    #                      prefix sharing (DESIGN.md "Paged KV & prefix
    #                      caching"); consulted by Scheduler/ServingEngine.
    page_pool_size: Optional[int] = None  # total physical pages in the pool
    #                      (incl. the zero page and per-slot scratch pages);
    #                      None derives a safe default from num_slots*max_len.
    prefill_chunk_blocks: Optional[int] = None  # serving: admission prefill
    #                      advances this many block_q-sized chunks per
    #                      scheduler tick instead of one blocking prefill
    #                      (DESIGN.md "Chunked admission prefill"). Requires
    #                      paged serving; None keeps blocking admission.

    # knob-string vocabularies (validate() is the ONE place that rejects
    # typos; keep these in sync with the dispatch sites they gate —
    # except phi, whose vocabulary lives with its dispatch in core/phi.py)
    MODES = ("sla", "sparse_only", "linear_only", "l_plus_s", "full")
    ROUTING_MODES = ("threshold", "learned")
    PLAN_REFRESH_MODES = ("fixed", "adaptive")
    DECODE_MODES = ("dense", "sla")

    @property
    def PHIS(self) -> Tuple[str, ...]:
        from repro_torch.core.phi import PHI_KINDS
        return PHI_KINDS

    def validate(self) -> "SLAConfig":
        """Loudly reject invalid knob combinations, in one place.

        Every serving/planning entry point (`plan_attention`,
        `backends.execute`/`decode_execute`, `ServingEngine`,
        `Scheduler`) calls this so a typo'd mode string or an impossible
        combination fails at the API boundary with a named field, not
        deep inside a jit trace. Returns self so call sites can chain.
        """
        def _enum(field: str, value: str, allowed: Tuple[str, ...]):
            if value not in allowed:
                raise ValueError(
                    f"SLAConfig.{field}={value!r} is not one of {allowed}")

        _enum("mode", self.mode, self.MODES)
        _enum("phi", self.phi, self.PHIS)
        _enum("routing_mode", self.routing_mode, self.ROUTING_MODES)
        _enum("plan_refresh_mode", self.plan_refresh_mode,
              self.PLAN_REFRESH_MODES)
        _enum("decode_mode", self.decode_mode, self.DECODE_MODES)
        if self.block_q <= 0 or self.block_kv <= 0:
            raise ValueError(
                f"SLAConfig block sizes must be positive (block_q="
                f"{self.block_q}, block_kv={self.block_kv})")
        if not (0.0 <= self.kh_frac <= 1.0 and 0.0 <= self.kl_frac <= 1.0):
            raise ValueError(
                f"SLAConfig.kh_frac/kl_frac must lie in [0, 1] (got "
                f"{self.kh_frac}, {self.kl_frac})")
        if self.plan_refresh_interval < 1:
            raise ValueError(
                f"SLAConfig.plan_refresh_interval must be >= 1 (got "
                f"{self.plan_refresh_interval})")
        if self.window < 0:
            raise ValueError(
                f"SLAConfig.window must be >= 0 (got {self.window})")
        if self.window > 0 and self.decode_mode == "sla":
            # the decode-time subtractive linear state cannot exclude
            # out-of-window past blocks (DESIGN.md "Decode-time SLA")
            raise ValueError(
                "SLAConfig.window > 0 is incompatible with decode_mode="
                "'sla': the subtractive running state covers ALL past "
                "blocks and cannot honor a sliding-window constraint; "
                "use decode_mode='dense' for window-constrained configs")
        if self.decode_mode == "sla" and self.block_q != self.block_kv:
            raise ValueError(
                f"decode_mode='sla' requires block_q == block_kv (got "
                f"{self.block_q} vs {self.block_kv}); the decode grid "
                f"appends one query row per completed KV block")
        if self.page_pool_size is not None and self.page_pool_size < 2:
            raise ValueError(
                f"SLAConfig.page_pool_size must be >= 2 (zero page + at "
                f"least one allocatable page), got {self.page_pool_size}")
        if self.paged and self.block_q != self.block_kv:
            raise ValueError(
                f"paged serving requires block_q == block_kv (pages are "
                f"block_kv-sized and admission is block_q-aligned; got "
                f"{self.block_q} vs {self.block_kv})")
        if self.prefill_chunk_blocks is not None:
            if self.prefill_chunk_blocks < 1:
                raise ValueError(
                    f"SLAConfig.prefill_chunk_blocks must be >= 1 (got "
                    f"{self.prefill_chunk_blocks})")
            if self.block_q != self.block_kv:
                raise ValueError(
                    f"chunked admission prefill requires block_q == "
                    f"block_kv (chunks are whole pages; got "
                    f"{self.block_q} vs {self.block_kv})")
        return self

    def num_critical(self, num_kv_blocks: int) -> int:
        """Number of critical blocks per query row (static)."""
        if self.fixed_budget is not None:
            return max(1, min(self.fixed_budget, num_kv_blocks))
        return max(1, round(self.kh_frac * num_kv_blocks))

    def num_negligible(self, num_kv_blocks: int) -> int:
        return max(0, round(self.kl_frac * num_kv_blocks))

    def col_capacity(self, num_q_blocks: int, num_kv_blocks: int) -> int:
        """Static per-column critical budget (dK/dV column-LUT width)."""
        k_sel = self.num_critical(num_kv_blocks)
        if self.col_capacity_factor is None:
            return num_q_blocks
        avg = num_q_blocks * k_sel / num_kv_blocks
        return max(1, min(num_q_blocks, round(self.col_capacity_factor * avg)))

    def drift_thresholds(self, num_layers: int) -> Tuple[float, ...]:
        """Per-layer drift thresholds, normalized to a length-L tuple.

        A scalar `plan_drift_threshold` is broadcast to every layer; a
        tuple must already have one entry per layer. Callers apply each
        layer's threshold to that layer's own drift (the ROADMAP
        "per-layer, not min-reduced" semantics)."""
        t = self.plan_drift_threshold
        if isinstance(t, (tuple, list)):
            if len(t) != num_layers:
                raise ValueError(
                    f"plan_drift_threshold has {len(t)} entries but the "
                    f"model has {num_layers} layers")
            return tuple(float(x) for x in t)
        return (float(t),) * num_layers

    def decode_plan_cfg(self, num_kv_blocks: int) -> "SLAConfig":
        """Classification config for decode-time incremental plans.

        Decode rows are classified causal with a *static* critical
        budget (row classification becomes invariant to the block-grid
        width — required for `plan_extend` == `plan_from_mask`), no
        negligible class (at decode the linear branch is O(1) running
        state, so skipping blocks saves nothing and would change
        numerics vs the subtractive aggregation), and no column
        capacity (the column LUT feeds only the training backward
        pass; capping it would make row classification depend on other
        rows and break incremental append)."""
        budget = self.decode_budget
        if budget is None:
            budget = self.num_critical(num_kv_blocks)
        return dataclasses.replace(
            self, causal=True, kl_frac=0.0, col_capacity_factor=None,
            fixed_budget=budget, window=0)

    def replace(self, **kw) -> "SLAConfig":
        return dataclasses.replace(self, **kw)
