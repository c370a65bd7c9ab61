"""Attention execution backends: one registry, one `execute` interface.

`core/plan.py` classifies blocks and builds LUTs once; this module runs
the attention math given that plan. Three backends, all returning
(O^s, O^l):

  reference  dense oracle (O(N^2); validation only)
  gather     LUT-gather PyTorch path whose work is the true sparse cost
  kernel     the fused CUDA kernel (its plain twin for CPU tensors)

`execute(plan, params, q, k, v, cfg, backend=...)` owns mode dispatch
("sla" / "sparse_only" / "linear_only" / "l_plus_s" / "full"), the phi
feature maps, GQA head broadcast, and the learned Proj merge (Eq. 6).
Counterpart of `repro.core.backends`, execute half; the decode registry
arrives with the LM slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import reference as ref
from repro_torch.core.config import SLAConfig
from repro_torch.core.phi import phi
from repro_torch.core.plan import SLAPlan, plan_attention
from repro_torch.core.plan import repeat_kv as _repeat_kv

Params = Dict[str, torch.Tensor]
# A backend maps (plan, q, k, v, qp, kp, cfg, scale) -> (O^s, O^l).
BackendFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

_BACKENDS: Dict[str, BackendFn] = {}

# Legacy spellings from the reference's pre-registry API.
_ALIASES = {"pallas": "kernel", "xla": "gather", "dense": "reference"}


def register_backend(name: str) -> Callable[[BackendFn], BackendFn]:
    """Decorator: register `fn` as the SLA execution backend `name`."""

    def deco(fn: BackendFn) -> BackendFn:
        _BACKENDS[name] = fn
        return fn

    return deco


def resolve(name: str) -> str:
    """Canonical backend name for `name` (resolving legacy aliases);
    unknown names fail loudly."""
    key = _ALIASES.get(name, name)
    if key not in _BACKENDS:
        raise ValueError(
            f"unknown SLA backend {name!r}; available: "
            f"{sorted(_BACKENDS)} (aliases: "
            f"{ {a: t for a, t in sorted(_ALIASES.items())} })")
    return key


def get_backend(name: str) -> BackendFn:
    return _BACKENDS[resolve(name)]


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


@register_backend("reference")
def _reference_backend(plan, q, k, v, qp, kp, cfg, scale):
    return ref.sla_forward_reference(q, k, v, qp, kp, plan.mc, cfg, scale,
                                     marginal=plan.marginal)


@register_backend("gather")
def _gather_backend(plan, q, k, v, qp, kp, cfg, scale):
    from repro_torch.core.block_sparse_xla import sla_forward_gather
    return sla_forward_gather(q, k, v, qp, kp, plan, cfg, scale)


@register_backend("kernel")
def _kernel_backend(plan, q, k, v, qp, kp, cfg, scale):
    from repro_torch.kernels import ops as kops
    return kops.sla_attention_core(q, k, v, qp, kp, plan, cfg, scale=scale)


def execute(plan: Optional[SLAPlan], params: Optional[Params],
            q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: SLAConfig, scale: Optional[float] = None,
            backend: str = "reference",
            routing: Optional[Params] = None) -> torch.Tensor:
    """Run SLA attention under `cfg.mode` with the given execution backend.

    q: (B, H, N, D); k, v: (B, Hkv, N, D) with Hkv | H. `plan` is the
    precomputed SLAPlan for (q, k); None plans inline. Modes that need no
    block structure ("full", "linear_only") ignore the plan.

    Returns (B, H, N, D) in q.dtype.
    """
    backend = resolve(backend)
    cfg.validate()
    in_dtype = q.dtype
    h = q.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)

    if cfg.mode == "full":
        return ref.full_attention(q, k, v, cfg.causal, scale).to(in_dtype)

    if cfg.mode == "linear_only":
        qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)
        o = ref.full_linear(qp, kp, v)
        if params is not None:
            o = torch.einsum("bhnd,hde->bhne", o, params["proj"].float())
        return o.to(in_dtype)

    if plan is None:
        plan = plan_attention(q, k, cfg, scale, routing=routing)
    else:
        tm, tn = q.shape[2] // cfg.block_q, k.shape[2] // cfg.block_kv
        if tuple(plan.mc.shape[-2:]) != (tm, tn):
            raise ValueError(
                f"stale SLAPlan: plan is for {tuple(plan.mc.shape[-2:])} "
                f"blocks but (q, k) need ({tm}, {tn}) — re-plan with "
                f"plan_attention(q, k, cfg)")

    if cfg.mode == "sparse_only":
        o_s, _ = ref.sparse_component(q, k, v, plan.mc, cfg, scale)
        return o_s.to(in_dtype)

    qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)

    if cfg.mode == "l_plus_s":
        o_s, _ = ref.sparse_component(q, k, v, plan.mc, cfg, scale)
        o_l = ref.full_linear(qp, kp, v)
        return (o_s + o_l).to(in_dtype)

    if cfg.mode != "sla":
        raise ValueError(f"unknown SLA mode {cfg.mode!r}")

    o_s, o_l = get_backend(backend)(plan, q, k, v, qp, kp, cfg, scale)
    proj = params["proj"].float()
    o = o_s + torch.einsum("bhnd,hde->bhne", o_l, proj)
    return o.to(in_dtype)
