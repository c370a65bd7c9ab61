"""Core SLA library: config, classification, planning, execution."""
from repro_torch.core.config import SLAConfig
from repro_torch.core.plan import (SLAPlan, plan_attention, plan_from_mask,
                                   refresh_plan, refresh_plan_per_sample)
from repro_torch.core.backends import (available_backends, execute,
                                       get_backend, resolve)
from repro_torch.core.sla import sla_attention, sla_init

__all__ = ["SLAConfig", "SLAPlan", "plan_attention", "plan_from_mask",
           "refresh_plan", "refresh_plan_per_sample", "available_backends",
           "execute", "get_backend", "resolve", "sla_attention", "sla_init"]
