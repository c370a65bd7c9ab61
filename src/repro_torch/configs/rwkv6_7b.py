"""rwkv6-7b "Finch" [ssm]: attention-free, data-dependent decay.
SLA inapplicable (no softmax attention) — DESIGN.md §4 Arch-applicability.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    head_dim=64, d_ff=14336, vocab_size=65536,
    ssm_heads=64, ssm_head_dim=64,
    attention_kind="none",
    sla=SLAConfig(),
)
