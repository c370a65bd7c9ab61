"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert.
Deviation noted in DESIGN.md: uniform MoE layers (upstream alternates
dense/MoE) to keep the scanned layer stack homogeneous.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_d_ff=8192,
    moe_shared_expert=True,
    sla=SLAConfig(),
)
