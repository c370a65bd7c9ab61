"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared SLA-attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_heads=64, ssm_head_dim=64,  # d_inner = 2 * d_model
    attn_every=6,
    sla=SLAConfig(),
)
