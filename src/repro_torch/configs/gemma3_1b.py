"""gemma3-1b [dense]: 5:1 local:global attention, 256-dim heads, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    head_dim=256, d_ff=6912, vocab_size=262144,
    local_global_pattern=6, local_window=512,  # 5 local : 1 global (SLA)
    rope_theta=1e6,
    sla=SLAConfig(),
)
