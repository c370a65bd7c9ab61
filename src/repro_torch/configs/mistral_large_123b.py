"""mistral-large-123b [dense]. [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=32768,
    attention_kind="sla",
    sla=SLAConfig(),
)
