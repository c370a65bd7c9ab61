"""whisper-small [audio]: enc-dec backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356;
unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51865,
    encoder_layers=12, decoder_layers=12,
    frontend="audio_stub",
    sla=SLAConfig(),
)
