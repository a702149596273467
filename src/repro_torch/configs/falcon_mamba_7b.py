"""Falcon-Mamba-7B (arXiv:2410.05355): mamba1, attention-free, 64 blocks.
Attention-free -> the 500k-token decode shape runs (O(1) state)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)
