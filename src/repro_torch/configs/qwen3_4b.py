"""Qwen3-4B (hf:Qwen/Qwen3-4B): qk_norm RMSNorm on per-head q/k, GQA."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, mlp="swiglu", tie_embeddings=True,
)
