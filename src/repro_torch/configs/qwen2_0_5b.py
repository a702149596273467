"""Qwen2-0.5B (arXiv:2407.10671): QKV bias, GQA kv=2, tied embeddings.
14 heads do not divide the 16-way model axis -> attention TP falls back to
replicated weights (see parallel/sharding.py)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, mlp="swiglu", tie_embeddings=True,
)
