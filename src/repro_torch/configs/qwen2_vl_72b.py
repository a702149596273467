"""Qwen2-VL-72B text backbone (arXiv:2409.12191); vision frontend stubbed --
input_specs supplies M-RoPE 3D position ids; patch embeddings precomputed."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
    mlp="swiglu", qkv_bias=True,
)
