"""Qwen1.5/2-MoE-A2.7B (hf:Qwen/Qwen1.5-MoE-A2.7B): 60 routed experts top-4
(padded to 64 for even EP over the 16-way model axis; pad experts masked at
the router) + 4 shared experts (5632 total shared intermediate)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936,
    num_experts=60, num_experts_padded=64, top_k=4, shared_d_ff=5632,
    qkv_bias=True, mlp="swiglu",
)
