"""DeepSeekMoE-16B (arXiv:2401.06066): fine-grained 64 routed experts top-6
+ 2 shared experts (2816 shared intermediate); first layer is a dense MLP."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    num_experts=64, top_k=6, shared_d_ff=2816, first_dense_d_ff=10944,
    mlp="swiglu",
)
