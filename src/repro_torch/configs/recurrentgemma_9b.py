"""RecurrentGemma-9B / Griffin (arXiv:2402.19427): RG-LRU + local MQA
attention (window 2048) in a 2:1 pattern.  Recurrent state + rolling window
cache -> the 500k-token decode shape runs."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    local_window=2048, lru_width=4096, mlp="geglu",
    tie_embeddings=True, emb_scale_by_sqrt_dim=True,
)
