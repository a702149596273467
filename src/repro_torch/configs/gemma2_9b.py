"""Gemma2-9B (arXiv:2408.00118): alternating local(4096)/global attention,
attn logit softcap 50, final logit softcap 30, GeGLU, pre+post block norms."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    layer_pattern=("local", "global"), local_window=4096,
    attn_softcap=50.0, final_softcap=30.0, mlp="geglu",
    tie_embeddings=True, emb_scale_by_sqrt_dim=True,
)
