"""Whisper-base (arXiv:2212.04356): enc-dec; conv frontend stubbed (encoder
consumes precomputed 1500-frame embeddings per the assignment)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51968,  # 51865 padded to 256-multiple for vocab TP
    mlp="gelu", encoder_layers=6, encoder_frames=1500, tie_embeddings=True,
)
