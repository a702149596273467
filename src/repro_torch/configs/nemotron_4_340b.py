"""Nemotron-4-340B (arXiv:2402.16819): squared-ReLU MLP, GQA kv=8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000,
    mlp="relu2", rope_theta=1e4,
)
