"""Model zoo: the assigned architectures the port runs (the dense, MoE and
hybrid families; SSM and enc-dec wait for their slice)."""
from .api import build_model  # noqa: F401
from .config import ModelConfig  # noqa: F401
