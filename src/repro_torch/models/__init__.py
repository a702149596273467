"""Model zoo: the assigned architectures the port runs (dense so far)."""
from .api import build_model  # noqa: F401
from .config import ModelConfig  # noqa: F401
