"""Model zoo: the assigned architectures, all five families of the JAX
package (dense, MoE, SSM, hybrid, encoder-decoder)."""
from .api import build_model  # noqa: F401
from .config import ModelConfig  # noqa: F401
