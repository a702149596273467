"""Training substrate: optimizer, step factories, data, checkpointing,
elastic scaling, gradient compression.

The JAX package's ``repro.train`` on PyTorch: the same exports, the same
state tree ({"params", "opt", "step"[, "ef"]}), the same numpy data and
the same checkpoint layout, and on a torch ``DeviceMesh`` the sharded
step (``make_train_step(..., param_specs=, mesh=)``) with
``elastic.reshard_state`` and ``checkpoint.restore(shardings=)``.
"""
from .optimizer import AdamW, cosine_schedule  # noqa: F401
from .train_step import init_state, make_train_step, make_serve_step  # noqa: F401
from .losses import cross_entropy, model_loss  # noqa: F401
from .data import DataConfig, SyntheticPipeline  # noqa: F401
