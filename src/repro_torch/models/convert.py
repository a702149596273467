"""Carry the JAX package's parameters into the port.

`params_from_reference` takes the JAX model's parameter tree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's tree of tensors, name for name: both packages keep the same
layout (`transformer.defs`, `mamba.defs`, `griffin.defs`, `whisper.defs`:
the stacked layers, the MoE expert stacks [L, E, d, f], deepseek's
``layer0``, Mamba's ``in_proj`` [L, d, 2, E], Griffin's ``rec`` / ``att``
/ ``tail``, Whisper's ``encoder`` / ``decoder``), so this is a copy, with
no reshaping.  A whole train state (``{"params", "opt": {"mu", "nu",
"count"} | {"vr", "vc", "count"}, "step"[, "ef"]}``, the trees of
``repro.train`` and `repro_torch.train` alike) carries over the same way,
every leaf in its own dtype.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .common import tree_map

__all__ = ["params_from_reference"]


def params_from_reference(tree: Any,
                          device: Union[str, torch.device, None] = "cuda",
                          dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on `device`,
    in `dtype` (default: float32 for the reference's float32 leaves, and
    bfloat16 for its bfloat16 ones, which numpy holds as ml_dtypes)."""
    dev = resolve_device(device)

    def one(a):
        a = np.array(a)  # a writable copy (jax arrays give read-only views)
        if a.dtype.name == "bfloat16":  # no numpy bfloat16: go via float32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(dev, dtype or t.dtype)

    return tree_map(one, tree)
