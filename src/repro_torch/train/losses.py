"""LM losses: cross entropy (+ z-loss) with family-aware forward dispatch.

The JAX package's ``train/losses.py``.  `model_loss` runs the model's
``forward`` with the given parameter tree in place of its own frozen
parameters (``torch.func.functional_call`` over the `ParamTree` names,
which follow the JAX tree), so the tree's leaves get the gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.func import functional_call

from ..models.common import tree_items

__all__ = ["cross_entropy", "model_loss", "named_params"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """logits [B, S, V] float32, targets [B, S] int -> scalar mean nll.

    The reference picks the label's logit by a one-hot contraction (with
    vocab-sharded logits GSPMD turns it into a local reduce + psum).  On
    one card it is a gather here: the contraction adds V - 1 exact zeros
    to the label's logit, so the two give the same bits, and the gather
    neither builds the [B, S, V] one-hot nor reads the logits a second
    time."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = (lse - ll).mean()
    if z_loss:
        nll = nll + z_loss * lse.square().mean()
    return nll


def named_params(params: Any) -> Dict[str, torch.Tensor]:
    """A parameter tree as the model's own parameter names
    ("params.layers.attn.wq"), for ``functional_call``."""
    return {"params." + ".".join(path): leaf
            for path, leaf in tree_items(params)}


def model_loss(model, params: Optional[Any], batch: Dict[str, Any],
               z_loss: float = 0.0) -> torch.Tensor:
    """Forward + CE for any model family (whisper consumes frames), with
    `params` (a tree of the model's shapes; None: its own)."""
    kwargs = {}
    if "frames" in batch:
        kwargs["frames"] = batch["frames"]
    if "positions" in batch:
        kwargs["positions"] = batch["positions"]
    if params is None:
        logits = model.forward(batch["tokens"], **kwargs)
    else:
        logits = functional_call(model, named_params(params),
                                 (batch["tokens"],), kwargs)
    return cross_entropy(logits, batch["targets"], z_loss)
