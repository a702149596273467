"""Train step factory: microbatched grad accumulation, clipping, AdamW,
optional int8 gradient compression with error feedback.

The JAX package's ``train/train_step.py``.  The step is a function
(state, batch) -> (new_state, metrics) that leaves its input state as it
was (a second call from the same state gives the same result); the state
is a plain tree of tensors, so the checkpointer writes it by path.  The
gradient is taken functionally: the parameter tree's leaves go through
the model's ``forward`` in place of its frozen parameters
(`losses.model_loss`), under the caller's device.  On the card attention
runs the flash-attention kernels forward and backward
(`kernels.flash_attention.ops`); with ``remat="full"`` each layer's forward
runs again in the backward.  The metrics stay on the device.

The step carries three ``torch.profiler`` labels: "train.forward",
"train.backward" and "train.optimizer".

On a mesh the state's leaves are DTensors (placed by `train.elastic.
reshard_state`), the model is built with the same mesh, and the batch is
the global one, the same on every rank.  With ``param_specs`` and
``mesh`` the gradient tree, and the microbatch accumulation carry, are
redistributed to the parameters' placements (the reference's sharding
constraints: a gradient that propagation left replicated or partial is
reduce-scattered to its parameter's shards).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..models.common import tree_from_items, tree_items, tree_map
from ..obs.profiler import named_scope
from ..parallel.sharding import constrain, is_dtensor
from .compress import compress_decompress
from .losses import model_loss, named_params

__all__ = ["init_state", "make_train_step", "make_serve_step",
           "value_and_grad"]

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_state(model, opt) -> Dict[str, Any]:
    """{"params", "opt", "step"}.  The parameters are the model's own,
    drawn by `build_model` from its seed (the reference's ``init_state``
    draws them from a key); they share the model's storage, since no step
    writes a parameter in place."""
    params = tree_map(lambda t: t.detach(), model.params.tree())
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def value_and_grad(model, params: Any, batch: Dict[str, Any],
                   z_loss: float = 0.0):
    """(loss, grads) of `model_loss` at `params`: the loss detached (a
    plain tensor, on a mesh too), the gradient a tree of `params`'
    structure and dtypes (zeros where a leaf takes no part)."""
    items = tree_items(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
    tree = tree_from_items((path, leaf) for (path, _), leaf
                           in zip(items, leaves))
    with torch.enable_grad():
        with named_scope("train.forward"):
            loss = model_loss(model, tree, batch, z_loss)
        with named_scope("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    loss = loss.detach()
    if is_dtensor(loss):  # reduced over the shards if still partial
        loss = loss.full_tensor()
    return loss, tree_from_items(
        (path, g) for (path, _), g in zip(items, grads))


def _split_microbatches(batch: Dict[str, Any], n: int):
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    split = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def make_train_step(model, opt, num_microbatches: int = 1,
                    z_loss: float = 0.0,
                    accum_dtype: str = "float32",
                    param_specs=None, mesh=None,
                    compress: Optional[str] = None) -> Callable:
    """compress: None | 'int8' (error-feedback quantized gradients).
    accum_dtype: gradient-accumulation buffer dtype ('bfloat16' halves the
    accumulation memory), used when `num_microbatches` > 1: the
    microbatches' gradients are summed in it, in order, and divided by
    their number, as the reference's scan does.
    param_specs/mesh: when both are given, every gradient (and the
    accumulation carry) is laid out as its parameter's spec on `mesh`."""
    adt = _ACCUM_DTYPES[accum_dtype]
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got {compress!r}")

    if param_specs is not None and mesh is not None:
        def lay_out(grads):
            return tree_map(lambda g, s: constrain(g, mesh, s), grads,
                            param_specs)
    else:
        def lay_out(grads):
            return grads

    def train_step(state, batch):
        params = state["params"]
        if num_microbatches == 1:
            loss, grads = value_and_grad(model, params, batch, z_loss)
            grads = lay_out(grads)
        else:
            grads = lay_out(tree_map(lambda p: torch.zeros_like(
                p, dtype=adt, memory_format=torch.contiguous_format),
                params))
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for mb in _split_microbatches(batch, num_microbatches):
                lm, gm = value_and_grad(model, params, mb, z_loss)
                grads = lay_out(tree_map(lambda a, g: a + g.to(adt), grads,
                                         lay_out(gm)))
                loss = loss + lm
            loss = loss / num_microbatches
            grads = tree_map(lambda g: g / num_microbatches, grads)

        new_ef = None
        if compress == "int8":
            grads, new_ef = compress_decompress(grads, state.get("ef"))
        with named_scope("train.optimizer"):
            new_params, new_opt, metrics = opt.update(grads, state["opt"],
                                                      params)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_ef is not None:
            new_state["ef"] = new_ef
        return new_state, dict(metrics, loss=loss)

    return train_step


class _Decode(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, cache, tokens, pos):
        return self.model.decode_step(cache, tokens, pos)


def make_serve_step(model) -> Callable:
    """(params, cache, tokens, pos) -> (logits, cache): one decode step
    with `params` in place of the model's own (the cache is updated in
    place, as `decode_step` does)."""
    decode = _Decode(model)

    def serve_step(params, cache, tokens, pos):
        named = {"model." + k: v for k, v in named_params(params).items()}
        return functional_call(decode, named, (cache, tokens, pos))

    return serve_step
