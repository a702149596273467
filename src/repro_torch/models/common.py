"""Parameter-definition tables + shared layer math.

Each module declares its parameters once as a (possibly nested) dict of
`ParamDef(shape, logical_axes, init)`, as in the JAX package's
``models/common.py``; `init_params` builds the tensors from that table.
Layer stacks are `stack_defs`-wrapped: every leaf gets a leading
``layers`` dimension, the JAX package's scan-over-layers layout, which the
port keeps so that the two trees match name for name and shape for shape.
The logical axes are kept for the sharding slice (`param_specs` waits for
``parallel/sharding``, ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

__all__ = ["ParamDef", "init_params", "stack_defs", "rms_norm", "dtype_of",
           "count_params", "embed_lookup", "tree_map", "ParamTree",
           "LanguageModel"]

# fill a large tensor this many elements at a time, so the float32 draw
# beside a bfloat16 [layers, d, d_ff] stack stays small
_INIT_CHUNK = 1 << 26


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | normal | zeros | ones
    fan_dims: Tuple[int, ...] = (0,)  # dims whose product is fan-in
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` over the leaves of nested dicts (a parameter or cache tree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _init_one(d: ParamDef, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "normal":
        std = d.scale
    elif d.init == "fan_in":  # variance scaling
        fan = float(np.prod([d.shape[i] for i in d.fan_dims])) or 1.0
        std = d.scale / np.sqrt(fan)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    out = torch.empty(d.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), _INIT_CHUNK):
        part = flat[start:start + _INIT_CHUNK]
        draw = torch.empty(part.shape, dtype=torch.float32, device=device)
        # a normal truncated at +-2 standard deviations, then scaled
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(draw * std)
    return out


def init_params(defs: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device, None] = "cuda") -> Any:
    """A tree of tensors of `defs`' shapes on `device`: zeros or ones as
    declared, else a normal truncated at +-2 std times ``scale`` ("normal")
    or ``scale / sqrt(fan)`` ("fan_in"), drawn in
    float32 from `generator` (which must live on `device`) and cast to
    `dtype`."""
    dev = resolve_device(device)
    return tree_map(lambda d: _init_one(d, generator, dtype, dev), defs)


def stack_defs(defs: Any, num_layers: int) -> Any:
    """Prepend a `layers` dimension to every ParamDef (scan layout)."""
    return tree_map(
        lambda d: ParamDef((num_layers,) + d.shape, ("layers",) + d.logical,
                           d.init, tuple(i + 1 for i in d.fan_dims), d.scale),
        defs)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) parametrization (gemma/qwen style).

    The JAX package's rounding steps: the square in the input dtype, its
    mean in float32, the normalizer and the weight cast back to x's dtype
    before the two multiplies.  (The reference's ``zero_centered=False``
    has no caller and is not carried over.)"""
    var = x.square().float().mean(dim=-1, keepdim=True)
    nrm = torch.rsqrt(var + eps).to(x.dtype)
    return x * nrm * (1.0 + scale.float()).to(x.dtype)


def count_params(tree: Any) -> int:
    """Number of parameters in a tree of tensors or of `ParamDef`s (the
    latter allocates nothing)."""
    return int(sum(np.prod(p.shape, dtype=np.int64) for p in _leaves(tree)))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows `tokens` of `table` (the JAX package's gather path, no mesh)."""
    return table[tokens]


class ParamTree(nn.Module):
    """A nested dict of tensors as registered, frozen parameters, so that
    ``state_dict`` names follow the JAX tree ("layers.attn.wq")."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {n: m.tree() for n, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class LanguageModel(nn.Module):
    """What the port's LMs share: `params` checked against their table
    `table` (shapes, name for name) and held as frozen parameters, and the
    embedding and unembedding the JAX models compute alike."""

    def __init__(self, cfg, params: Dict[str, Any], table: Dict[str, Any]):
        super().__init__()
        want = tree_map(lambda d: tuple(d.shape), table)
        got = tree_map(lambda t: tuple(t.shape), params)
        if want != got:
            raise ValueError(f"params do not match {cfg.name}'s table: "
                             f"expected {want}, got {got}")
        self.cfg = cfg
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embedding.device

    @property
    def dtype(self) -> torch.dtype:
        return self.params.embedding.dtype

    def _embed(self, p, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(p["embedding"], tokens)
        if self.cfg.emb_scale_by_sqrt_dim:  # the scale rounded to x's dtype
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _unembed(self, p, x: torch.Tensor,
                 tied: Optional[bool] = None) -> torch.Tensor:
        """float32 logits of x.  The embedding's transpose is the output
        table where `tied` (default: ``cfg.tie_embeddings``), else
        ``lm_head``: the Mamba reference unembeds with the embedding
        whatever its config says and has no ``lm_head``."""
        tied = self.cfg.tie_embeddings if tied is None else tied
        w = p["embedding"].T if tied else p["lm_head"]
        logits = (x @ w.to(x.dtype)).float()
        cap = self.cfg.final_softcap
        if cap is not None:  # in place: [B, S, V] float32 is large
            logits.div_(cap).tanh_().mul_(cap)
        return logits
