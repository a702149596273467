"""LM losses: cross entropy (+ z-loss) with family-aware forward dispatch.

The JAX package's ``train/losses.py``.  `model_loss` runs the model's
``forward`` with the given parameter tree in place of its own frozen
parameters (``torch.func.functional_call`` over the `ParamTree` names,
which follow the JAX tree), so the tree's leaves get the gradients.  On
a mesh the logits are a DTensor and the targets the global batch's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.func import functional_call

from ..models.common import tree_items
from ..parallel.sharding import is_dtensor, replicate_like

__all__ = ["cross_entropy", "model_loss", "named_params"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """logits [B, S, V] float32, targets [B, S] int -> scalar mean nll.

    The reference picks the label's logit by a one-hot contraction (with
    vocab-sharded logits GSPMD turns it into a local reduce + psum).  On
    one card it is a gather here: the contraction adds V - 1 exact zeros
    to the label's logit, so the two give the same bits, and the gather
    neither builds the [B, S, V] one-hot nor reads the logits a second
    time.  On a mesh the logits are a DTensor; where its vocab dim is
    sharded, `_VocabParallelCE` takes the logsumexp and the label's logit
    together."""
    targets = targets.long()
    if _vocab_sharded(logits):
        lse, ll = _VocabParallelCE.apply(logits, targets)
    else:  # one card, or a mesh of one: its bits
        lse = torch.logsumexp(logits, dim=-1)
        ll = _label_logits(logits, targets)
    nll = (lse - ll).mean()
    if z_loss:
        nll = nll + z_loss * lse.square().mean()
    return nll


def _vocab_sharded(logits: torch.Tensor) -> bool:
    return is_dtensor(logits) and any(
        getattr(p, "dim", None) in (-1, logits.dim() - 1)
        and logits.device_mesh.size(i) > 1
        for i, p in enumerate(logits.placements))


class _VocabParallelCE(torch.autograd.Function):
    """(logsumexp, label logit) of a DTensor x [B, S, V] whose vocab dim
    is sharded, vocab-parallel, as GSPMD partitions the reference's.  The
    logsumexp: each rank's row max and sum of ``exp(x - max)`` over its
    columns, reduced over the vocab's mesh dims ([B, S] values), where
    DTensor's own logsumexp would first gather every rank's whole
    [B, S, V] row block (40 GB a device for qwen2-0.5b's ``train_4k``
    cell on 256 devices), and its backward would gather them again.  The
    label's logit: `_label_logits`.  The gradient is formed on each
    rank's columns in one [B, S, V / tp] float32 buffer, in place:
    ``exp(x - lse) g_lse``, plus ``g_ll`` at each label's column -- the
    same operations in the same order as autograd's two branches and
    their sum, which held four such buffers at once (F9: 4 x 9.27 GiB in
    qwen3-4b's ``train_4k`` step on (2, 2), which did not fit)."""

    @staticmethod
    def forward(ctx, x, targets):
        m = x.amax(dim=-1, keepdim=True)
        lse = (x - m).exp_().sum(dim=-1).log() + m.squeeze(-1)
        ll = _label_logits(x, targets)
        ll = ll.redistribute(ll.device_mesh, lse.placements)
        ctx.save_for_backward(x, lse, targets)
        return lse, ll

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        from ..parallel.compat import local_map

        x, lse, targets = ctx.saved_tensors
        g = (x - lse.unsqueeze(-1)).exp_().mul_(g_lse.unsqueeze(-1))
        rows, start = _label_layout(g, targets)

        def add_at(gl, gr, tg, cols):
            idx = tg - cols[0]
            hit = (idx >= 0) & (idx < gl.shape[-1])
            return gl.scatter_add_(
                -1, idx.clamp(0, gl.shape[-1] - 1)[..., None],
                torch.where(hit, gr, torch.zeros_like(gr))[..., None])

        g = local_map(add_at, out_placements=list(g.placements),
                      in_placements=(g.placements, rows, rows,
                                     start.placements),
                      device_mesh=g.device_mesh, redistribute_inputs=True)(
            g, g_ll, replicate_like(targets, g), start)
        return g, None


def _label_layout(logits, targets):
    """(the placements of a label pick's rows: the logits' but for the
    vocab's mesh dims, replicated there; each rank's first vocab column as
    a DTensor laid out as the logits' vocab dim)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, v = logits.device_mesh, logits.shape[-1]
    vocab = [isinstance(p, Shard) and p.dim % logits.dim() == logits.dim() - 1
             for p in logits.placements]
    start = DTensor.from_local(torch.arange(v, device=targets.device), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    start = start.redistribute(mesh, [Shard(0) if s else Replicate()
                                      for s in vocab])
    rows = [Replicate() if s else p for s, p in zip(vocab, logits.placements)]
    return rows, start


def _label_logits(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]``.  For a DTensor (the global targets, the
    same on every rank) under ``local_map``: each rank gathers the labels
    that fall in its vocab columns (0 elsewhere) and the picks are summed
    over the mesh dims that shard the vocab -- one nonzero term, so the
    gather's value."""
    if not is_dtensor(logits):
        return logits.gather(-1, targets[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Shard
    from ..parallel.compat import local_map

    rows, start = _label_layout(logits, targets)

    def pick(lg, tg, cols):
        idx = tg - cols[0]
        hit = (idx >= 0) & (idx < lg.shape[-1])
        got = lg.gather(-1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(hit, got, torch.zeros_like(got))

    vocab = [isinstance(p, Shard) and p.dim % logits.dim() == logits.dim() - 1
             for p in logits.placements]
    return local_map(pick, out_placements=[Partial() if s else p for s, p
                                           in zip(vocab, rows)],
                     in_placements=(logits.placements, rows, start.placements),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(
        logits, replicate_like(targets, logits), start)


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
