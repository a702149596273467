"""Stacked-layer gradients written once (fault F6).

Every family keeps its layers' parameters stacked over a leading layers
dim, the reference's scan layout.  The models take each stacked leaf
apart once a call (`common.unstack`, one ``unbind``), so the backward
writes each stacked gradient with one ``stack``; a ``t[i]`` view a layer
makes autograd write a zero-filled copy of the whole stack a layer
(``select_backward``) and add them up.  Held for the dense, MoE (with
``layer0``), Griffin (``rec``, ``att`` and ``tail`` stacks), Mamba and
Whisper (encoder and decoder stacks) models, scaled down in float32:

  * the gradients equal, bit for bit, those of the same forward with the
    ``t[i]`` views put back (a ``t[i]`` `unstack` written here), but for
    the sign of a zero: adding the other layers' zero slots turns a
    layer's -0.0 into +0.0, which one ``stack`` keeps, as the reference's
    scan does;
  * no op of the train step's backward writes a whole layer stack but one
    ``stack`` a stacked leaf (a dispatch mode counting outputs of a
    stacked leaf's shape), where the ``t[i]`` views write one
    ``select_backward`` a layer and leaf;
  * `unstack` keeps a -0.0 gradient where the ``t[i]`` views lose it.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from _torch_train import FAMILIES, data_config  # noqa: E402

CASES = {"dense": {"num_layers": 3}, "moe_layer0": {"num_layers": 4},
         "hybrid": {}, "ssm": {"num_layers": 3}, "encdec": {}}


def _views(tree):
    """The per-layer trees of `tree` as ``t[i]`` views."""
    from repro_torch.models.common import tree_leaves, tree_map

    n = next(tree_leaves(tree)).shape[0]
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]


def _patch_views(monkeypatch):
    from repro_torch.models import griffin, mamba, transformer, whisper

    for mod in (transformer, mamba, griffin, whisper):
        monkeypatch.setattr(mod, "unstack", _views)


def _step(family, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import DataConfig, SyntheticPipeline
    from repro_torch.train.train_step import value_and_grad

    arch, over = FAMILIES[family]
    cfg = get_config(arch).scaled_down(dtype="float32",
                                       **dict(over, **CASES[family]))
    batch = SyntheticPipeline(DataConfig(**data_config(cfg)),
                              device="cpu").batch_at(seed)
    if "frames" in batch:
        batch["frames"] = batch["frames"].float()
    model = build_model(cfg, device="cpu", seed=seed, remat="full")
    return model, batch, value_and_grad


STACKS = ("layers", "rec", "att", "tail", "encoder", "decoder")


def _whole_stack_writes(model, batch, value_and_grad):
    """({op: count} of the step's select_backward and stack ops whose
    output has a stacked leaf's shape, the number of stacked leaves)."""
    from repro_torch.models.common import tree_items
    from repro_torch.parallel.compat import TorchDispatchMode

    stacked = [leaf for path, leaf in tree_items(model.params.tree())
               if path[0] in STACKS]
    shapes = {tuple(leaf.shape) for leaf in stacked}
    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("select_backward", "stack") \
                    and isinstance(out, torch.Tensor) \
                    and tuple(out.shape) in shapes:
                counts[name] = counts.get(name, 0) + 1
            return out

    with Count():
        value_and_grad(model, model.params.tree(), batch)
    return counts, len(stacked)


@pytest.mark.parametrize("family", list(CASES))
def test_gradients_bit_for_bit_the_views(family, monkeypatch):
    from repro_torch.models.common import tree_items

    model, batch, value_and_grad = _step(family)
    loss, grads = value_and_grad(model, model.params.tree(), batch)
    _patch_views(monkeypatch)
    loss_v, grads_v = value_and_grad(model, model.params.tree(), batch)
    assert torch.equal(loss, loss_v)
    for (path, a), (_, b) in zip(tree_items(grads), tree_items(grads_v)):
        bits_a, bits_b = a.view(torch.int32), b.view(torch.int32)
        diff = bits_a != bits_b
        # only signed zeros may differ, and only as -0.0 kept here
        assert torch.all(a[diff] == 0) and torch.all(b[diff] == 0), path
        assert torch.all(torch.signbit(a[diff])), path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("family", list(CASES))
def test_one_stack_a_leaf(family, monkeypatch):
    model, batch, value_and_grad = _step(family, seed=1)
    counts, leaves = _whole_stack_writes(model, batch, value_and_grad)
    assert counts.get("select_backward", 0) == 0, counts
    assert counts.get("stack", 0) == leaves > 0, counts
    # the t[i] views: a zero-filled stack a layer and leaf (the counter
    # sees them)
    _patch_views(monkeypatch)
    counts, _ = _whole_stack_writes(model, batch, value_and_grad)
    assert counts.get("select_backward", 0) > leaves, counts


def test_unstack_keeps_a_negative_zero():
    from repro_torch.models.common import unstack

    base = torch.ones((3, 4), requires_grad=True)
    coef = torch.tensor([[1.0, -0.0, 2.0, -0.0], [0.5, 3.0, -0.0, 1.0],
                         [-0.0, -0.0, 4.0, 1.0]])

    def grad_of(parts):
        base.grad = None
        sum((p["w"] * c).sum() for p, c in zip(parts, coef)).backward()
        return base.grad.clone()

    kept = grad_of(unstack({"w": base}))
    assert torch.equal(kept.view(torch.int32), coef.view(torch.int32))
    lost = grad_of(_views({"w": base}))  # -0.0 + 0.0 = +0.0
    assert torch.equal(lost, coef)
    assert not torch.signbit(lost[coef == 0]).any()
