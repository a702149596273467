"""The port's train-step gradients against JAX autodiff, dense and MoE.

`model_loss` and its gradient (`train.train_step.value_and_grad`, remat
"full") on qwen2-0.5b, gemma2-9b (the attention and final softcaps, the
sliding window), qwen2-moe-a2.7b and deepseek-moe-16b (its dense layer0),
each scaled down in float32, against ``jax.value_and_grad`` of the
reference's ``train.losses.model_loss`` from the same parameters and
tokens: the loss within 1e-5 relative, every gradient leaf within 2e-5 of
its largest magnitude (the two sum in other orders; the largest
difference seen is 2.1e-6 of it).  tests/test_torch_train_grads_recurrent.py
holds the other three families.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)
from _torch_train import grads_match_reference  # noqa: E402


@pytest.mark.parametrize("family", ["dense", "dense_softcap_window", "moe",
                                    "moe_layer0"])
def test_loss_and_grads_match_jax(family):
    grads_match_reference(family)
