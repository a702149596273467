"""The port's train-step gradients against JAX autodiff: the Griffin
hybrid (recurrentgemma-9b at 5 layers: the RG-LRU scan's out-of-place
form, the windowed MQA layer), the SSM (falcon-mamba-7b: the selective
scan's) and the encoder-decoder (whisper-base with frames: the
non-causal encoder, the cross-attention), scaled down in float32, at
tests/test_torch_train_grads.py's bars (the largest difference seen is
3.5e-6 of a leaf's largest magnitude).
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)
from _torch_train import grads_match_reference  # noqa: E402


@pytest.mark.parametrize("family", ["hybrid", "ssm", "encdec"])
def test_loss_and_grads_match_jax(family):
    grads_match_reference(family)
