"""Shared helpers of the tests that hold the port's training substrate
(`repro_torch.train`) against the JAX package's (`repro.train`)."""
import numpy as np
import pytest

# (arch, scaled_down overrides): one config per model family -- dense
# (qwen2-0.5b; gemma2-9b for the softcaps and the window), MoE, the Griffin
# hybrid (5 layers: one (rec, rec, attn) group and 2 tail layers), the
# SSM and the encoder-decoder
FAMILIES = {
    "dense": ("qwen2-0.5b", {}),
    "dense_softcap_window": ("gemma2-9b", {}),
    "moe": ("qwen2-moe-a2.7b", {}),
    "moe_layer0": ("deepseek-moe-16b", {}),
    "hybrid": ("recurrentgemma-9b", {"num_layers": 5}),
    "ssm": ("falcon-mamba-7b", {}),
    "encdec": ("whisper-base", {}),
}
LOSS_REL = 1e-5  # the loss, relative
GRAD_REL = 2e-5  # each gradient leaf, of its largest magnitude


class Checkpoints:
    """Wraps the models' ``torch.utils.checkpoint`` calls (`common`'s and
    `mamba`'s) under `monkeypatch`: ``calls`` lists each call's nesting
    depth (0: not inside another checkpointed function)."""

    def __init__(self, monkeypatch):
        from repro_torch.models import common, mamba

        self.depth, self.calls = 0, []
        real = common.checkpoint

        def counted(fn, *args, **kwargs):
            self.calls.append(self.depth)

            def inner(*a, **k):
                self.depth += 1
                try:
                    return fn(*a, **k)
                finally:
                    self.depth -= 1
            return real(inner, *args, **kwargs)

        monkeypatch.setattr(common, "checkpoint", counted)
        monkeypatch.setattr(mamba, "checkpoint", counted)


def data_config(cfg, batch=2, seq=32, kind="random"):
    """Keyword arguments of both packages' DataConfig for `cfg`."""
    return dict(global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size,
                kind=kind, frames=cfg.encoder_frames, d_model=cfg.d_model)


def grads_match_reference(family, remat="full", ref_remat="none",
                          overrides=None):
    """`model_loss`'s loss and every gradient leaf of the port (`remat`,
    default "full") against ``jax.value_and_grad`` of the reference's
    (`ref_remat`, default "none", plain attention: the reference's train
    path), from the JAX model's own float32 parameters, on both packages'
    batch 0 of "random" data (the same tokens); `overrides` replace the
    family's `scaled_down` ones.  Whisper's frames are the pipeline's bf16
    frames widened to float32 (exactly), so both models run in float32
    throughout: with bf16 frames both encoders compute in bf16, where XLA
    and PyTorch round an ulp apart.  Returns the port's (loss, grads,
    model, batch)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as r_get_config
    from repro.models import build_model as r_build_model
    from repro.train.data import DataConfig as RDataConfig
    from repro.train.data import SyntheticPipeline as RPipeline
    from repro.train.losses import model_loss as r_model_loss
    from repro_torch.configs import get_config
    from repro_torch.models.api import model_parts
    from repro_torch.models.common import tree_items
    from repro_torch.models.convert import params_from_reference
    from repro_torch.train import DataConfig, SyntheticPipeline
    from repro_torch.train.train_step import value_and_grad

    arch, over = FAMILIES[family]
    over = dict(over, **(overrides or {}))
    rcfg = r_get_config(arch).scaled_down(dtype="float32", **over)
    rmodel = r_build_model(rcfg, use_pallas=False, remat=ref_remat)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    rbatch = RPipeline(RDataConfig(**data_config(rcfg))).batch_at(0)
    if "frames" in rbatch:
        rbatch = dict(rbatch, frames=rbatch["frames"].astype(jnp.float32))
    want_loss, want = jax.value_and_grad(
        lambda p: r_model_loss(rmodel, p, rbatch))(rparams)

    cfg = get_config(arch).scaled_down(dtype="float32", **over)
    port = model_parts(cfg)[1](cfg, params_from_reference(
        jax.tree.map(np.asarray, rparams), device="cpu"), remat=remat)
    batch = SyntheticPipeline(DataConfig(**data_config(cfg)),
                              device="cpu").batch_at(0)
    if "frames" in batch:
        batch["frames"] = batch["frames"].float()
    loss, grads = value_and_grad(port, port.params.tree(), batch)

    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_REL)
    want = jax.tree.map(np.asarray, want)
    for path, g in tree_items(grads):
        w = want
        for key in path:
            w = w[key]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (path, err)
    return loss, grads, port, batch
