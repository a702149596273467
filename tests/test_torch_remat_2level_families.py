"""Under ``remat="2level"`` the families whose reference checks for
``remat == "full"`` alone (Mamba, Griffin, Whisper: ``src/repro/models/
mamba.py``, ``griffin.py``, ``whisper.py``) run no layer checkpoint in
the port either: the same checkpoint calls as "none" (Mamba's per-chunk
ones, which the reference's ``selective_scan`` takes whatever the remat),
fewer than "full", and the loss and gradients bit for bit "full"'s.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from _torch_train import FAMILIES, Checkpoints, data_config  # noqa: E402


@pytest.mark.parametrize("family", ["hybrid", "ssm", "encdec"])
def test_other_families_run_no_checkpoint(family, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items
    from repro_torch.train import DataConfig, SyntheticPipeline
    from repro_torch.train.train_step import value_and_grad

    arch, over = FAMILIES[family]
    cfg = get_config(arch).scaled_down(dtype="float32", **over)
    batch = SyntheticPipeline(DataConfig(**data_config(cfg, seq=32)),
                              device="cpu").batch_at(0)
    if "frames" in batch:
        batch["frames"] = batch["frames"].float()
    count = Checkpoints(monkeypatch)
    calls, out = {}, {}
    for remat in ("none", "full", "2level"):
        model = build_model(cfg, device="cpu", seed=2, remat=remat)
        count.calls = []
        out[remat] = value_and_grad(model, model.params.tree(), batch)
        calls[remat] = list(count.calls)
    assert calls["2level"] == calls["none"]
    assert len(calls["full"]) > len(calls["none"])
    assert torch.equal(out["2level"][0], out["full"][0])
    for (path, a), (_, b) in zip(tree_items(out["full"][1]),
                                 tree_items(out["2level"][1])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path
