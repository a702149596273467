"""Mamba's softplus and the selective scan's per-chunk checkpoint (faults
F4 and F7).

F4: `mamba.softplus` is ``F.softplus`` without a mesh and the same op
under ``local_map`` on one (DTensor shards softplus's forward by its
decomposition but has no strategy for its backward, which then gathered
the whole [B, S, E] activation on every rank: tests/
test_torch_mesh_memory.py).  Held here against ``jax.nn.softplus`` and
its gradient within the train tolerances (1e-5 / 2e-5 relative), large
inputs included (no overflow: x up to 1e30 and down to -1e30 stay
finite).

F7: where autograd records, `selective_scan` runs each chunk under a
non-reentrant checkpoint, as the reference's ``jax.checkpoint
(chunk_step)``.  Held: a falcon-mamba train step (scaled down, S = 512:
two chunks of 256) gives the loss and gradients of the same step without
the chunk checkpoints, bit for bit; a scan under grad keeps less for the
backward than one chunk's discretized [B, cs, E, N] float32 tensor
(saved-tensor hooks, by storage; without the checkpoint it keeps several
a chunk); a prefill (``inference_mode``) takes no checkpoint and keeps
its bits (against the scan with each chunk's steps inline, as it was
written before the checkpoint).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from _torch_train import FAMILIES, data_config  # noqa: E402

X = np.concatenate([np.linspace(-30.0, 30.0, 601), [-1e30, -1e4, -88.0, -20.0,
                    -1e-7, 0.0, 1e-7, 19.99, 20.0, 20.01, 88.0, 89.0, 1e4,
                    1e30]]).astype(np.float32)


def test_softplus_matches_jax():
    import jax
    import jax.numpy as jnp

    from repro_torch.models.mamba import softplus

    want = np.asarray(jax.nn.softplus(jnp.asarray(X)))
    want_grad = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(
        jnp.asarray(X)))
    x = torch.from_numpy(X).requires_grad_(True)
    y = softplus(x)
    (grad,) = torch.autograd.grad(y.sum(), x)
    got, got_grad = y.detach().numpy(), grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(got_grad).all()
    # XLA flushes float32 subnormals to 0 (softplus(-88) = 6.05e-39 here)
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tiny)
    np.testing.assert_allclose(got_grad, want_grad, rtol=2e-5, atol=tiny)
    assert got[X == 1e30][0] == np.float32(1e30)
    assert got[X == -1e30][0] == 0.0


def _scan_inputs(seed=0, b=1, s=512, e=64, n=8):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal((b, s, e)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(
        g.standard_normal((b, s, e)))).astype(np.float32))
    a = -torch.from_numpy(np.exp(0.1 * g.standard_normal((e, n)))
                          .astype(np.float32))
    bm = torch.from_numpy(g.standard_normal((b, s, n)).astype(np.float32))
    cm = torch.from_numpy(g.standard_normal((b, s, n)).astype(np.float32))
    d = torch.ones(e)
    return [t.requires_grad_(True) for t in (x, dt, a, bm, cm)] + [d]


def _saved_bytes(fn):
    """Bytes autograd keeps for the backward of `fn()` (distinct storages
    of the tensors packed by saved-tensor hooks)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def _no_chunk_checkpoint(monkeypatch):
    from repro_torch.models import mamba

    monkeypatch.setattr(mamba, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))


def test_scan_keeps_no_chunk_transients(monkeypatch):
    from repro_torch.models.mamba import selective_scan

    x, dt, a, bm, cm, d = _scan_inputs()
    (y, h), kept = _saved_bytes(lambda: selective_scan(x, dt, a, bm, cm, d))
    one_chunk = 1 * 256 * 64 * 8 * 4  # [B, cs, E, N] float32
    assert kept < one_chunk
    grads = torch.autograd.grad((y.sum(), h.sum()), (x, dt, a, bm, cm))

    _no_chunk_checkpoint(monkeypatch)
    (y0, h0), kept0 = _saved_bytes(
        lambda: selective_scan(x, dt, a, bm, cm, d))
    assert kept0 > 4 * one_chunk  # every chunk's transients, without it
    grads0 = torch.autograd.grad((y0.sum(), h0.sum()), (x, dt, a, bm, cm))
    assert torch.equal(y, y0) and torch.equal(h, h0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g.view(torch.int32), g0.view(torch.int32))


def test_train_step_equals_the_step_without_chunk_checkpoints(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items
    from repro_torch.train import DataConfig, SyntheticPipeline
    from repro_torch.train.train_step import value_and_grad

    from repro_torch.models import mamba

    arch, over = FAMILIES["ssm"]
    cfg = get_config(arch).scaled_down(dtype="float32", **over)
    batch = SyntheticPipeline(DataConfig(**data_config(cfg, batch=1,
                                                       seq=512)),
                              device="cpu").batch_at(0)
    model = build_model(cfg, device="cpu", seed=0, remat="full")
    calls = []
    real = mamba.checkpoint
    monkeypatch.setattr(mamba, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, grads = value_and_grad(model, model.params.tree(), batch)
    assert calls  # the chunks ran under their checkpoints
    _no_chunk_checkpoint(monkeypatch)
    loss0, grads0 = value_and_grad(model, model.params.tree(), batch)
    assert torch.equal(loss, loss0)
    for (path, g), (_, g0) in zip(tree_items(grads), tree_items(grads0)):
        assert torch.equal(g.view(torch.int32), g0.view(torch.int32)), path


def _inline_scan(x, dt, a, b, c, d, h0=None, chunk=256):
    """`selective_scan` with each chunk's steps inline in the loop, as it
    was written before the chunk checkpoint (the prefill's path: no
    autograd)."""
    from repro_torch.models.griffin import lru_scan

    bsz, s, e = x.shape
    nchunks = max(1, s // chunk)
    cs = s // nchunks
    h = torch.zeros((bsz, e, a.shape[1])) if h0 is None else h0
    af = a.float()
    ys = []
    for i in range(nchunks):
        part = slice(i * cs, (i + 1) * cs)
        dtf = dt[:, part].float()
        da = torch.exp(dtf[..., None] * af)
        dbx = (dtf * x[:, part].float())[..., None] \
            * b[:, part, None, :].float()
        dbx[:, 0].addcmul_(da[:, 0], h)
        hs = lru_scan(da, dbx)
        ys.append(torch.einsum("bsen,bsn->bse", hs, c[:, part].float()))
        h = hs[:, -1].clone()
    y = torch.cat(ys, dim=1) + x.float() * d.float()
    return y.to(x.dtype), h


def test_prefill_keeps_its_bits(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import mamba

    cfg = get_config("falcon-mamba-7b").scaled_down(dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 512)))

    def refuse(*args, **kwargs):
        raise AssertionError("a prefill took a checkpoint")

    monkeypatch.setattr(mamba, "checkpoint", refuse)
    with torch.inference_mode():
        got = model(tok)
    monkeypatch.setattr(mamba, "selective_scan", _inline_scan)
    with torch.inference_mode():
        want = model(tok)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
