"""Serve is unchanged by the differentiable forward.

Every ``forward`` runs under the caller's grad mode; `griffin.lru_scan`,
`mamba.selective_scan` and `_unembed`'s softcap have an out-of-place form
for when autograd records; the embedding gather is ``F.embedding``; each
layer goes through `_layer_call`.  Here the scans' inference-only form
(`_old_lru_scan`, `_old_selective_scan`: the port's code before it
trained, copied verbatim) is put back in place, and the
Griffin hybrid (recurrentgemma-9b at 5 layers: the RG-LRU scan, the
windowed attention), the SSM (falcon-mamba-7b: the chunked selective
scan, two chunks) and gemma2-9b (the in-place final softcap) run
``forward`` under ``inference_mode`` with them and without them: the
same bits.  The out-of-place forms, taken when a leaf requires grad,
give the same bits as the in-place ones too.
"""
from typing import Optional

import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, griffin, mamba  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.train.losses import named_params  # noqa: E402


def _old_lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a.shape[1]
    off = 1
    while off < s:
        nb = torch.empty_like(b)
        nb[:, :off] = b[:, :off]
        torch.addcmul(b[:, off:], a[:, off:], b[:, :-off], out=nb[:, off:])
        if 2 * off < s:  # the last pass needs no new a
            na = torch.empty_like(a)
            na[:, :off] = a[:, :off]
            torch.mul(a[:, off:], a[:, :-off], out=na[:, off:])
            a = na
        b = nb
        off *= 2
    return b


def _old_selective_scan(x, dt, a, b, c, d, h0: Optional[torch.Tensor] = None,
                        chunk: int = 256):
    bsz, s, e = x.shape
    n = a.shape[1]
    nchunks = max(1, s // chunk)
    if s % nchunks != 0:
        raise ValueError(f"selective_scan: S = {s} does not split into "
                         f"{nchunks} equal chunks (chunk {chunk})")
    cs = s // nchunks
    h = torch.zeros((bsz, e, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    af = a.float()
    ys = []
    for i in range(nchunks):
        part = slice(i * cs, (i + 1) * cs)
        dtf = dt[:, part].float()
        da = torch.exp(dtf[..., None] * af)  # [B, cs, E, N]
        dbx = (dtf * x[:, part].float())[..., None] \
            * b[:, part, None, :].float()
        dbx[:, 0].addcmul_(da[:, 0], h)
        hs = _old_lru_scan(da, dbx)
        del da, dbx
        ys.append(torch.einsum("bsen,bsn->bse", hs, c[:, part].float()))
        h = hs[:, -1].clone()
        del hs
    y = torch.cat(ys, dim=1) + x.float() * d.float()
    return y.to(x.dtype), h


CASES = {"recurrentgemma-9b": {"num_layers": 5},
         "falcon-mamba-7b": {},
         "gemma2-9b": {}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(CASES))
def test_inference_forward_bits_unchanged(arch, dtype, monkeypatch):
    cfg = get_config(arch).scaled_down(dtype=dtype, **CASES[arch])
    model = build_model(cfg, device="cpu", seed=3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 600),
                           generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        now = model.forward(tokens)
    with monkeypatch.context() as m:
        m.setattr(griffin, "lru_scan", _old_lru_scan)
        m.setattr(mamba, "lru_scan", _old_lru_scan)
        m.setattr(mamba, "selective_scan", _old_selective_scan)
        with torch.inference_mode():
            before = model.forward(tokens)
    assert torch.equal(now, before)
    # the train path's forward (grad enabled, leaves requiring grad, remat)
    # computes the same function to the bit
    leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                      model.params.tree())
    graded = torch.func.functional_call(model, named_params(leaves),
                                        (tokens,))
    assert graded.grad_fn is not None
    assert torch.equal(graded.detach(), now)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 300])
def test_lru_scan_grad_form_is_bit_identical(s):
    g = torch.Generator().manual_seed(s)
    a = torch.rand((2, s, 5), generator=g)
    b = torch.randn((2, s, 5), generator=g)
    want = _old_lru_scan(a, b)
    assert torch.equal(griffin.lru_scan(a, b), want)
    ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = griffin.lru_scan(ag, bg)
    assert got.requires_grad and torch.equal(got.detach(), want)
