"""The port's MoE blocks against the JAX package's.

`moe_apply` is held against `repro.models.mlp.moe_apply` (float32, the
reference's single-shard path) on parameters from the reference's own
init and numpy inputs, at 1e-4: the two differ in the order of float32
sums (the router and expert products, the combine's K terms against the
reference's einsum over every expert and slot).  The routing is held as
integers: the experts each (token, k) slot chose, their positions and
which slots were dropped, against a line-for-line JAX copy of the
reference's router (`_jax_route`).  Four cases: the scaled-down config
(capacity factor 8: nothing drops), the drop path (factor 1.0), the pad
mask (6 experts padded to 8), and dropless routing at t = 4.

The index dispatch is held against a literal PyTorch translation of the
reference's one-hot einsums (`_moe_local_onehot`): the dispatched rows bit
for bit, the output within float32 rounding (the combine adds the K terms
in another order).  Then forward and decode of deepseek-moe-16b (dense
layer0 + MoE layers) and qwen2-moe-a2.7b (QKV bias, shared experts) scaled
down against the JAX models, 1e-4, decode against forward at the
reference's 2e-3 (tests/test_models.py::test_decode_matches_forward).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import mlp as r_mlp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from _torch_port import MOE, reference_pair, tokens_for  # noqa: E402

TOL = 1e-4


def _jax_route(router, x2d, cfg, capacity):
    """The reference's router, lines copied from
    src/repro/models/mlp.py::_moe_local (single shard: e_start 0, all
    experts local): (cap, idx, pos, within), each [G, g, K]."""
    t, _ = x2d.shape
    e_total = cfg.experts_padded
    g = t
    for cand in (2048, 1024, 512, 256, 128):
        if cand <= r_mlp._MOE_GROUP and t % cand == 0 and t >= cand:
            g = cand
            break
    ngroups = t // g
    cap = max(1, int(capacity * g / t)) if capacity < t * cfg.top_k \
        else g * cfg.top_k
    xg = x2d.reshape(ngroups, g, -1)
    logits = xg.astype(jnp.float32) @ router.astype(jnp.float32)
    if cfg.num_experts < e_total:
        pad_mask = jnp.arange(e_total) >= cfg.num_experts
        logits = jnp.where(pad_mask[None, None, :], r_mlp.NEG_INF, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    onehot = jax.nn.one_hot(idx, e_total, dtype=jnp.float32)
    flat = onehot.reshape(ngroups, g * cfg.top_k, e_total)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(ngroups, g, cfg.top_k,
                                                    e_total)
    pos = jnp.sum(pos * onehot, axis=-1)
    return cap, np.asarray(idx), np.asarray(pos).astype(np.int64), \
        np.asarray(pos < cap)


def _moe_local_onehot(p, x2d, cfg, capacity):
    """A literal PyTorch translation of the reference's `_moe_local`
    (one-hot dispatch and combine einsums): (dispatched rows [G, E, C, d],
    output [T, d])."""
    dt = x2d.dtype
    t, d = x2d.shape
    r = mlp.moe_route(p["router"], x2d, cfg, capacity)
    ngroups, cap, e_total = t // r.g, r.cap, cfg.experts_padded
    xg = x2d.reshape(ngroups, r.g, d)
    onehot = F.one_hot(r.idx, e_total).float()
    disp = torch.zeros(ngroups, r.g, e_total, cap)
    comb = torch.zeros(ngroups, r.g, e_total, cap)
    for k in range(cfg.top_k):
        d_k = (onehot[:, :, k, :, None]
               * F.one_hot(r.pos[:, :, k].clamp(max=cap - 1), cap).float()
               [:, :, None, :])
        d_k = d_k * r.within[:, :, k, None, None]
        disp = disp + d_k
        comb = comb + d_k * r.gate[:, :, k, None, None]
    xe = torch.einsum("gtec,gtd->gecd", disp.to(dt), xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wg"].to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["wu"].to(dt))
    ye = torch.einsum("gecf,efd->gecd", h, p["wd"].to(dt))
    out = torch.einsum("gtec,gecd->gtd", comb.to(dt), ye)
    return xe, out.reshape(t, d)


def _params(cfg, seed=0):
    """The reference's init of `moe_defs` (router normal 0.02, experts
    fan-in), float32 numpy."""
    rdefs = r_mlp.moe_defs(cfg)
    rp = r_common.init_params(rdefs, jax.random.PRNGKey(seed), jnp.float32)
    return jax.tree.map(np.asarray, rp)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


CASES = {
    "scaled_down": ({}, 2, 64, False),
    "drops": ({"moe_capacity_factor": 1.0}, 2, 192, False),
    "pad_mask": ({"num_experts": 6, "num_experts_padded": 8}, 2, 64, False),
    "dropless_t4": ({"moe_capacity_factor": 1.0}, 4, 1, True),
}


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(name, case):
    over, b, s, dropless = CASES[case]
    cfg = get_config(name).scaled_down(dtype="float32", **over)
    rcfg = r_get_config(name).scaled_down(dtype="float32", **over)
    assert cfg.__dict__ == rcfg.__dict__
    p = _params(rcfg)
    x = np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    want = np.asarray(r_mlp.moe_apply(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), rcfg,
                                      dropless=dropless))
    tp, tx = _torch_tree(p), torch.from_numpy(x)
    got = mlp.moe_apply(tp, tx, cfg, dropless=dropless).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    # the routing, as integers
    t = b * s
    capacity = t * cfg.top_k if dropless else max(1, int(
        cfg.moe_capacity_factor * t * cfg.top_k / cfg.experts_padded))
    cap, idx, pos, within = _jax_route(jnp.asarray(p["router"]),
                                       jnp.asarray(x.reshape(t, -1)), rcfg,
                                       capacity)
    r = mlp.moe_route(tp["router"], tx.reshape(t, -1), cfg, capacity)
    assert r.cap == cap
    assert np.array_equal(r.idx.numpy(), idx)
    assert np.array_equal(r.pos.numpy(), pos)
    assert np.array_equal(r.within.numpy(), within)
    kept = int(within.sum())
    if case == "drops":  # the path this case exists for
        assert 0 < kept < within.size
    else:
        assert kept == within.size
    if case == "pad_mask":
        assert idx.max() < cfg.num_experts < cfg.experts_padded
    if case == "dropless_t4":
        assert (r.g, r.cap) == (4, 4 * cfg.top_k)


@pytest.mark.parametrize("t", [4, 100, 128, 384, 4096])
def test_groups_and_capacity_match_reference(t):
    """Group size and per-group capacity for one group of t, several
    groups (384 = 3 x 128, 4096 = 2 x 2048) and t no candidate divides."""
    cfg = get_config("deepseek-moe-16b").scaled_down(
        dtype="float32", moe_capacity_factor=1.25)
    p = _torch_tree(_params(cfg))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (t, cfg.d_model)).astype(np.float32))
    for dropless in (False, True):
        capacity = t * cfg.top_k if dropless else max(1, int(
            cfg.moe_capacity_factor * t * cfg.top_k / cfg.experts_padded))
        cap, idx, pos, within = _jax_route(
            jnp.asarray(p["router"].numpy()), jnp.asarray(x.numpy()), cfg,
            capacity)
        r = mlp.moe_route(p["router"], x, cfg, capacity)
        assert (r.g, r.cap) == (idx.shape[1], cap)
        assert np.array_equal(r.idx.numpy(), idx)
        assert np.array_equal(r.within.numpy(), within)


@pytest.mark.parametrize("over", [{}, {"moe_capacity_factor": 1.0},
                                  {"num_experts": 6, "num_experts_padded": 8}])
def test_index_dispatch_matches_onehot_translation(over):
    """Dispatched rows bit for bit (the one-hot product with 0/1 entries is
    exact; empty slots are zero rows in both); the outputs within float32
    rounding of each other."""
    cfg = get_config("qwen2-moe-a2.7b").scaled_down(dtype="float32", **over)
    p = _torch_tree(_params(cfg, seed=3))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (384, cfg.d_model)).astype(np.float32))
    capacity = max(1, int(cfg.moe_capacity_factor * 384 * cfg.top_k
                          / cfg.experts_padded))
    xe_ref, out_ref = _moe_local_onehot(p, x, cfg, capacity)
    r = mlp.moe_route(p["router"], x, cfg, capacity)
    xe, row = mlp.moe_dispatch(x, r, cfg)
    ngroups = 384 // r.g
    want = xe_ref.permute(1, 0, 2, 3).reshape(xe.shape)  # expert-major
    assert torch.equal(xe, want)
    assert int((row < xe.shape[0] * xe.shape[1]).sum()) == int(r.within.sum())
    assert ngroups == 3
    out = mlp._moe_local(p, x, cfg, 0, cfg.experts_padded, capacity)
    np.testing.assert_allclose(out.numpy(), out_ref.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", MOE)
def test_forward_matches_reference(name):
    rmodel, rparams, port = reference_pair(name)
    toks = tokens_for(port.cfg, 2, 64)
    want = np.asarray(rmodel.forward(rparams, jnp.asarray(toks)))
    got = port.forward(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", MOE)
def test_decode_matches_reference_and_forward(name):
    """Decode routes dropless (the serving path); the scaled-down
    capacity factor 8 makes the forward drop nothing either, so the two
    are comparable."""
    rmodel, rparams, port = reference_pair(name)
    b, s = 2, 12
    toks = tokens_for(port.cfg, b, s, seed=3)
    rstep = jax.jit(rmodel.decode_step)
    rcache = rmodel.init_cache(b, s)
    cache = port.init_cache(b, s)
    assert ("layer0" in cache) == bool(port.cfg.first_dense_d_ff)
    t = torch.from_numpy(toks).long()
    want, got = [], []
    for pos in range(s):
        lg, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, pos:pos + 1]),
                           jnp.int32(pos))
        want.append(np.asarray(lg)[:, 0])
        lg, cache = port.decode_step(cache, t[:, pos:pos + 1], pos)
        got.append(lg[:, 0].numpy())
    want, got = np.stack(want, 1), np.stack(got, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, port.forward(t).numpy(), rtol=2e-3,
                               atol=2e-3)
    if "layer0" in cache:  # layer0's global cache was written
        assert (cache["layer0"]["slot_pos"] == torch.arange(s)).all()


def test_build_model_moe_on_cpu():
    """`build_model` draws every table entry (the router from the "normal"
    init at std 0.02, truncated at 2 std) and the model runs."""
    cfg = get_config("deepseek-moe-16b").scaled_down(dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    p = model.params.tree()
    router = p["layers"]["ffn"]["router"]
    assert router.abs().max().item() <= 0.04 * (1 + 1e-6)
    assert router.std().item() == pytest.approx(0.88 * 0.02, rel=0.05)
    assert "layer0" in p and "router" not in p["layer0"]["ffn"]
    logits = model.forward(torch.from_numpy(tokens_for(cfg, 1, 16)).long())
    assert logits.shape == (1, 16, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE)
def test_forward_and_decode_on_card_match_cpu(name):
    """The scaled-down MoE model on the card (float32, TF32 off; attention
    on the CUDA-core kernel, one launch a layer) against the same model on
    the CPU, and its decode against its forward, at 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, port = reference_pair(name)
    cfg = port.cfg
    card = type(port)(cfg, tree_map(lambda a: a.detach().cuda(),
                                    port.params.tree()))
    toks = torch.from_numpy(tokens_for(cfg, 2, 12, seed=3)).long()
    before = ops.LAUNCHES_BY_KERNEL["simt"]
    full = card.forward(toks.cuda())
    assert ops.LAUNCHES_BY_KERNEL["simt"] == before + cfg.num_layers
    np.testing.assert_allclose(full.cpu().numpy(), port.forward(toks).numpy(),
                               rtol=2e-3, atol=2e-3)
    cache = card.init_cache(2, 12)
    for pos in range(12):
        lg, cache = card.decode_step(cache, toks[:, pos:pos + 1].cuda(), pos)
        np.testing.assert_allclose(lg[:, 0].cpu().numpy(),
                                   full[:, pos].cpu().numpy(), rtol=2e-3,
                                   atol=2e-3)
