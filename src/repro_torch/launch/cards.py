"""The sharded path with one rank a card: the rank functions of the
four-card run.

`launch.ranks.run_ranks(rank_cards, world, tmp, device, parts)` runs
`rank_cards` on every rank of a ("data", "model") world: 4 ranks make a
(2, 2) mesh, 2 a (1, 2), 1 a (1, 1) (`MESH_SHAPES`).  Each entry of
`parts` is one check of the sharded path, run in the order given, every
rank taking part; the meshless run it is held against runs on rank 0
(card 0 under NCCL), which compares.  `CARD_PARTS` are the sizes the
card takes (full published widths, cut depth; qwen3-4b `train_4k` at
full depth); the CPU tests pass small ones with ``device="cpu"`` on gloo
ranks.

  train_check  qwen3-4b float32, one sharded step per variant (rules,
               sequence parallelism, microbatches) from one state,
               against the meshless step: the loss, every gradient leaf
               and every updated parameter (`TRAIN_BARS`)
  decode       greedy decode of each arch on the mesh and without one
               (every rank runs both): the tokens equal, the logits
               within `DECODE_TOL`
  moe_ep       deepseek-moe-16b float32 at cut depth: the prefill
               through expert parallelism on a (1, world) mesh against
               the meshless prefill of the same parameters on rank 0,
               each MoE layer's routing compared (`_moe_ep`: the tokens
               whose experts differ at a near tie counted, every other
               difference held at `EP_TOL`)
  moe_prefill  the same at full depth in bf16: the greedy next token
               equal, the EP logits' distance from float32 within 1 +
               `EP_BF16_SLACK` times the meshless logits' (`_moe_prefill`;
               the routing flips between the two bf16 runs and the
               distances over the tokens they leave alone recorded)
  elastic_save the state on the world's mesh, `steps` steps, saved
               (`train.checkpoint.save`: each leaf gathered on every
               rank, rank 0 writes), then one more step on the live
               state; `rank_elastic_restore` takes the checkpoint onto a
               new world's mesh and onto no mesh
  train_4k     qwen3-4b `train_4k` planned by `launch.cells.plan_cell`
               on the live mesh at the card's memory, `microbatches` of
               the plan's microbatch size (None: the plan's count, the
               whole step; `train_4k_summary` reads the ranks' records
               and holds them): one step under
               `launch.cost`'s trace (per-device FLOPs and collective
               bytes, the activation's all-reduces a layer and
               microbatch against `TRAIN_4K_ALL_REDUCES`; it warms up),
               one timed and counted (wall, peak
               memory, flash launches), one under ``torch.profiler``
               (device busy and idle share, the NCCL kernels), then each
               collective kind's bus rate at the step's sizes and the
               step's roofline bound at that link rate
  flash        both sm90 flash kernels timed on this rank's card at the
               train_4k layer's local shape
  gpipe        `parallel.pipeline.gpipe` of tanh(x @ w_i), one stage a
               rank, against the stack run in order on rank 0

Every part that draws parameters or inputs does so on each rank's own
device from the same seed (the global value, the same on every rank,
which `parallel.sharding.constrain` cuts without communication), and
holds the ranks' draws bit for bit equal (`draws_equal`) before any rank
keeps its shard.  Each part records, on every rank, the flash-attention
launches it made and the devices they ran on.  After each part a rank
writes what it has to ``tmp/rank<r>.parts.json``, so a world that fails
later still leaves the parts before it.  A part that raises is
recorded with its traceback and the next part runs (every rank of an
SPMD part raises alike); the rank then raises, naming every failed part,
so the world fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

__all__ = ["MESH_SHAPES", "CARD_PARTS", "TRAIN_BARS", "DECODE_TOL",
           "GPIPE_TOL", "ELASTIC_TOL", "EP_TOL", "EP_BF16_SLACK",
           "world_for", "rank_cards", "rank_elastic_restore",
           "draws_equal", "bus_rate", "profile_step", "train_4k_launches",
           "TRAIN_4K_ALL_REDUCES", "activation_collectives",
           "train_4k_summary"]

MESH_SHAPES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}

# tests/test_torch_sharded_train.py's bars: the loss, each gradient leaf
# against its largest magnitude, each updated parameter where its
# gradient is at least `grad_floor` (elsewhere AdamW's first step turns
# the rounding of a gradient near eps into a move up to lr: the step's
# bound)
TRAIN_BARS = {"loss": 1e-5, "grad_of_max": 2e-5, "param": 2e-5,
              "grad_floor": 1e-6}
DECODE_TOL = 1e-5  # tests/test_torch_decode_mesh.py's, float32
GPIPE_TOL = 2e-5  # tests/test_pipeline.py's
ELASTIC_TOL = 1e-4  # tests/test_elastic.py's
# float32 expert parallelism against the meshless run, relative: the
# all-reduce adds the ranks' partial sums in another order than the
# meshless combine (float32 rounding, ~1e-7 a sum)
EP_TOL = 1e-5
# bf16: how much further from the float32 logits the EP logits may lie
# than the meshless ones.  EP rounds each rank's partial expert sum and
# the all-reduce's sums to bf16 where the meshless combine rounds once:
# a few extra roundings a layer beside the ~30 each layer makes, which
# the RMS sum of independent errors puts at a few per cent
EP_BF16_SLACK = 0.1
# the train_4k step's all-reduces of its [B, S, d] activation a layer and
# microbatch: Megatron's layout under remat "full" runs 6 (two a pass
# forward, in the recompute and backward); the reference's compiled step
# 5.06 (tests/test_torch_collectives.py)
TRAIN_4K_ALL_REDUCES = 6.0

CARD_PARTS: Dict[str, Dict[str, Any]] = {
    "train_check": {"arch": "qwen3-4b", "layers": 2, "batch": 4,
                    "seq": 512, "lr": 1e-3,
                    # (name, sp, rule profile, microbatches)
                    "variants": [["tp2d", False, "tp2d", 1],
                                 ["tp2d_sp", True, "tp2d", 1],
                                 ["fsdp", False, "fsdp", 1],
                                 ["tp2d_mb2", False, "tp2d", 2]]},
    "decode": {"archs": ["qwen2-0.5b", "deepseek-moe-16b"], "layers": 2,
               "batch": 4, "max_seq": 64, "steps": 8},
    "moe_ep": {"arch": "deepseek-moe-16b", "layers": 4, "batch": 1,
               "seq": 4096},
    "moe_prefill": {"arch": "deepseek-moe-16b", "batch": 1, "seq": 4096},
    "elastic_save": {"arch": "qwen3-4b", "layers": 2, "batch": 8,
                     "seq": 256, "steps": 2},
    "train_4k": {"arch": "qwen3-4b", "microbatches": 2},
    "flash": {"batch": 8, "heads": 32, "kv_heads": 8, "seq": 4096,
              "head_dim": 128},
    "gpipe": {"d": 4096, "layers_per_stage": 2, "microbatches": 8,
              "mb": 256},
}


def world_for(cards: int) -> int:
    """The world a card count allows: 4, 2 or 1 ranks."""
    return 4 if cards >= 4 else 2 if cards >= 2 else 1


def _device(device: str) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _setup(device: str) -> torch.device:
    """This rank's device; float32 products in full float32 (TF32 off),
    and DTensor's note on reducing a Partial over two mesh dims in two
    collectives silenced (`launch.cost` counts both)."""
    import logging

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    return _device(device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _config(arch: str, layers: Optional[int], dtype: str, scaled: bool):
    from ..configs import get_config

    cfg = get_config(arch)
    kw = {"dtype": dtype} if layers is None \
        else {"dtype": dtype, "num_layers": layers}
    return cfg.scaled_down(**kw) if scaled else cfg.with_(**kw)


def _mesh(world: int, shape=None):
    from .mesh import make_mesh

    return make_mesh(shape or MESH_SHAPES[world], ("data", "model"))


def _leaves(tree) -> List[torch.Tensor]:
    from ..models.common import tree_items

    return [leaf for _, leaf in tree_items(tree)]


def _checksum(t: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """An int64 of `t`'s bits, position-weighted (equal bits, equal sum)."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    bits = t.detach().contiguous().reshape(-1).view(view)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for s in range(0, bits.numel(), chunk):
        part = bits[s:s + chunk].to(torch.int64)
        w = torch.arange(s, s + part.numel(), device=t.device) % 65521 + 1
        total += (part * w).sum()
    return total


def draws_equal(tree) -> bool:
    """Whether every rank holds the same bits in each leaf of `tree`
    (plain tensors): each leaf's checksum gathered from all ranks."""
    sums = torch.stack([_checksum(t) for t in _leaves(tree)])
    got = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(got, sums)
    return all(torch.equal(got[0], g) for g in got)


@contextlib.contextmanager
def _launches(rec: Dict[str, Any]):
    """Fill `rec` with the flash-attention launches made inside (by
    kernel) and the devices their inputs lay on."""
    from ..kernels.flash_attention import ops

    before = dict(ops.LAUNCHES_BY_KERNEL)
    devices: Dict[str, int] = {}

    def seen(route, q, k, causal, window):
        if q.device.type == "cuda":
            devices[str(q.device)] = devices.get(str(q.device), 0) + 1

    ops.OBSERVERS.append(seen)
    try:
        yield rec
    finally:
        ops.OBSERVERS.remove(seen)
        rec["flash_launches"] = {k: ops.LAUNCHES_BY_KERNEL[k] - before[k]
                                 for k in before}
        rec["flash_devices"] = devices


def _full(tree):
    from ..models.common import tree_map
    from ..parallel.sharding import is_dtensor

    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------

def _train_check(rank, world, dev, c):
    from ..models import build_model
    from ..models.api import model_parts
    from ..models.common import tree_items
    from ..parallel.sharding import PROFILES, P
    from ..train import AdamW, make_train_step
    from ..train.data import DataConfig, SyntheticPipeline
    from ..train.elastic import reshard_state
    from ..train.train_step import value_and_grad

    cfg = _config(c["arch"], c["layers"], "float32", c.get("scaled", False))
    mesh = _mesh(world)
    plain = build_model(cfg, device=dev, seed=1, remat="full")
    params = plain.params.tree()
    out = {"mesh": list(MESH_SHAPES[world]), "config": cfg.name,
           "layers": cfg.num_layers, "batch": c["batch"], "seq": c["seq"],
           "draws_equal": draws_equal(params)}
    batch = {k: v.to(dev) for k, v in SyntheticPipeline(DataConfig(
        c["batch"], c["seq"], cfg.vocab_size, "random", seed=1),
        device="cpu").batch_at(0).items()}
    opt = AdamW(learning_rate=c["lr"], weight_decay=0.0)
    ref = {}
    if rank == 0:  # the meshless step, on card 0
        loss_p, grads_p = value_and_grad(plain, params, batch)
        ref["grads"] = dict(tree_items(grads_p))
        for mb in sorted({v[3] for v in c["variants"]}):
            st = {"params": params, "opt": opt.init(params),
                  "step": torch.zeros((), dtype=torch.int32, device=dev)}
            new, m = make_train_step(plain, opt, mb)(st, batch)
            ref[mb] = (float(m["loss"]), dict(tree_items(new["params"])))
    cls = model_parts(cfg)[1]
    rows = {}
    for name, sp, profile, mb in c["variants"]:
        model = cls(cfg, params, remat="full", mesh=mesh, sp=sp,
                    rules=PROFILES[profile])
        pspecs = model.param_pspecs(mesh)
        state = reshard_state(
            {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)},
            {"params": pspecs, "opt": opt.state_pspecs(pspecs),
             "step": P()}, mesh)
        row: Dict[str, Any] = {}
        with _launches(row):
            t = time.perf_counter()
            new, m = make_train_step(model, opt, mb, param_specs=pspecs,
                                     mesh=mesh)(state, batch)
            _sync(dev)
            row["step_wall_s"] = time.perf_counter() - t
        new_p = dict(tree_items(_full(new["params"])))
        grads = dict(tree_items(_full(value_and_grad(
            model, state["params"], batch)[1])))
        row["loss"] = float(m["loss"])
        if rank == 0:
            loss_ref, p_ref = ref[mb]
            worst_g, worst_p, bad = {}, {}, []
            for key, g in ref["grads"].items():
                top = float(g.abs().max())
                worst_g["/".join(key)] = float(
                    (grads[key] - g).abs().max()) / (top or 1.0)
                bar = torch.where(g.abs() >= TRAIN_BARS["grad_floor"],
                                  TRAIN_BARS["param"], c["lr"])
                err = (new_p[key] - p_ref[key]).abs()
                worst_p["/".join(key)] = float(err.max())
                if not bool((err <= bar).all()):
                    bad.append("/".join(key))
            lw = max(worst_g, key=worst_g.get)
            row.update(
                loss_meshless=loss_ref,
                loss_err=abs(row["loss"] - loss_ref),
                worst_grad_leaf=lw, worst_grad_of_max=worst_g[lw],
                worst_param_err=max(worst_p.values()),
                params_past_bar=bad,
                ok=bool(abs(row["loss"] - loss_ref) <= TRAIN_BARS["loss"]
                        and worst_g[lw] <= TRAIN_BARS["grad_of_max"]
                        and not bad))
        rows[name] = row
        del model, state, new, new_p, grads
    out["variants"] = rows
    return out


def _greedy(model, cache, first, steps, mesh):
    tok, logits, toks = first, [], []
    for t in range(steps):
        out, cache = model.decode_step(cache, tok, t)
        if mesh is not None:
            out = out.full_tensor()
        tok = out[:, -1].argmax(-1, keepdim=True).to(first.dtype)
        logits.append(out)
        toks.append(tok)
    return torch.cat(toks, 1), torch.stack(logits)


def _decode(rank, world, dev, c):
    from ..models import build_model
    from ..models.api import model_parts

    mesh = _mesh(world)
    out = {"mesh": list(MESH_SHAPES[world])}
    for i, arch in enumerate(c["archs"]):
        cfg = _config(arch, c["layers"], "float32", c.get("scaled", False))
        plain = build_model(cfg, device=dev, seed=5)
        row = {"draws_equal": draws_equal(plain.params.tree())}
        meshed = model_parts(cfg)[1](cfg, plain.params.tree(), mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(5 + i)
        first = torch.randint(0, cfg.vocab_size, (c["batch"], 1),
                              generator=gen, device=dev)
        with torch.no_grad():
            tok_p, log_p = _greedy(plain, plain.init_cache(
                c["batch"], c["max_seq"]), first, c["steps"], None)
            with _launches(row):
                tok_m, log_m = _greedy(meshed, meshed.init_cache(
                    c["batch"], c["max_seq"]), first, c["steps"], mesh)
        close = torch.isclose(log_m, log_p, rtol=DECODE_TOL,
                              atol=DECODE_TOL)
        row.update(steps=c["steps"], batch=c["batch"],
                   tokens_equal=bool(torch.equal(tok_m, tok_p)),
                   logits_max_abs_err=float((log_m - log_p).abs().max()),
                   logits_within=bool(close.all()),
                   ok=bool(torch.equal(tok_m, tok_p) and close.all()))
        out[arch] = row
        del plain, meshed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _round_to_(tree, dtype: torch.dtype, chunk: int = 1 << 26) -> None:
    """Every leaf of `tree` rounded to `dtype`'s values in place (chunk
    by chunk: no second copy of a leaf)."""
    for t in _leaves(tree):
        flat = t.view(-1)
        for s in range(0, flat.numel(), chunk):
            part = flat[s:s + chunk]
            part.copy_(part.to(dtype))


@contextlib.contextmanager
def _routes(calls: List):
    """Append (x2d, router, route) of each MoE routing made inside to
    `calls`, in call order (`models.mlp.OBSERVERS`)."""
    from ..models import mlp

    def seen(x2d, router, r):
        calls.append((x2d, router, r))

    mlp.OBSERVERS.append(seen)
    try:
        yield calls
    finally:
        mlp.OBSERVERS.remove(seen)


def _route_keys(r) -> torch.Tensor:
    """[T, K]: each token's kept experts, sorted (-1 for a dropped slot)."""
    k = r.idx.shape[-1]
    return torch.where(r.within, r.idx, -1).reshape(-1, k).sort(-1).values


def _flips(ml, ep, cfg) -> Dict[str, Any]:
    """The tokens whose kept experts differ between the meshless routing
    `ml` and the expert parallel one `ep` (each an observed (x2d, router,
    route) of the same layer).  A token's expert set can change only
    where the meshless router probabilities' gap between its k-th and
    k+1-th expert is at most twice the largest difference between the
    two runs' probabilities for it (a near tie); a slot kept in one run
    and dropped at the capacity in the other only after an earlier token
    of its group changed its set.  Any other flip is unexplained."""
    from ..models.mlp import router_probs

    (xm, w, rm), (xe, _, re_) = ml, ep
    k = cfg.top_k
    flip = (_route_keys(rm) != _route_keys(re_)).any(-1)
    changed = (rm.idx.reshape(-1, k).sort(-1).values
               != re_.idx.reshape(-1, k).sort(-1).values).any(-1)
    pm = router_probs(w, xm, cfg)
    gap = pm.topk(k + 1, dim=-1).values
    gap = gap[:, k - 1] - gap[:, k]
    delta = (router_probs(w, xe, cfg) - pm).abs().amax(-1)
    t = torch.arange(flip.numel(), device=flip.device)
    group = t // rm.g
    first = torch.full((flip.numel() // rm.g,), flip.numel(),
                       device=flip.device)
    first.scatter_reduce_(0, group[changed], t[changed], reduce="amin")
    explained = (changed & (gap <= 2 * delta)) \
        | (~changed & (t > first[group]))
    where = flip.nonzero().view(-1)[:16]
    return {"mask": flip, "flips": int(flip.sum()),
            "set_flips": int(changed.sum()),
            "capacity_flips": int((flip & ~changed).sum()),
            "unexplained": int((flip & ~explained).sum()),
            "tokens": where.tolist(), "gap": gap[where].tolist(),
            "delta": delta[where].tolist(),
            "median_gap": float(gap.median())}


def _by_position(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[S]: the relative RMS difference of a and b [B, S, ...] at each
    position."""
    d = (a.float() - b.float()).pow(2).flatten(2).sum((0, 2))
    return (d / b.float().pow(2).flatten(2).sum((0, 2))).sqrt()


def _held(flips, layers: List[int], last: int, b: int, s: int, dev):
    """[B, S]: the tokens no changed expert set can reach.  A token whose
    experts changed in layer `last` (the model's last block) changes only
    its own logits; one changed in an earlier layer reaches every later
    position through the attention of the layers after it."""
    t = torch.arange(b * s, device=dev)
    held = torch.ones(b * s, dtype=torch.bool, device=dev)
    for i, f in zip(layers, flips):
        if not f["flips"]:
            continue
        if i == last:
            held &= ~f["mask"]
        else:
            held &= t % s < int((t % s)[f["mask"]].min())
    return held.view(b, s)


def _ep_models(world, dev, cfg):
    """The meshless model of `cfg` (parameters from seed 0, drawn on this
    rank's device) and the same parameters on a (1, world) mesh."""
    from ..models import build_model
    from ..models.api import model_parts

    plain = build_model(cfg, device=dev, seed=0)
    return plain, model_parts(cfg)[1](cfg, plain.params.tree(),
                                      mesh=_mesh(world, (1, world)))


def _ep_tokens(cfg, c, dev):
    """A warm-up batch and the compared one, [B, S] from `c["seed"]`
    (default 0)."""
    gen = torch.Generator(device=dev).manual_seed(c.get("seed", 0))
    return [torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                          generator=gen, device=dev) for _ in range(2)]


def _moe_layers(p) -> tuple:
    """([i], n): the indices of the blocks of parameter tree `p` that
    route to experts, and the number of blocks."""
    from ..models.common import unstack

    blocks = ([p["layer0"]] if "layer0" in p else []) + unstack(p["layers"])
    return ([i for i, lp in enumerate(blocks) if "router" in lp["ffn"]],
            len(blocks))


def _top2_gap(logits: torch.Tensor) -> List[float]:
    """[B]: each row's largest logit less its second."""
    top = logits.float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def _timed(fn: Callable, dev, out: Dict[str, Any], key: str):
    t = time.perf_counter()
    res = fn()
    _sync(dev)
    out[key] = time.perf_counter() - t
    return res


def _ep_header(world, cfg, c):
    return {"mesh": [1, world], "config": cfg.name,
            "layers": cfg.num_layers, "dtype": cfg.dtype,
            "batch": c["batch"], "seq": c["seq"],
            "experts_local": cfg.experts_padded // world}


def _moe_ep(rank, world, dev, c):
    """The float32 prefill through expert parallelism on a (1, world)
    mesh, every MoE layer's routing observed, against the meshless
    prefill on rank 0 (module docstring): the ranks' EP logits and routes
    bit for bit equal, a second EP run bit for bit the first; the tokens
    whose experts differ (`_flips`) each explained; the logits at the
    tokens no such token can reach (`_held`) within `EP_TOL` (relative
    RMS); and each MoE layer alone (`mlp.moe_apply` with and without
    the mesh on the meshless run's input to it) within `EP_TOL` of the
    meshless layer at every token (relative to the token's output)."""
    from ..models.common import unstack
    from ..models.mlp import moe_apply

    cfg = _config(c["arch"], c.get("layers"), "float32",
                  c.get("scaled", False))
    b, s, d = c["batch"], c["seq"], cfg.d_model
    mesh = _mesh(world, (1, world))
    out = _ep_header(world, cfg, c)
    out["tol"] = EP_TOL
    with torch.inference_mode():
        plain, meshed = _ep_models(world, dev, cfg)
        p = plain.params.tree()
        out["draws_equal"] = draws_equal(p)
        warm, tokens = _ep_tokens(cfg, c, dev)
        meshed.forward(warm)
        _sync(dev)
        dist.barrier()
        ep = []
        with _launches(out), _routes(ep):
            got = _timed(lambda: meshed.forward(tokens), dev, out, "wall_s")
        got = got.full_tensor()
        out["deterministic"] = bool(torch.equal(
            got, meshed.forward(tokens).full_tensor()))
        out["ranks_equal"] = draws_equal(
            {"logits": got,
             "routes": torch.stack([_route_keys(r) for _, _, r in ep])})
        blocks = ([p["layer0"]] if "layer0" in p else []) \
            + unstack(p["layers"])
        moe = [(i, lp["ffn"]) for i, lp in enumerate(blocks)
               if "router" in lp["ffn"]]
        ml = []
        if rank == 0:
            plain.forward(warm)
            with _routes(ml):
                ref = _timed(lambda: plain.forward(tokens), dev, out,
                             "meshless_wall_s")
            flips = [_flips(m, e, cfg) for m, e in zip(ml, ep)]
            held = _held(flips, [i for i, _ in moe], len(blocks) - 1, b, s,
                         dev)
            by_pos = _by_position(got, ref)
            worst = int(by_pos.argmax())
            bins = by_pos.view(16, -1) if s % 16 == 0 else by_pos.view(1, -1)
            tok = ((got - ref).float().norm(dim=-1)
                   / ref.float().norm(dim=-1))[held]
            out["whole"] = {
                "rel_rms": _rel_rms(got, ref),
                "held_tokens": int(held.sum()),
                "rel_rms_held": _rel_rms(got[held], ref[held])
                if held.any() else None,
                "max_token_rel_held": float(tok.max())
                if held.any() else None,
                "rel_rms_by_position_bin": bins.pow(2).mean(-1).sqrt()
                .tolist(),
                "worst_position": worst,
                "worst_position_rel": float(by_pos[worst]),
                "argmax_agree_share": float(
                    (got.argmax(-1) == ref.argmax(-1)).float().mean()),
                "moe_input_rel_rms": [_rel_rms(e[0], m[0])
                                      for m, e in zip(ml, ep)],
                "flips": [dict({k: v for k, v in f.items() if k != "mask"},
                               layer=i) for (i, _), f in zip(moe, flips)]}
            del ref
        del got, meshed
        alone = []
        for j, (i, ffn) in enumerate(moe):
            x = ml[j][0].contiguous() if rank == 0 \
                else torch.empty((b * s, d), device=dev)
            dist.broadcast(x, src=0)
            x = x.view(b, s, d)
            calls = []
            with _routes(calls):
                y = moe_apply(ffn, x, cfg, mesh=mesh).full_tensor()
            row = {"layer": i, "ranks_equal": draws_equal(
                {"y": y, "route": _route_keys(calls[0][2])})}
            if rank == 0:
                mc = []
                with _routes(mc):
                    y0 = moe_apply(ffn, x, cfg)
                f = _flips(mc[0], calls[0], cfg)
                err = ((y - y0).float().norm(dim=-1)
                       / y0.float().norm(dim=-1)).view(-1)
                kept = err[~f["mask"]]
                row.update(flips=f["flips"], unexplained=f["unexplained"],
                           rel_rms=_rel_rms(y, y0),
                           max_token_rel=float(kept.max())
                           if kept.numel() else 0.0)
            alone.append(row)
        del plain, ml, ep
    if rank == 0:
        w = out["whole"]
        out["alone"] = alone
        out["ok"] = bool(
            out["draws_equal"] and out["deterministic"]
            and out["ranks_equal"]
            and not any(f["unexplained"] for f in w["flips"])
            and (w["rel_rms_held"] is None or w["rel_rms_held"] <= EP_TOL)
            and all(r["ranks_equal"] and not r["unexplained"]
                    and r["max_token_rel"] <= EP_TOL for r in alone))
    else:
        out["alone"] = [{"layer": r["layer"], "ranks_equal": r["ranks_equal"]}
                        for r in alone]
    return out


def _moe_prefill(rank, world, dev, c):
    """The bf16 prefill through expert parallelism on a (1, world) mesh
    against the meshless prefill of the same parameters on rank 0: the
    greedy next token equal, and the EP logits no further than
    1 + `EP_BF16_SLACK` times the meshless logits' distance (relative
    RMS) from the float32 prefill of the same parameter values (rounded
    to bf16) on card 0.  The EP logits' own distance from the meshless
    ones is recorded, not held: bf16 rounds the partial sums that the
    all-reduce adds, and 28 layers carry such a difference as far as
    bf16's own error.  Recorded beside them: each MoE layer's tokens
    whose experts differ between the two bf16 runs (`_flips`), the two
    distances over the tokens no such flip reaches (`_held`: the
    ``*_held`` keys, None where none is left) and each run's margin
    between its two largest logits at the last position.  A flip moves
    a token's logits by far more than bf16's rounding, so among a few
    dozen tokens one flip decides the all-token ratio; over the held
    tokens the ratio is the roundings' alone."""
    from ..models import build_model
    from ..models.common import dtype_of

    cfg = _config(c["arch"], c.get("layers"), "bfloat16",
                  c.get("scaled", False))
    b, s = c["batch"], c["seq"]
    out = _ep_header(world, cfg, c)
    with torch.inference_mode():
        plain, meshed = _ep_models(world, dev, cfg)
        out["draws_equal"] = draws_equal(plain.params.tree())
        moe, blocks = _moe_layers(plain.params.tree())
        if rank != 0:
            del plain
        warm, tokens = _ep_tokens(cfg, c, dev)
        # one warm-up forward at the timed shape (cuBLAS, DTensor's
        # sharding-propagation cache)
        meshed.forward(warm)
        _sync(dev)
        dist.barrier()
        ep = []
        with _launches(out), _routes(ep):
            got = _timed(lambda: meshed.forward(tokens), dev, out, "wall_s")
        got = got.full_tensor()
        del meshed
        if rank == 0:
            plain.forward(warm)
            _sync(dev)
            ml = []
            with _routes(ml):
                ref = _timed(lambda: plain.forward(tokens), dev, out,
                             "meshless_wall_s")
            del plain
            flips = [_flips(m, e, cfg) for m, e in zip(ml, ep)]
            held = _held(flips, moe, blocks - 1, b, s, dev)
            del ml
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            m32 = build_model(cfg.with_(dtype="float32"), device=dev,
                              seed=0)
            _round_to_(m32.params.tree(), dtype_of(cfg.dtype))
            r32 = m32.forward(tokens)
            del m32
            e_m, e_ep = _rel_rms(ref, r32), _rel_rms(got, r32)
            h_m = h_ep = None
            if held.any():
                h_m = _rel_rms(ref[held], r32[held])
                h_ep = _rel_rms(got[held], r32[held])
            del r32
            bar = (1.0 + EP_BF16_SLACK) * e_m
            next_m, next_p = got[:, -1].argmax(-1), ref[:, -1].argmax(-1)
            out.update(
                meshless_vs_float32=e_m, ep_vs_float32=e_ep,
                ep_vs_float32_bar=bar, ep_over_meshless=e_ep / e_m,
                held_tokens=int(held.sum()),
                meshless_vs_float32_held=h_m, ep_vs_float32_held=h_ep,
                ep_over_meshless_held=None if h_m is None else h_ep / h_m,
                flips=[dict({k: v for k, v in f.items() if k != "mask"},
                            layer=i) for i, f in zip(moe, flips)],
                rel_rms=_rel_rms(got, ref),
                max_abs_err=float((got.float() - ref.float()).abs().max()),
                logits_max_abs=float(ref.abs().max()),
                argmax_agree_share=float(
                    (got.argmax(-1) == ref.argmax(-1)).float().mean()),
                next_token=next_m.tolist(),
                next_token_meshless=next_p.tolist(),
                next_margin=_top2_gap(got[:, -1]),
                next_margin_meshless=_top2_gap(ref[:, -1]),
                finite=bool(torch.isfinite(got).all()),
                ok=bool(torch.equal(next_m, next_p) and e_ep <= bar
                        and torch.isfinite(got).all()))
            del ref
        del got, ep
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _elastic_parts(cfg, dev, mesh):
    from ..models import build_model
    from ..parallel.sharding import P
    from ..train import AdamW

    model = build_model(cfg, device=dev, seed=0, remat="full", mesh=mesh)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.0)
    if mesh is None:
        return model, opt, None, None
    pspecs = model.param_pspecs(mesh)
    return model, opt, pspecs, {"params": pspecs,
                                "opt": opt.state_pspecs(pspecs),
                                "step": P()}


def _elastic_batch(cfg, c, i, dev):
    from ..train.data import DataConfig, SyntheticPipeline

    # "random": the markov kind keeps a [V, V] float64 transition matrix
    # on the host, 185 GB at qwen3-4b's vocab
    pipe = SyntheticPipeline(DataConfig(global_batch=c["batch"],
                                        seq_len=c["seq"],
                                        vocab_size=cfg.vocab_size,
                                        kind="random"), device="cpu")
    return {k: v.to(dev) for k, v in pipe.batch_at(i).items()}


def _elastic_save(rank, world, dev, c):
    from ..models import build_model
    from ..train import init_state, make_train_step
    from ..train import checkpoint as ckpt
    from ..train.elastic import reshard_state

    cfg = _config(c["arch"], c["layers"], "float32", c.get("scaled", False))
    mesh = _mesh(world)
    plain = build_model(cfg, device=dev, seed=0)
    out = {"mesh": list(MESH_SHAPES[world]),
           "draws_equal": draws_equal(plain.params.tree())}
    del plain
    model, opt, pspecs, sspecs = _elastic_parts(cfg, dev, mesh)
    state = reshard_state(init_state(model, opt), sspecs, mesh)
    step = make_train_step(model, opt, param_specs=pspecs, mesh=mesh)
    losses = []
    for i in range(c["steps"]):
        state, m = step(state, _elastic_batch(cfg, c, i, dev))
        losses.append(float(m["loss"]))
    d = os.path.join(c["dir"], "ckpt")
    t = time.perf_counter()
    ckpt.save(state, d, c["steps"])
    out["save_s"] = time.perf_counter() - t
    _, m = step(state, _elastic_batch(cfg, c, c["steps"], dev))
    out.update(losses=losses, loss_next_live=float(m["loss"]),
               saved_step=c["steps"])
    return out


def _train_4k(rank, world, dev, c):
    from ..configs import get_config
    from . import dryrun
    from .cells import active_param_count, plan_cell
    from .collbreak import result_dims
    from .cost import trace_cost
    from .roofline import H100_SXM, roofline_terms

    cfg = get_config(c["arch"])
    mesh = _mesh(world)
    hbm = dryrun.hbm_bytes(None)
    plan = plan_cell(cfg, "train_4k", mesh, hbm_per_chip=hbm)
    per_mb = plan.batch // plan.num_microbatches  # sequences, global
    mb = c["microbatches"] or plan.num_microbatches
    run = dataclasses.replace(plan, num_microbatches=mb)
    tokens = per_mb * mb * plan.seq
    out: Dict[str, Any] = {
        "mesh": list(MESH_SHAPES[world]), "hbm_bytes": hbm,
        "layers": cfg.num_layers,
        "plan": dryrun._plan_dict(plan),
        "sequences_a_microbatch_a_data_rank":
            per_mb // dict(zip(mesh.mesh_dim_names, mesh.shape))["data"],
        "microbatches_run": mb, "tokens": tokens}
    _sync(dev)
    t = time.perf_counter()
    call, _, remat = dryrun._cell_call(cfg, run, "train_4k", mesh, dev,
                                       batch=per_mb * mb)
    _sync(dev)
    out["build_s"] = time.perf_counter() - t
    out["remat_run"] = remat
    out["state_bytes"] = torch.cuda.memory_allocated(dev)
    # 1. under the cost trace (it warms up too)
    t = time.perf_counter()
    with trace_cost(collectives=True) as mode:
        res = call()
        loss0 = float(res[1]["loss"])
        del res
    _sync(dev)
    out["traced_wall_s"] = time.perf_counter() - t
    cost = mode.cost
    out["cost"] = dict(cost.summary(), kernel_calls=dict(cost.kernel_calls))
    rows = mode.rows
    del mode
    # 2. timed and counted
    dist.barrier()
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with _launches(out):
        t = time.perf_counter()
        res = call()
        _sync(dev)
        out["wall_s"] = time.perf_counter() - t
    out["loss"] = float(res[1]["loss"])
    out["loss_traced_step"] = loss0
    del res
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["peak_of_plan"] = out["max_memory_allocated"] \
        / plan.est_bytes_per_chip
    out["tokens_per_s"] = tokens / out["wall_s"]
    # 3. one step under the profiler
    dist.barrier()
    out["profile"] = profile_step(call)
    # 4. the collectives' bus rates at the step's sizes, and the bound
    out["collectives"] = step_collectives(rows)
    out["activation"] = [out["sequences_a_microbatch_a_data_rank"],
                         plan.seq, cfg.d_model]
    out["activation_collectives"] = activation_collectives(
        ((kind, result_dims(what)[1], 1) for kind, what, *_ in rows),
        out["activation"], MESH_SHAPES[world][1], cfg.num_layers * mb)
    # every rank times the same collectives in the same order: rank 0's
    sizes = [_largest(out["collectives"], world)]
    dist.broadcast_object_list(sizes, src=0)
    rates = {}
    for kind, dtype, nbytes, g in sizes[0]:
        rates[f"{kind} g={g} {dtype} {nbytes}"] = bus_rate(
            kind, nbytes, g, dtype, mesh, dev)
    out["bus_rates"] = rates
    link = _step_link_rate(out["collectives"], rates)
    out["link_rate_bytes_per_s"] = link
    tot_wire = cost.total_wire_bytes
    model_flops = 6.0 * active_param_count(cfg) * tokens
    bound = roofline_terms(cost.dot_flops, cost.dot_bytes_flash, tot_wire,
                           world, model_flops,
                           H100_SXM.with_link(link) if link else H100_SXM)
    out["model_flops"] = model_flops
    out["roofline"] = bound
    out["wall_of_bound"] = out["wall_s"] / bound["step_bound_s"]
    return out


def _flash(rank, world, dev, c):
    """Both sm90 flash kernels on this rank's card at the train_4k
    layer's local shape: (B, heads, kv heads) over the mesh's data and
    model axes, S, D; bf16, causal.  Median of CUDA-event samples."""
    from ..kernels.flash_attention import ops

    d_ax, m_ax = MESH_SHAPES[world]
    b, hq, hkv = c["batch"], c["heads"] // m_ax, c["kv_heads"] // m_ax
    s, dh = c["seq"], c["head_dim"]
    gen = torch.Generator(device=dev).manual_seed(rank)
    q = torch.randn((b, hq, s, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    dout = torch.randn_like(q)
    out, lse = ops._launch(q, k, v, True, None, None, None, "sm90",
                           with_lse=True)
    fwd = _event_ms(lambda: ops._launch(q, k, v, True, None, None, None,
                                        "sm90", with_lse=True))
    bwd = _event_ms(lambda: ops._launch_bwd(q, k, v, out, dout, True, None,
                                            None, None, lse=lse))
    return {"device": str(dev), "shape": [b, hq, hkv, s, dh],
            "fwd_sm90_ms": fwd, "bwd_sm90_ms": bwd,
            "card": torch.cuda.get_device_name(dev)}


def _gpipe(rank, world, dev, c):
    from ..parallel.pipeline import gpipe
    from .mesh import make_mesh

    d, per, n_mb, mb = c["d"], c["layers_per_stage"], c["microbatches"], \
        c["mb"]
    gen = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn((world * per, d, d), generator=gen, device=dev) \
        / math.sqrt(d)
    x = torch.randn((n_mb, mb, d), generator=gen, device=dev)
    out = {"stages": world, "d": d, "layers": world * per,
           "microbatches": n_mb, "mb": mb,
           "draws_equal": draws_equal({"w": w, "x": x})}
    mesh = make_mesh((world,), ("pod",))

    def stage_fn(p, h):
        for wi in p:
            h = torch.tanh(h @ wi)
        return h

    stages = w.reshape((world, per, d, d))
    with torch.no_grad():
        gpipe(stage_fn, stages, x, mesh, axis="pod")  # warm-up
        _sync(dev)
        dist.barrier()
        t = time.perf_counter()
        y = gpipe(stage_fn, stages, x, mesh, axis="pod").full_tensor()
        _sync(dev)
        out["wall_s"] = time.perf_counter() - t
        if rank == 0:
            t = time.perf_counter()
            ref = stage_fn(w, x.reshape(n_mb * mb, d)).reshape(x.shape)
            _sync(dev)
            out["in_order_wall_s"] = time.perf_counter() - t
            err = float((y - ref).abs().max())
            out.update(max_abs_err=err, ok=bool(err <= GPIPE_TOL
                                                and torch.isfinite(y).all()))
    return out


_PARTS: Dict[str, Callable] = {
    "train_check": _train_check, "decode": _decode,
    "moe_ep": _moe_ep, "moe_prefill": _moe_prefill,
    "elastic_save": _elastic_save,
    "train_4k": _train_4k, "flash": _flash, "gpipe": _gpipe}


def rank_cards(rank: int, world: int, tmp: str, device: str,
               parts: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Run `parts` (module docstring) in order on this rank; returns
    {part: record}.  ``elastic_save`` writes its checkpoint under `tmp`."""
    dev = _setup(device)
    out: Dict[str, Any] = {"rank": rank, "world": world, "device": str(dev)}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    failed = []
    for name, c in parts.items():
        t = time.perf_counter()
        if name == "elastic_save":
            c = dict(c, dir=tmp)
        try:
            rec = _PARTS[name](rank, world, dev, c)
        except Exception:  # the next parts still run; the rank fails below
            rec = {"error": traceback.format_exc()}
            failed.append(name)
        rec["part_s"] = time.perf_counter() - t
        if dev.type == "cuda":
            rec["part_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        out[name] = rec
        with open(os.path.join(tmp, f"rank{rank}.parts.json"), "w") as f:
            json.dump(out, f)
    if failed:
        raise RuntimeError(f"rank {rank}: parts {failed} failed:\n"
                           + "\n".join(out[n]["error"] for n in failed))
    return out


def rank_elastic_restore(rank: int, world: int, tmp: str, device: str,
                         c: Dict[str, Any]) -> Dict[str, Any]:
    """`elastic_save`'s checkpoint restored onto this world's mesh
    (`restore(shardings=)`) and, on rank 0, onto no mesh: one step each
    on the batch after the saved step; the losses."""
    from ..models.common import tree_map
    from ..parallel.sharding import tree_specs_to_shardings
    from ..train import init_state, make_train_step
    from ..train import checkpoint as ckpt

    dev = _setup(device)
    cfg = _config(c["arch"], c["layers"], "float32", c.get("scaled", False))
    mesh = _mesh(world)
    d, step_no = os.path.join(tmp, "ckpt"), c["steps"]
    batch = _elastic_batch(cfg, c, step_no, dev)
    model, opt, pspecs, sspecs = _elastic_parts(cfg, dev, mesh)
    # the template: each leaf's global shape and dtype, nothing gathered
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"),
                        init_state(model, opt))
    t = time.perf_counter()
    state = ckpt.restore(template, d, step_no, device=dev,
                         shardings=tree_specs_to_shardings(sspecs, mesh))
    out = {"mesh": list(MESH_SHAPES[world]),
           "restore_s": time.perf_counter() - t}
    _, m = make_train_step(model, opt, param_specs=pspecs, mesh=mesh)(
        state, batch)
    out["loss_restored_mesh"] = float(m["loss"])
    del state, model
    if rank == 0:
        plain, opt, _, _ = _elastic_parts(cfg, dev, None)
        state = ckpt.restore(init_state(plain, opt), d, step_no)
        _, m = make_train_step(plain, opt)(state, batch)
        out["loss_restored_meshless"] = float(m["loss"])
    return out


def train_4k_launches(layers: int, microbatches: int) -> Dict[str, int]:
    """The flash launches of one train step a rank under remat "full": two
    sm90 forwards (the forward and its recompute) and one tensor-core
    backward a layer and microbatch."""
    return {"sm90": 2 * layers * microbatches, "simt": 0, "bwd": 0,
            "bwd_sm90": layers * microbatches}


_T4_RANK = ("loss", "wall_s", "tokens", "tokens_per_s", "flash_launches",
            "flash_devices", "max_memory_allocated", "peak_of_plan",
            "state_bytes", "build_s", "traced_wall_s",
            "link_rate_bytes_per_s", "wall_of_bound")
_T4_COST = ("dot_flops", "dot_bytes_flash", "collective_counts",
            "collective_wire_bytes", "total_wire_bytes", "kernel_calls")


def activation_collectives(calls, activation: List[int], tp: int,
                           per: float) -> Dict[str, float]:
    """Of `calls`, (kind, result dims, calls) rows, those whose result is
    the size of the [B, S, d] `activation` (`launch.collbreak.
    activation_sized` over a "model" axis of `tp`): calls by kind over
    `per` (a step's layers times its microbatches)."""
    from .collbreak import activation_sized

    out: Dict[str, float] = {}
    for kind, dims, n in calls:
        if activation_sized(list(dims), activation, tp):
            out[kind] = out.get(kind, 0.0) + n / per
    return out


def train_4k_summary(ranks: List[Dict[str, Any]]):
    """(summary, problems) of the ranks' ``train_4k`` records: rank 0's
    plan, cost, collectives, bus rates and roofline, and each rank's
    loss, wall, launches, peak and profile; a problem for each rank whose
    loss is not finite, whose flash launches are not `train_4k_launches`
    of its layers and microbatches, or whose traced step all-reduced the
    activation more than `TRAIN_4K_ALL_REDUCES` times a layer and
    microbatch (or recorded no count)."""
    rows, problems = [], []
    for r in ranks:
        t4 = r["train_4k"]
        want = train_4k_launches(t4["layers"], t4["microbatches_run"])
        if not math.isfinite(t4["loss"]):
            problems.append(f"rank {r['rank']} train_4k loss {t4['loss']}")
        if t4["flash_launches"] != want:
            problems.append(f"rank {r['rank']} train_4k flash "
                            f"{t4['flash_launches']}, not {want}")
        acts = t4.get("activation_collectives")
        if acts is None:
            problems.append(f"rank {r['rank']} train_4k recorded no "
                            f"activation collectives")
        elif acts.get("all-reduce", 0.0) > TRAIN_4K_ALL_REDUCES:
            problems.append(
                f"rank {r['rank']} train_4k all-reduced the activation "
                f"{acts['all-reduce']:.2f} times a layer and microbatch, "
                f"above {TRAIN_4K_ALL_REDUCES}")
        rows.append({"rank": r["rank"], "card": r.get("card"),
                     **{k: t4[k] for k in _T4_RANK},
                     "profile": {k: v for k, v in t4["profile"].items()
                                 if k != "nccl"},
                     "nccl": t4["profile"]["nccl"]})
    t4 = ranks[0]["train_4k"]
    return {"plan": t4["plan"], "mesh": t4["mesh"],
            "microbatches_run": t4["microbatches_run"],
            "sequences_a_microbatch_a_data_rank":
                t4["sequences_a_microbatch_a_data_rank"],
            "tokens": t4["tokens"], "remat_run": t4["remat_run"],
            "activation": t4.get("activation"),
            "activation_collectives": t4.get("activation_collectives"),
            "cost": {k: t4["cost"][k] for k in _T4_COST},
            "collectives_top": t4["collectives"][:8],
            "bus_rates": t4["bus_rates"], "roofline": t4["roofline"],
            "model_flops": t4["model_flops"], "by_rank": rows}, problems


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def _event_ms(fn: Callable, samples: int = 10, warmup: int = 2,
              dev: Optional[torch.device] = None) -> float:
    """Median ms of `fn()`: CUDA events on the card, the host clock on
    the CPU (the CPU tests' worlds)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        if dev is not None and dev.type == "cpu":
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def profile_step(fn: Callable) -> Dict[str, Any]:
    """`fn()` once on this rank's card under ``torch.profiler`` (CPU and
    CUDA activity): its wall, the device's busy time (the union of its
    kernels' and copies' intervals, over every stream) and idle share of
    the wall, the kernels' summed time, and the NCCL kernels by name
    (calls, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    del res
    spans, nccl, total = [], {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        total += (hi - lo) / 1e3
        if "nccl" in e.name.lower():
            row = nccl.setdefault(e.name[:80], {"calls": 0, "ms": 0.0})
            row["calls"] += 1
            row["ms"] += (hi - lo) / 1e3
    spans.sort()
    busy, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    busy /= 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
            "kernel_ms_sum": total, "kernels": len(spans),
            "nccl_ms": sum(r["ms"] for r in nccl.values()),
            "nccl_calls": sum(r["calls"] for r in nccl.values()),
            "nccl": nccl}


def step_collectives(rows) -> List[Dict[str, Any]]:
    """`launch.cost`'s collective rows (kind, "dtype[shape]", group size,
    wire bytes, region) grouped by (kind, dtype, result bytes, group
    size): calls and wire bytes each, largest wire bytes first."""
    from .collbreak import result_dims
    from .cost import _DTYPE_BYTES

    groups: Dict[tuple, Dict[str, Any]] = {}
    for kind, what, g, wire, _ in rows:
        dtype, dims = result_dims(what)
        numel = 1
        for s in dims:
            numel *= s
        nbytes = numel * _DTYPE_BYTES[getattr(torch, dtype)]
        key = (kind, dtype, nbytes, int(g))
        row = groups.setdefault(key, {"kind": kind, "dtype": dtype,
                                      "result_bytes": nbytes, "g": int(g),
                                      "calls": 0, "wire_bytes": 0.0})
        row["calls"] += 1
        row["wire_bytes"] += wire
    return sorted(groups.values(), key=lambda r: -r["wire_bytes"])


def _largest(colls, world: int, per_kind: int = 2):
    """The (kind, dtype, bytes, g) of the `per_kind` rows of each (kind,
    g) carrying the most wire bytes, and all-gather, reduce-scatter and
    all-reduce over the whole world at the size of their kind's largest
    row."""
    seen: Dict[tuple, int] = {}
    out = []
    for r in colls:
        k = (r["kind"], r["g"])
        if seen.get(k, 0) < per_kind and r["kind"] in _MEASURED:
            seen[k] = seen.get(k, 0) + 1
            out.append((r["kind"], r["dtype"], r["result_bytes"], r["g"]))
    for kind in _MEASURED[:3]:
        top = next((r for r in colls if r["kind"] == kind), None)
        row = (kind, top["dtype"], top["result_bytes"], world) \
            if top else None
        if world > 1 and row and row not in out:
            out.append(row)
    return out


_MEASURED = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


def _group_of(g: int, mesh):
    """A process group of `g` ranks: the world, or the mesh dim of that
    size (the "model" dim first)."""
    if g == dist.get_world_size():
        return None
    for name in ("model", "data"):
        if mesh.size(mesh.mesh_dim_names.index(name)) == g:
            return mesh.get_group(name)
    raise ValueError(f"no group of {g} ranks on {mesh}")


def bus_rate(kind: str, nbytes: int, g: int, dtype: str, mesh,
             dev: torch.device, samples: int = 10) -> Dict[str, Any]:
    """One collective of `kind` with `nbytes` result bytes a rank in a
    group of `g` (`_group_of`), timed with CUDA events (median of
    `samples` after 3 warm-ups; the host clock on the CPU): its ms and
    bus rate, the wire bytes of
    `launch.cost.ring_wire_bytes` (nccl-tests' bus bytes) over the
    time."""
    from .cost import _DTYPE_BYTES, ring_wire_bytes

    dt = getattr(torch, dtype)
    n = max(1, nbytes // _DTYPE_BYTES[dt])
    group = _group_of(g, mesh)
    out = torch.zeros(n, dtype=dt, device=dev)
    if kind == "all-gather":
        inp = torch.zeros(n // g, dtype=dt, device=dev)
        out = out[:inp.numel() * g]

        def fn():
            dist.all_gather_into_tensor(out, inp, group=group)
    elif kind == "reduce-scatter":
        inp = torch.zeros(n * g, dtype=dt, device=dev)

        def fn():
            dist.reduce_scatter_tensor(out, inp, group=group)
    elif kind == "all-reduce":
        def fn():
            dist.all_reduce(out, group=group)
    else:
        inp = torch.zeros(n - n % g, dtype=dt, device=dev)
        out = out[:inp.numel()]

        def fn():
            dist.all_to_all_single(out, inp, group=group)
    dist.barrier()
    ms = _event_ms(fn, samples=samples, warmup=3, dev=dev)
    wire = ring_wire_bytes(kind, out.numel() * _DTYPE_BYTES[dt], g)
    return {"kind": kind, "g": g, "dtype": dtype,
            "result_bytes": out.numel() * _DTYPE_BYTES[dt], "ms": ms,
            "bus_bytes_per_s": wire / (ms / 1e3)}


def _step_link_rate(colls, rates) -> Optional[float]:
    """The step's wire bytes over their time at the measured bus rates:
    each (kind, g) row at the rate measured nearest its size."""
    by: Dict[tuple, List] = {}
    for r in rates.values():
        by.setdefault((r["kind"], r["g"]), []).append(r)
    wire = secs = 0.0
    for r in colls:
        got = by.get((r["kind"], r["g"]))
        if not got:
            continue
        near = min(got, key=lambda m: abs(math.log(
            max(m["result_bytes"], 1) / max(r["result_bytes"], 1))))
        wire += r["wire_bytes"]
        secs += r["wire_bytes"] / near["bus_bytes_per_s"]
    return wire / secs if secs else None
