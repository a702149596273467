"""Multi-rank helpers for the port's sharding tests: gloo processes on the
CPU, and the rank functions they run.

`run_ranks(fn, world, tmp_path, *args)` is the port's launcher
(`repro_torch.launch.ranks`) on gloo: it spawns `world` processes, joins
them in a gloo process group through a FileStore in `tmp_path` (never a
fixed port, so tests under pytest-xdist do not collide), runs
``fn(rank, world, tmp_path, *args)`` in each and waits at most
`timeout` seconds: a rank that raises fails the call with its traceback,
and ranks still running at the deadline are killed, so a hang fails in
its own seconds.
The rank functions live here, not in the test files, because a spawned
process imports its function's module, and this one imports neither jax
nor the JAX package.  Inputs and outputs go through .npz files in
`tmp_path`; rank 0 writes the outputs.
"""
import os

import numpy as np
import torch


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 180.0):
    """``fn(rank, world, tmp_path, *args)`` on `world` gloo ranks (module
    docstring): the port's launcher, `repro_torch.launch.ranks.run_ranks`
    with ``backend="gloo"``; raises its `RankFailure` on a rank's
    exception or on the deadline, and returns each rank's result."""
    from repro_torch.launch.ranks import run_ranks as launch

    return launch(fn, world, tmp_path, *args, backend="gloo",
                  timeout=timeout)


def save_tree(path, tree):
    """A nested dict of arrays/tensors as an .npz keyed by "a/b/c"."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            flat["/".join(prefix)] = np.asarray(
                node.detach().cpu() if isinstance(node, torch.Tensor)
                else node)
    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path):
    """`save_tree`'s inverse: nested dicts of numpy arrays."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = data[key]
    return out


def _full(tree):
    """Plain CPU tensors of a tree whose leaves may be DTensors."""
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.sharding import is_dtensor

    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def _scaled_down(arch):
    from repro_torch.configs import get_config

    return get_config(arch).scaled_down(dtype="float32", num_layers=2)


def rank_train_step(rank, world, tmp, shape, variants):
    """One sharded step of qwen3-4b (2 layers, float32) from the reference
    parameters and batch in tmp/inputs.npz, for each (name, sp, profile,
    microbatches) of `variants`: the loss, grad norm, gradients and new
    parameters to tmp/<name>.npz."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import model_parts
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import P, PROFILES
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.train_step import value_and_grad

    cfg = _scaled_down("qwen3-4b")
    inputs = load_tree(os.path.join(tmp, "inputs.npz"))
    params = params_from_reference(inputs["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    mesh = make_test_mesh(*shape)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.0)
    for name, sp, profile, microbatches in variants:
        rules = PROFILES[profile]
        model = model_parts(cfg)[1](cfg, params, remat="full", mesh=mesh,
                                    sp=sp, rules=rules)
        pspecs = model.param_pspecs(mesh)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        state = reshard_state(state, {"params": pspecs,
                                      "opt": opt.state_pspecs(pspecs),
                                      "step": P()}, mesh)
        new, m = make_train_step(model, opt, microbatches,
                                 param_specs=pspecs, mesh=mesh)(state, batch)
        new_params = _full(new["params"])
        grads = _full(value_and_grad(model, state["params"], batch)[1])
        if rank == 0:
            save_tree(os.path.join(tmp, f"{name}.npz"),
                      {"params": new_params, "grads": grads,
                       "loss": m["loss"], "grad_norm": m["grad_norm"]})


def rank_moe_ep(rank, world, tmp, shapes, archs):
    """`moe_apply` with expert parallelism on each ("data", "model") mesh
    of `shapes` from the reference's parameters and input in
    tmp/<arch>.npz, and without a mesh from the same: the outputs to
    tmp/<arch>_out.npz ("ep_<d>x<m>", "meshless")."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mlp
    from repro_torch.models.convert import params_from_reference

    meshes = {f"ep_{d}x{m}": make_mesh((d, m), ("data", "model"))
              for d, m in shapes}
    for arch in archs:
        inputs = load_tree(os.path.join(tmp, f"{arch}.npz"))
        cfg = _scaled_down(arch).with_(
            moe_capacity_factor=float(inputs["capacity_factor"]))
        p = params_from_reference(inputs["params"], device="cpu")
        x = torch.from_numpy(inputs["x"])
        out = {name: mlp.moe_apply(p, x, cfg, mesh=mesh).full_tensor()
               for name, mesh in meshes.items()}
        out["meshless"] = mlp.moe_apply(p, x, cfg)
        if rank == 0:
            save_tree(os.path.join(tmp, f"{arch}_out.npz"), out)


def rank_gpipe(rank, world, tmp):
    """`gpipe` of tanh(x @ w_i) over a `world`-stage "pod" axis from
    tmp/gpipe.npz (w [L, D, D], x [n_mb, mb, D]): the output to
    tmp/gpipe_out.npz."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import gpipe

    inputs = load_tree(os.path.join(tmp, "gpipe.npz"))
    w, x = torch.from_numpy(inputs["w"]), torch.from_numpy(inputs["x"])
    mesh = make_mesh((world,), ("pod",))

    def stage_fn(p, h):
        for wi in p:
            h = torch.tanh(h @ wi)
        return h

    stages = w.reshape((world, w.shape[0] // world) + tuple(w.shape[1:]))
    out = gpipe(stage_fn, stages, x, mesh, axis="pod").full_tensor()
    if rank == 0:
        save_tree(os.path.join(tmp, "gpipe_out.npz"), {"y": out})


def _elastic_parts(mesh, cfg):
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import P
    from repro_torch.train import AdamW

    model = build_model(cfg, device="cpu", seed=0, remat="none", mesh=mesh)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.0)
    pspecs = model.param_pspecs(mesh)
    return model, opt, pspecs, {"params": pspecs,
                                "opt": opt.state_pspecs(pspecs), "step": P()}


def _elastic_pipe(cfg):
    from repro_torch.train.data import DataConfig, SyntheticPipeline

    return SyntheticPipeline(DataConfig(global_batch=8, seq_len=16,
                                        vocab_size=cfg.vocab_size,
                                        kind="markov"), device="cpu")


def rank_elastic_save(rank, world, tmp, shape, regrid):
    """tests/test_elastic.py's first half on the port: qwen3-4b (2
    layers, float32) on a `shape` mesh, its state placed by
    `reshard_state`, 3 steps, `checkpoint.save` as step 3 in tmp/ckpt;
    then that state moved by `reshard_state` onto a `regrid` mesh of the
    same ranks (gathered off the first mesh) and step 4 taken there; the
    losses to tmp/elastic_a.npz.  Also `make_mesh(devices=)` over the
    first 4 ranks: a coordinate on those ranks only."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import reshard_state

    cfg = _scaled_down("qwen3-4b")
    mesh = make_mesh(shape, ("data", "model"))
    sub = make_mesh((2, 2), ("data", "model"), devices=range(4))
    if (sub.get_coordinate() is None) != (rank >= 4):
        raise AssertionError(f"rank {rank}: sub-mesh coordinate "
                             f"{sub.get_coordinate()}")
    model, opt, pspecs, sspecs = _elastic_parts(mesh, cfg)
    state = reshard_state(init_state(model, opt), sspecs, mesh)
    pipe = _elastic_pipe(cfg)
    step = make_train_step(model, opt, param_specs=pspecs, mesh=mesh)
    for i in range(3):
        state, m = step(state, pipe.batch_at(i))
    ckpt.save(state, os.path.join(tmp, "ckpt"), 3)
    mesh_c = make_mesh(regrid, ("data", "model"))
    model_c, _, pspecs_c, sspecs_c = _elastic_parts(mesh_c, cfg)
    _, mc = make_train_step(model_c, opt, param_specs=pspecs_c, mesh=mesh_c)(
        reshard_state(state, sspecs_c, mesh_c), pipe.batch_at(3))
    if rank == 0:
        save_tree(os.path.join(tmp, "elastic_a.npz"),
                  {"loss": m["loss"], "loss_regrid": mc["loss"]})


def rank_elastic_restore(rank, world, tmp, shape):
    """The second half on a smaller `shape` mesh: the step-3 checkpoint
    restored with `shardings` (`tree_specs_to_shardings`), one more step
    on batch 3; its loss to tmp/elastic_b.npz."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.sharding import tree_specs_to_shardings
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train import checkpoint as ckpt

    cfg = _scaled_down("qwen3-4b")
    mesh = make_mesh(shape, ("data", "model"))
    model, opt, pspecs, sspecs = _elastic_parts(mesh, cfg)
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"),
                        _full(init_state(model, opt)))
    state = ckpt.restore(template, os.path.join(tmp, "ckpt"), 3,
                         device="cpu",
                         shardings=tree_specs_to_shardings(sspecs, mesh))
    _, m = make_train_step(model, opt, param_specs=pspecs, mesh=mesh)(
        state, _elastic_pipe(cfg).batch_at(3))
    if rank == 0:
        save_tree(os.path.join(tmp, "elastic_b.npz"), {"loss": m["loss"]})


def rank_forward(rank, world, tmp, shape, archs):
    """Each family's forward (scaled down, float32, parameters from
    `build_model`'s seed i for the i-th of `archs`) on a `shape` ("data",
    "model") mesh with the sequence-parallel residual stream (so every
    anchor runs), on the tokens in tmp/<arch>.npz (frames too for the
    encoder-decoder), under ``inference_mode``: the logits to
    tmp/<arch>_out.npz; and the mesh model's parameters written by
    `checkpoint.save` to tmp/ckpt_<arch> (every rank gathers, rank 0
    writes)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ckpt

    mesh = make_mesh(shape, ("data", "model"))
    for seed, arch in enumerate(archs):
        inputs = load_tree(os.path.join(tmp, f"{arch}.npz"))
        model = build_model(_scaled_down(arch), device="cpu", seed=seed,
                            mesh=mesh, sp=True)
        kw = {"frames": torch.from_numpy(inputs["frames"])} \
            if "frames" in inputs else {}
        with torch.inference_mode():
            logits = model.forward(torch.from_numpy(inputs["tokens"]), **kw)
        logits = logits.full_tensor()
        ckpt.save({"params": model.params.tree()},
                  os.path.join(tmp, f"ckpt_{arch}"), 0)
        if rank == 0:
            save_tree(os.path.join(tmp, f"{arch}_out.npz"), {"sp": logits})


def rank_decode(rank, world, tmp, shape, archs, steps):
    """Each family's decode on a `shape` ("data", "model") mesh from the
    reference's parameters, tokens (and frames) in tmp/<arch>.npz:
    `init_cache` on the mesh, then `steps` decode steps; the logits of
    every step to tmp/<arch>_out.npz (rank 0), and the cache's placements
    checked against the model's `cache_pspecs`."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import model_parts
    from repro_torch.models.common import tree_items
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import placements

    mesh = make_mesh(shape, ("data", "model"))
    for arch in archs:
        inputs = load_tree(os.path.join(tmp, f"{arch}.npz"))
        cfg = get_config(arch).scaled_down(
            dtype="float32", num_layers=int(inputs["num_layers"]))
        params = params_from_reference(inputs["params"], device="cpu")
        model = model_parts(cfg)[1](cfg, params, mesh=mesh)
        tokens = torch.from_numpy(inputs["tokens"])
        b, max_seq = tokens.shape[0], int(inputs["max_seq"])
        kw = {"frames": torch.from_numpy(inputs["frames"])} \
            if "frames" in inputs else {}
        cache = model.init_cache(b, max_seq, **kw)
        specs = dict(tree_items(model.cache_pspecs(mesh, b, max_seq)))
        for path, leaf in tree_items(cache):
            if tuple(leaf.placements) != placements(specs[path], mesh):
                raise AssertionError(f"{arch} {path}: {leaf.placements}")
        # a key cache whose sequence dim is sharded (kv_seq over "model")
        seq = any(path[-1] == "k" and specs[path][-2] is not None
                  for path in specs)
        out = []
        for t in range(steps):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
            out.append(logits.full_tensor())
        if rank == 0:
            save_tree(os.path.join(tmp, f"{arch}_out.npz"),
                      {"logits": torch.stack(out),
                       "seq_sharded": np.int32(seq)})


def rank_mesh_grads(rank, world, tmp, shape, archs):
    """Each family's loss and gradients (scaled down, float32, 2 layers,
    `build_model`'s seed 1) on a `shape` ("data", "model") mesh and
    without one, on the batch in tmp/<arch>.npz: rank 0 writes both to
    tmp/<arch>_grads.npz."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.train.train_step import value_and_grad

    mesh = make_mesh(shape, ("data", "model"))
    for arch in archs:
        cfg = _scaled_down(arch)
        batch = {k: torch.from_numpy(v) for k, v
                 in load_tree(os.path.join(tmp, f"{arch}.npz")).items()}
        plain = build_model(cfg, device="cpu", seed=1)
        meshed = build_model(cfg, device="cpu", seed=1, mesh=mesh)
        loss0, g0 = value_and_grad(plain, plain.params.tree(), batch)
        loss1, g1 = value_and_grad(meshed, meshed.params.tree(), batch)
        g1 = _full(g1)
        if rank == 0:
            save_tree(os.path.join(tmp, f"{arch}_grads.npz"),
                      {"loss": torch.stack([loss0, loss1]),
                       "meshless": g0, "mesh": tree_map(torch.Tensor.detach,
                                                        g1)})


def rank_adafactor(rank, world, tmp, shape):
    """Adafactor's update (lr 1e-2) of scaled-down qwen2-0.5b parameters
    (float32, 2 layers) on a `shape` ("data", "model") mesh under the
    tp2d rules, from the parameters, gradients and state in
    tmp/inputs.npz, each placed as the meshless train step's would be:
    the new parameters and state, gathered, to tmp/mesh.npz."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import model_parts
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.sharding import constrain
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import Adafactor

    cfg = _scaled_down("qwen2-0.5b")
    inputs = tree_map(torch.from_numpy,
                      load_tree(os.path.join(tmp, "inputs.npz")))
    mesh = make_mesh(shape, ("data", "model"))
    model = model_parts(cfg)[1](cfg, inputs["params"], mesh=mesh)
    pspecs = model.param_pspecs(mesh)
    opt = Adafactor(learning_rate=1e-2)
    state = reshard_state(
        {"params": inputs["params"], "opt": inputs["opt"]},
        {"params": pspecs, "opt": opt.state_pspecs(pspecs,
                                                   inputs["params"])}, mesh)
    grads = tree_map(lambda g, s: constrain(g, mesh, s), inputs["grads"],
                     pspecs)
    new_p, new_s, _ = opt.update(grads, state["opt"], state["params"])
    out = {"params": _full(new_p), "vr": _full(new_s["vr"]),
           "vc": _full(new_s["vc"])}  # every rank takes part in the gathers
    if rank == 0:
        save_tree(os.path.join(tmp, "mesh.npz"), out)


def rank_where(rank, world, tmp, backend):
    """Where the launcher put this rank: its rank and world as the process
    group sees them, and its device (on NCCL, the current card)."""
    from repro_torch.launch.ranks import rank_device

    dev = str(torch.device("cuda", torch.cuda.current_device())) \
        if backend == "nccl" else str(rank_device(backend, rank))
    import torch.distributed as dist

    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "device": dev, "expected": str(rank_device(backend, rank))}


def rank_raises(rank, world, tmp):
    """Rank 1 raises; the others wait in a collective for it."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def rank_hangs(rank, world, tmp):
    """Rank 0 never returns; the others finish."""
    if rank == 0:
        import time

        time.sleep(3600)


def rank_draws_differ(rank, world, tmp):
    """`launch.cards.draws_equal` on a tree where rank 1's copy differs in
    one bit of one element: the verdict on every rank."""
    from repro_torch.launch.cards import draws_equal

    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(1000, generator=gen),
            "b": {"c": torch.randn(7, 3, generator=gen).bfloat16()}}
    same = draws_equal(tree)
    if rank == 1:
        tree["b"]["c"].view(torch.int16)[3, 1] ^= 1
    return {"same": same, "after_flip": draws_equal(tree)}


def rank_bus_rates(rank, world, tmp, rows):
    """`launch.cards.bus_rate` of every (kind, dtype, bytes, g) in `rows`
    on a (2, 2) mesh (groups of 2 and the world of 4)."""
    from repro_torch.launch.cards import bus_rate
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    return [bus_rate(kind, nbytes, g, dtype, mesh, torch.device("cpu"),
                     samples=2) for kind, dtype, nbytes, g in rows]


class _TwoBranchLSE(torch.autograd.Function):
    """The vocab-parallel logsumexp before F9's repair, for
    `rank_ce_buffers`: its own autograd branch beside the label pick's,
    each op out of place."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(dim=-1, keepdim=True)
        lse = (x - m).exp().sum(dim=-1).log() + m.squeeze(-1)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - lse.unsqueeze(-1)).exp()


def rank_ce_buffers(rank, world, tmp):
    """F9 on a (2, 2) mesh, the vocab sharded over "model": the cross
    entropy of vocab-sharded logits, forward and backward, under
    `launch.memdebug.MemoryTrace`, as the port computes it
    (`losses.cross_entropy`) and as it did before the repair (two
    autograd branches, `_TwoBranchLSE` and the label pick): the peak live
    bytes of each in units of one rank's logits block, and the loss and
    gradient bits of the two."""
    from repro_torch.launch.memdebug import MemoryTrace
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import P, constrain
    from repro_torch.train import losses

    mesh = make_mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, 2048, generator=gen) * 3
    tg = torch.randint(0, 2048, (8, 64), generator=gen)
    block = x.numel() // 4 * x.element_size()

    def before(lg, t):
        lse = _TwoBranchLSE.apply(lg)
        return (lse - losses._label_logits(lg, t)).mean()

    out = {}
    for name, fn in (("before", before), ("after", losses.cross_entropy)):
        lg = constrain(x.clone(), mesh, P("data", None, "model")).detach() \
            .requires_grad_(True)
        trace = MemoryTrace()
        with trace:
            loss = fn(lg, tg)
            fwd = trace.peak
            g, = torch.autograd.grad(loss, lg)
        out[name] = {"fwd_blocks": fwd / block,
                     "peak_blocks": trace.peak / block,
                     "loss": loss.detach(), "grad": g.full_tensor()}
    return {"before": {k: out["before"][k] for k in ("fwd_blocks",
                                                      "peak_blocks")},
            "after": {k: out["after"][k] for k in ("fwd_blocks",
                                                    "peak_blocks")},
            "bits_equal": bool(torch.equal(out["before"]["loss"],
                                           out["after"]["loss"])
                               and torch.equal(out["before"]["grad"],
                                               out["after"]["grad"]))}
