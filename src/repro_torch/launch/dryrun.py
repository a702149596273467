"""Multi-pod dry run: trace one step of every (architecture x shape x mesh)
cell on a fake world of 256 or 512 ranks and extract the roofline terms.

The JAX package's ``launch/dryrun.py``, which lowers and compiles each
cell on 512 placeholder host devices.  Here torch's ``fake`` process
group (``torch.testing._internal.distributed.fake_pg``) makes a world of
the production mesh's size in one process -- every collective returns at
once, having moved nothing -- and `launch.mesh.make_production_mesh`
builds the (16, 16) or (2, 16, 16) ``DeviceMesh`` on it.  The model is
built from its `defs` table with every parameter an empty tensor on the
meta device (a DTensor shard of it on the mesh: nemotron-4-340b allocates
nothing), and one call runs on meta tensors -- `train.make_train_step`
with the plan's optimizer, microbatches, accumulation dtype and remat,
one prefill (``forward``), or one ``decode_step`` on a cache laid out per
the model's ``cache_pspecs`` -- under `launch.cost.trace_cost` (per-rank
GEMM FLOPs and bytes at the local shards' shapes, the flash kernels from
their launch shapes, collective wire bytes) and `launch.memdebug.
MemoryTrace` (per-rank live bytes: the peak).  Attention takes the card's
route, the flash kernels' shape functions (`kernels.flash_attention.
ops`: a meta call launches nothing), so no memory figure holds a [B, H, S,
S] score tensor, as none does on the card; ``cost.dot_bytes`` counts the
scores as plain attention would move them, ``dot_bytes_flash`` not.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --hbm-gb 80 \
      --arch qwen2-0.5b --shape train_4k [--mesh pod|multipod|both|one]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --hbm-gb 80 --all

Per cell this writes results/dryrun_torch/<arch>__<shape>__<mesh>.json
with the reference's keys where their meaning carries over: ``ok``,
``plan``, ``params_total``, ``params_active``, ``model_flops``,
``roofline`` and ``roofline_flash`` (its ``hlo`` is ``cost`` here), and
``memory``: the traced peak and the planner's estimate against the
device memory (``fits_hbm``, ``fits_hbm_estimate``).  The device memory
is the card's ``total_memory`` where a card is present, else ``--hbm-gb``;
with neither the CLI raises.  The planner budgets it less the reference's
2.5 GB of headroom (`cells.plan_cell`).  ``roofline`` is on the
`roofline.H100_SXM` datasheet rates with ``--link-gbps`` for the
collective term; ``roofline_flash`` takes ``dot_bytes_flash`` (the
reference's also halves float32 collectives, which its CPU backend
upcasts; here a collective runs in its own dtype, so both terms take the
traced wire bytes).  The reference's ``cpu_f32_upcast_bytes`` and TPU
memory estimate describe XLA's CPU backend and have no counterpart.
``--mesh one`` is one device: the plan on a (1, 1) mesh, the model
without a mesh, as a single card runs it (`card_step` runs that call on
the card).  A cell that fails is written with ``ok: false`` and its
traceback, and the CLI exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import get_config, list_archs
from ..models.api import model_parts
from ..models.common import REMAT, dtype_of, tree_map
from ..parallel.compat import (fake_store, memory_snapshot,
                               record_memory_history)
from ..parallel.sharding import PROFILES, MeshShape, P
from .cells import (SHAPES, CellPlan, _param_count, active_param_count,
                    cell_supported, plan_cell)
from .cost import trace_cost
from .mesh import make_production_mesh, production_mesh_shape
from .roofline import H100_SXM, roofline_terms

__all__ = ["run_cell", "trace_cell", "card_step", "hbm_bytes",
           "fake_world", "MESHES", "RESULTS_DIR", "LINK_GBPS", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# The collective term's link rate, GB/s a device: a 256- or 512-device mesh
# spans 32 or 64 eight-GPU nodes, so its collectives cross the nodes'
# network; a DGX H100 node has one ConnectX-7 400 Gb/s (50 GB/s) InfiniBand
# port a GPU (NVIDIA DGX H100 datasheet).  NVLink inside a node (900 GB/s
# both ways a GPU) is faster; pass --link-gbps to model it.
LINK_GBPS = 50.0

MESHES = {"pod": 256, "multipod": 512, "one": 1}


def hbm_bytes(hbm_gb: Optional[float]) -> float:
    """Device memory in bytes: the card's where one is present, else
    `hbm_gb` GB; ValueError with neither (the dry run assumes no size)."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    if hbm_gb is None:
        raise ValueError("no card to read the device memory from: pass "
                         "--hbm-gb")
    return float(hbm_gb) * 1e9


def fake_world(size: int) -> None:
    """Make the default process group a fake world of `size` ranks (this
    process rank 0), replacing any other."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=size)


def _mesh_shape(mesh_name: str) -> MeshShape:
    if mesh_name == "one":
        return MeshShape(("data", "model"), (1, 1))
    return production_mesh_shape(multi_pod=mesh_name == "multipod")


def _plan(cfg, shape_name: str, mesh_name: str, hbm: float,
          extra: Optional[dict]) -> CellPlan:
    plan = plan_cell(cfg, shape_name, _mesh_shape(mesh_name),
                     hbm_per_chip=hbm)
    for k, v in (extra or {}).items():
        if v is not None:
            setattr(plan, k, v)
    return plan


def _plan_dict(plan: CellPlan) -> Dict[str, Any]:
    return {"num_microbatches": plan.num_microbatches,
            "opt_dtype": plan.opt_dtype, "optimizer": plan.optimizer,
            "accum_dtype": plan.accum_dtype, "remat": plan.remat,
            "profile": plan.profile, "seq_parallel": plan.seq_parallel,
            "est_bytes_per_chip": plan.est_bytes_per_chip,
            "note": plan.note}


def _cell_call(cfg, plan: CellPlan, shape_name: str, mesh, device,
               batch: Optional[int] = None):
    """(call, tensors, remat): one step of the cell with the model on
    `device` ("meta": empty parameters from the `defs` table; else
    random ones from seed 0), on `mesh` (None: one device), and the
    tensors the call is given; `batch` in place of the shape's global
    batch.  ``remat`` is what ran: the plan's."""
    from ..models import build_model
    from ..train import AdamW, make_train_step
    from ..train.elastic import reshard_state
    from ..train.optimizer import Adafactor

    sh = SHAPES[shape_name]
    b, s = batch or sh["batch"], sh["seq"]
    rules = PROFILES[plan.profile]
    remat = plan.remat
    dtype = dtype_of(cfg.dtype)
    defs, cls = model_parts(cfg)
    if device.type == "meta":
        params = tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                                device=device), defs(cfg))
        model = cls(cfg, params, remat=remat, mesh=mesh,
                    sp=plan.seq_parallel, rules=rules)
    else:
        model = build_model(cfg, device=device, seed=0, remat=remat,
                            mesh=mesh, sp=plan.seq_parallel, rules=rules)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(0)

    def tokens(shape):
        if gen is None:
            return torch.zeros(shape, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, shape, dtype=torch.int32,
                             device=device, generator=gen)

    frames = None
    if cfg.family == "encdec":
        frames = torch.zeros((b, cfg.encoder_frames, cfg.d_model),
                             dtype=dtype, device=device) if gen is None \
            else torch.randn((b, cfg.encoder_frames, cfg.d_model),
                             dtype=dtype, device=device, generator=gen)
    if plan.kind == "train":
        opt = Adafactor() if plan.optimizer == "adafactor" \
            else AdamW(state_dtype=plan.opt_dtype)
        params = tree_map(lambda t: t.detach(), model.params.tree())
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        pspecs = None
        if mesh is not None:
            pspecs = model.param_pspecs(mesh)
            state = reshard_state(state, {
                "params": pspecs, "opt": opt.state_pspecs(pspecs, params),
                "step": P()}, mesh)
        data = {"tokens": tokens((b, s)), "targets": tokens((b, s))}
        if frames is not None:
            data["frames"] = frames
        step = make_train_step(model, opt, plan.num_microbatches,
                               accum_dtype=plan.accum_dtype,
                               param_specs=pspecs, mesh=mesh)
        return (lambda: step(state, data)), [state, data], remat
    if plan.kind == "prefill":
        tok = tokens((b, s))
        kw = {} if frames is None else {"frames": frames}

        def prefill():
            with torch.no_grad():
                return model.forward(tok, **kw)
        return prefill, [model.params.tree(), tok, kw], remat
    cache = model.init_cache(b, s)
    tok = tokens((b, 1))
    return (lambda: model.decode_step(cache, tok, s - 1)), \
        [model.params.tree(), cache, tok], remat


class MetaCache:
    """Remembers the output shapes of ops on meta tensors: an op that
    writes none of its inputs and returns no view of one, called again on
    inputs of the same shapes, strides and dtypes with the same other
    arguments, returns new empty meta tensors of the shapes it returned
    before instead of running its meta function again (many are Python
    decompositions, ~0.2 ms an op: a 256-microbatch step repeats the same
    ~14,000 ops 256 times).  FakeTensorMode's dispatch cache, for meta
    tensors: `CostMode` runs each op through `__call__`."""

    def __init__(self):
        self._out: Dict[Any, Any] = {}
        self._ok: Dict[Any, bool] = {}

    def _cacheable(self, func) -> bool:
        ok = self._ok.get(func)
        if ok is None:
            s = func._schema
            ok = not any(a.alias_info is not None for a in s.arguments) \
                and not any(r.alias_info is not None for r in s.returns) \
                and all(str(r.type) == "Tensor" for r in s.returns) \
                and len(s.returns) > 0
            self._ok[func] = ok
        return ok

    def __call__(self, func, args, kwargs):
        if not self._cacheable(func):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except _Uncacheable:
            return func(*args, **kwargs)
        meta = self._out.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            if not all(isinstance(t, torch.Tensor) and t.is_meta
                       for t in outs):
                return out
            self._out[key] = (isinstance(out, tuple), [
                (t.shape, t.stride(), t.dtype) for t in outs])
            return out
        many, specs = meta
        outs = tuple(torch.empty_strided(s, st, dtype=d, device="meta")
                     for s, st, d in specs)
        return outs if many else outs[0]


class _Uncacheable(Exception):
    pass


def _key(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Uncacheable
        return ("T", tuple(x.shape), x.stride(), x.dtype,
                x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return (type(x).__name__, x)
    raise _Uncacheable


def _model_flops(cfg, plan: CellPlan, shape_name: str,
                 batch: Optional[int] = None) -> float:
    sh = SHAPES[shape_name]
    tokens = (batch or sh["batch"]) * (sh["seq"] if plan.kind != "decode"
                                       else 1)
    return (6.0 if plan.kind == "train" else 2.0) * \
        active_param_count(cfg) * tokens


def trace_cell(arch: str, shape_name: str, mesh_name: str, hbm: float,
               extra: Optional[dict] = None, memory=None,
               collectives: bool = False, batch: Optional[int] = None):
    """Trace one cell's step on a fake world of `mesh_name`'s size:
    (plan, `launch.cost.CostMode`, `memdebug.MemoryTrace`, seconds,
    remat run).  `memory` is the trace to fill (default: a new one);
    `batch` in place of the shape's global batch."""
    from .cost import CostMode
    from .memdebug import MemoryTrace

    cfg = get_config(arch)
    plan = _plan(cfg, shape_name, mesh_name, hbm, extra)
    fake_world(MESHES[mesh_name])
    mesh = None if mesh_name == "one" else \
        make_production_mesh(multi_pod=mesh_name == "multipod")
    call, given, remat = _cell_call(cfg, plan, shape_name, mesh,
                                    torch.device("meta"), batch=batch)
    memory = memory if memory is not None else MemoryTrace()
    memory.track(given)
    t0 = time.time()
    with trace_cost(collectives=collectives, run=MetaCache(),
                    observe=memory.observe) as mode:
        call()
    assert isinstance(mode, CostMode)
    return plan, mode, memory, time.time() - t0, remat


def run_cell(arch: str, shape_name: str, mesh_name: str, hbm: float,
             extra: Optional[dict] = None,
             link_gbps: float = LINK_GBPS,
             batch: Optional[int] = None) -> dict:
    cfg = get_config(arch)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
           "batch": batch or SHAPES[shape_name]["batch"]}
    ok, reason = cell_supported(cfg, shape_name)
    if not ok:
        out.update(skipped=True, skip_reason=reason)
        return out
    n_dev = MESHES[mesh_name]
    plan, mode, memory, secs, remat = trace_cell(arch, shape_name,
                                                 mesh_name, hbm, extra,
                                                 batch=batch)
    c = mode.cost
    out["plan"] = _plan_dict(plan)
    out["remat_run"] = remat
    out["trace_s"] = secs
    out["cost"] = dict(c.summary(), kernel_calls=dict(c.kernel_calls))
    est = plan.est_bytes_per_chip
    out["memory"] = {
        "peak_bytes_per_device": memory.peak, "hbm_bytes": hbm,
        "fits_hbm": bool(memory.peak < hbm),
        "est_bytes_per_chip": est, "fits_hbm_estimate": bool(est < hbm),
        "attention_scores": "in no figure: attention traced through the "
                            "flash kernels' shape functions (Q, K, V, O)"}
    model_flops = _model_flops(cfg, plan, shape_name, batch)
    out["params_total"] = _param_count(cfg)
    out["params_active"] = active_param_count(cfg)
    out["model_flops"] = model_flops
    hw = H100_SXM.with_link(link_gbps * 1e9)
    out["hw"] = {"name": "NVIDIA H100 SXM5 80GB (datasheet, 700 W)",
                 "peak_flops": hw.peak_flops, "hbm_bw": hw.hbm_bw,
                 "link_bw": hw.link_bw}
    out["roofline"] = roofline_terms(
        flops_per_dev=c.dot_flops, bytes_per_dev=c.dot_bytes,
        wire_bytes_per_dev=c.total_wire_bytes, n_dev=n_dev,
        model_flops=model_flops, hw=hw)
    out["roofline_flash"] = roofline_terms(
        flops_per_dev=c.dot_flops, bytes_per_dev=c.dot_bytes_flash,
        wire_bytes_per_dev=c.total_wire_bytes, n_dev=n_dev,
        model_flops=model_flops, hw=hw)
    out["ok"] = True
    return out


def card_step(arch: str, shape_name: str, extra: Optional[dict] = None,
              memory_history: bool = False, top: int = 10,
              batch: Optional[int] = None, repeat: int = 1) -> dict:
    """One step of the cell on one card (`--mesh one`'s call, with random
    parameters from seed 0; `batch` in place of the global batch), run
    `repeat` times and the last timed and counted: wall seconds, the
    peak of ``torch.cuda.max_memory_allocated`` over all, `launch.cost`'s
    summary and the flash kernels' launches; with `memory_history`
    instead of the cost trace, the `top` blocks live at the recorded peak
    (`memdebug.card_top_blocks`; allocation sites only, Python frames),
    which needs no count."""
    from ..kernels.flash_attention import ops

    if not torch.cuda.is_available():
        raise RuntimeError("card_step needs a CUDA card")
    cfg = get_config(arch)
    hbm = hbm_bytes(None)
    plan = _plan(cfg, shape_name, "one", hbm, extra)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call, _, remat = _cell_call(cfg, plan, shape_name, None, dev,
                                batch=batch)
    for _ in range(repeat - 1):
        call()
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES_BY_KERNEL)
    t0 = time.perf_counter()
    if memory_history:
        record_memory_history(context="alloc", stacks="python",
                              max_entries=200_000)
        out = call()
    else:
        with trace_cost() as mode:
            out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"plan": _plan_dict(plan), "remat_run": remat, "wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "hbm_bytes": hbm,
           "launches": {k: ops.LAUNCHES_BY_KERNEL[k] - before[k]
                        for k in before},
           "model_flops": _model_flops(cfg, plan, shape_name, batch)}
    if not memory_history:
        c = mode.cost
        res["cost"] = dict(c.summary(), kernel_calls=dict(c.kernel_calls))
    else:
        snap = memory_snapshot()
        record_memory_history(enabled=None)
        from .memdebug import card_top_blocks

        res["peak_bytes"], res["top"] = card_top_blocks(snap, top)
    res["out"] = out
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences a step in place of the shape's global "
                         "batch (with --microbatches, fewer of the plan's "
                         "microbatches)")
    ap.add_argument("--seq-parallel", dest="sp", default=None,
                    choices=["on", "off"])
    ap.add_argument("--profile", default=None,
                    choices=["tp2d", "fsdp", "fsdp_ep"])
    ap.add_argument("--remat", default=None, choices=list(REMAT))
    ap.add_argument("--tag", default="")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="device memory in GB where no card is present "
                         "(the card's own is read where one is)")
    ap.add_argument("--link-gbps", type=float, default=LINK_GBPS,
                    help="GB/s a device for the collective term (default: "
                         "a DGX H100 node's 400 Gb/s InfiniBand port a "
                         "GPU, NVIDIA DGX H100 datasheet)")
    args = ap.parse_args(argv)
    try:
        hbm = hbm_bytes(args.hbm_gb)
    except ValueError as e:
        ap.error(str(e))
    # DTensor warns at every Partial over two mesh dims that it reduces in
    # two collectives (the cost trace counts both)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"both": ["pod", "multipod"]}.get(args.mesh, [args.mesh])

    extra = {}
    if args.microbatches is not None:
        extra["num_microbatches"] = args.microbatches
    if args.sp is not None:
        extra["seq_parallel"] = args.sp == "on"
    if args.profile is not None:
        extra["profile"] = args.profile
    if args.remat is not None:
        extra["remat"] = args.remat

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}{tag}.json")
                t0 = time.time()
                try:
                    res = run_cell(arch, shape, mesh_name, hbm,
                                   extra or None, args.link_gbps,
                                   batch=args.batch)
                except Exception as e:  # noqa: BLE001
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=float)
                status = ("SKIP" if res.get("skipped")
                          else "OK" if res.get("ok") else "FAIL")
                msg = res.get("error", "")
                if res.get("ok"):
                    r = res["roofline"]
                    msg = (f"dom={r['dominant']} comp={r['compute_s']:.4f}s "
                           f"mem={r['memory_s']:.4f}s "
                           f"coll={r['collective_s']:.4f}s "
                           f"fit={res['memory']['fits_hbm']}")
                print(f"[{status}] {arch} {shape} {mesh_name} "
                      f"({time.time()-t0:.0f}s) {msg}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
