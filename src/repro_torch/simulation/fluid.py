"""Fluid-flow network simulator (PyTorch), reproducing the §VIII methodology.

The port of the JAX package's ``simulation/fluid.py``, uncertified engines.
Flows are fluids split across candidate paths.  Adaptive modes (UGAL /
UGAL_PF) converge to a Wardrop equilibrium of the queueing congestion game
via Frank-Wolfe on the Beckmann potential:

  cost(candidate) = sum over its links of (1 + w(rho)),  w = M/D/1 delay
  split <- (1 - 2/(t+2)) * split + 2/(t+2) * one_hot(argmin cost)

UGAL_PF additionally applies the paper's 2/3 adaptation threshold: a flow
adapts away from its minimal path only to the extent the first (local)
min-path link exceeds 2/3 utilization.  Oblivious modes: `min` puts
everything on the unique minimal path; `valiant`/`cvaliant`/`ecmp` split
uniformly across their candidates.

Each Frank-Wolfe step is a link-load gather (`_fw_pieces.loads`), the
per-candidate path-cost reduction (`cost_of`, through
`kernels.minplus.ops.path_costs`: the CUDA kernel on the card, its plain
PyTorch version on the CPU) and an argmin best response (`target_of`).
Two engines share that core, as in the reference:

  * ``engine="batched"`` (default) -- `latency_curve` solves every offered
    load at once along a leading load dimension (the reference's vmap);
    `saturation_throughput` runs the bisection with each probe
    warm-started from the previous probe's split (`_probe_schedule`),
    keeping `lo`, `hi` and the feasibility test on the device.
  * ``engine="scalar"`` -- one cold solve per offered load, the reference.

The reference's ``lax.scan`` is a Python loop here, 37 launches per step
on the card (`scripts/profile_fw_step.py`), and nothing in it reads a device value on the host: no ``.item()``,
``float()`` or ``bool()`` of a tensor inside the loop, so the host runs
ahead of the card.

Where the port must match the reference's arithmetic:

  * Every tensor is float32, as the reference pins it; demand is cast on
    entry (`FlowPaths.device_arrays`).
  * The step size ``gamma = 2/(t+2)`` is computed from a float32 ``t``
    (the reference's ``t0 + arange(iters, float32)``), and as a true
    division: ``2.0 / tensor`` in PyTorch is ``reciprocal(tensor) * 2``,
    which can round differently, so the numerators are tensors.
  * The best response takes the first minimum, as ``jnp.argmin`` does
    (``torch.argmin`` documents the same); invalid candidates are masked
    to +inf first in both.

Not ported yet: ``certify=True`` (ROADMAP Queue 1, item 4) and
``trace=True`` (item 5) raise `NotImplementedError`.  Oblivious modes never
run a Frank-Wolfe step, so their saturations never call the path-cost
kernel; `evaluate_load` and `latency_curve` do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.minplus.ops import path_costs
from ..obs.record import get_recorder
from .paths import FlowPaths

__all__ = ["FluidResult", "SaturationResult", "evaluate_load",
           "saturation_throughput", "truncation_error", "latency_curve"]

_EPS = 1e-6
_RHO_CAP = 0.999
_BUF_PACKETS = 32.0  # 128-flit input buffers, 4-flit packets (paper §VIII-A)
# Warm-started probes resume the step-size schedule at this t: the first
# warm step moves 2/(t+2) = 1/3 of the way to the current best response,
# instead of gamma(0) = 1 which would discard the carried split entirely.
_WARM_T0 = 4.0
_ADAPTIVE = ("ugal", "ugal_pf")


@dataclass
class FluidResult:
    offered: float  # per-endpoint offered load (fraction of injection bw)
    accepted: float  # per-endpoint accepted throughput
    max_util: float
    mean_latency: float  # cycles
    mean_hops: float


@dataclass
class SaturationResult:
    """`saturation_throughput(..., return_info=True)` payload.

    `truncation_err` estimates the adaptive-mode Frank-Wolfe truncation
    noise at the returned saturation load: the L-inf gap between the
    last-iterate link loads and the running average of the visited
    iterates' link loads (`truncation_error`).  Exactly 0.0 for oblivious
    modes, whose split is load-independent.
    """
    saturation: float
    truncation_err: float


def _not_ported(certify: bool, trace: bool) -> None:
    if certify:
        raise NotImplementedError(
            "certify=True is not ported yet (ROADMAP Queue 1, item 4)")
    if trace:
        raise NotImplementedError(
            "trace=True is not ported yet (ROADMAP Queue 1, item 5)")


def _queue_delay(rho: torch.Tensor) -> torch.Tensor:
    """M/D/1 waiting time, capped near saturation."""
    r = rho.clamp(0.0, _RHO_CAP)
    return r / (2.0 * (1.0 - r))


def _max_util(rho: torch.Tensor, num_links: int) -> torch.Tensor:
    if num_links:
        return rho.amax(dim=-1)
    return rho.new_zeros(rho.shape[:-1])


class _FWPieces(NamedTuple):
    """`_fw_pieces` bundle; see its docstring for the field contracts."""
    init: torch.Tensor
    equilibrate: Callable
    loads: Callable
    cost_of: Callable
    fw_target: Callable
    target_of: Callable
    gap_of: Callable


def _fw_pieces(eidx, loads_rep, valid, is_min, first_edge, num_links: int,
               mode: str) -> _FWPieces:
    """Shared Frank-Wolfe building blocks.

    Every closure accepts optional leading batch dimensions (one per
    offered load in `_solve_batch`) in front of the per-flow ones:

      init              [F, K] mode-dependent starting split.
      equilibrate(split0, demand, iters, t0)
                        `iters` Frank-Wolfe steps from `split0` with step
                        sizes 2/(t+2) for t = t0, t0+1, ...; identity for
                        oblivious modes (their split is the fixed point).
      loads(split, demand) -> rho [..., E]
      cost_of(rho)      -> per-candidate path cost [..., F, K], one
                        `path_costs` call per load.
      fw_target(split, rho) -> [..., F, K] best-response target (adaptive
                        modes only; includes the UGAL_PF gate).
      target_of(split, rho, cost) -> fw_target with the masked cost given.
      gap_of(split, target, cost, demand) -> Frank-Wolfe duality gap
                        sum_f demand_f * <split_f - target_f, cost_f>.

    Link loads use the incidence structure from `FlowPaths.device_arrays`:
    a padded per-edge gather matrix in the common case, or `index_add_`
    for pathologically skewed incidence counts.  The reference wraps the
    gathered tables in ``lax.optimization_barrier`` to keep XLA from fusing
    them into their consumers; eager PyTorch fuses nothing, so there is no
    barrier here.
    """
    dtype = torch.float32
    k = eidx.shape[1]
    minvec = is_min.to(dtype)
    minvec = minvec / minvec.sum(dim=1, keepdim=True).clamp_min(1)
    uniform = valid.to(dtype) / valid.sum(dim=1, keepdim=True).clamp_min(1)
    has_alt = (valid & ~is_min).any(dim=1)
    slots = torch.arange(k, device=eidx.device)

    def loads(split, demand):
        w = (split * demand[..., None]).flatten(-2)  # [..., F*K]
        if loads_rep[0] == "pad":
            inc = loads_rep[1]  # [E, W], pad index F*K -> zero weight
            w = torch.cat([w, w.new_zeros(w.shape[:-1] + (1,))], dim=-1)
            return w.index_select(-1, inc.reshape(-1)).unflatten(
                -1, inc.shape).sum(dim=-1)  # [..., E]
        # "scatter" fallback for pathologically skewed incidence counts:
        # slower, but rounding stays proportional to each edge's own load
        real = (eidx < num_links).to(w.dtype)  # [F, K, L]
        w3 = w.unflatten(-1, (eidx.shape[0], k))[..., None] * real
        rho = w.new_zeros(w.shape[:-1] + (num_links + 1,))
        rho.index_add_(-1, eidx.reshape(-1), w3.flatten(-3))
        return rho[..., :num_links]

    def cost_of(rho):
        delay = 1.0 + _queue_delay(rho)
        d = torch.cat([delay, delay.new_zeros(delay.shape[:-1] + (1,))], -1)
        if d.dim() == 1:
            return path_costs(d, eidx)  # [F, K]
        return torch.stack([path_costs(row, eidx)
                            for row in d.reshape(-1, d.shape[-1])]
                           ).reshape(d.shape[:-1] + eidx.shape[:2])

    def target_of(split, rho, cost):
        # one-hot by comparison: F.one_hot would give int64 and, without
        # care, read the index range back on the host
        target = (cost.argmin(dim=-1)[..., None] == slots).to(split.dtype)
        if mode == "ugal_pf":
            # the 2/3 local-occupancy adaptation threshold (paper
            # §VII-C): occupancy is of the 128-flit (32-packet) output
            # buffer, whose M/D/1 mean queue length only crosses 2/3
            # near rho ~ 0.98
            r1 = rho.index_select(-1, first_edge)
            qlen = _queue_delay(r1) * r1  # Little
            gate = ((qlen / _BUF_PACKETS - 2.0 / 3.0) * 8.0).clamp(0.0, 1.0)
            gate = torch.where(has_alt, gate, 0.0)
            target = gate[..., None] * target + (1 - gate)[..., None] * minvec
        return target

    def fw_target(split, rho):
        return target_of(split, rho,
                         torch.where(valid, cost_of(rho), float("inf")))

    def gap_of(split, target, cost, demand):
        # per-flow inner products first, as the reference: the gap is a
        # difference of near-equal inner products
        c = torch.where(valid, cost, 0.0)
        per_flow = ((split - target) * c).sum(dim=-1)
        return (demand * per_flow).sum(dim=-1)

    def equilibrate(split0, demand, iters: int, t0: float = 0.0):
        if mode not in _ADAPTIVE:
            return split0
        # float32 t, as the reference's t0 + arange(iters, float32), and a
        # tensor numerator: `2.0 / t` would be reciprocal(t) * 2
        t = t0 + torch.arange(iters, dtype=dtype, device=split0.device)
        gammas = torch.full_like(t, 2.0) / (t + 2.0)
        keeps = 1 - gammas
        split = split0
        for i in range(iters):
            rho = loads(split, demand)
            split = keeps[i] * split + gammas[i] * fw_target(split, rho)
        return split

    init = minvec if mode in ("min", "ugal", "ugal_pf") else uniform
    return _FWPieces(init, equilibrate, loads, cost_of, fw_target, target_of,
                     gap_of)


def _pieces(fp: FlowPaths, dev: torch.device):
    eidx, loads_rep, valid, is_min, first_edge, demand, hops = \
        fp.device_arrays(dev)
    fw = _fw_pieces(eidx, loads_rep, valid, is_min, first_edge, fp.num_links,
                    fp.mode)
    return fw, demand, valid, hops


def _metrics(split, rho, cost, valid, hops, demand, offered, num_links: int):
    """FluidResult fields per load: (accepted, max_util, mean_latency,
    mean_hops), each [P] for `offered` [P] -- the formulas `evaluate_load`
    applies on the host."""
    max_util = _max_util(rho, num_links)
    d = demand * offered[:, None]
    dsum = d.sum(dim=-1).clamp_min(_EPS)
    wsum = (split * torch.where(valid, cost, 0.0)).sum(dim=-1)
    lat = (d * wsum).sum(dim=-1) / dsum
    hop = (d * (split * hops).sum(dim=-1)).sum(dim=-1) / dsum
    accepted = offered * (torch.ones_like(max_util)
                          / max_util.clamp_min(_EPS)).clamp(max=1.0)
    return accepted, max_util, lat, hop


def _solve(fp: FlowPaths, offered: float, iters: int, dev: torch.device):
    """Single-load reference solve: (split [F,K], rho [E], cost [F,K])."""
    fw, demand, _, _ = _pieces(fp, dev)
    demand = demand * offered
    split = fw.equilibrate(fw.init, demand, iters)
    rho = fw.loads(split, demand)
    return split, rho, fw.cost_of(rho)


def _solve_batch(fp: FlowPaths, offered_vec: torch.Tensor, iters: int,
                 dev: torch.device):
    """The cold-start equilibrium at every offered load at once, along a
    leading load dimension (the reference's vmap)."""
    fw, demand, valid, hops = _pieces(fp, dev)
    d = demand * offered_vec[:, None]  # [P, F]
    split0 = fw.init.expand(len(offered_vec), -1, -1)
    split = fw.equilibrate(split0, d, iters)
    rho = fw.loads(split, d)
    return _metrics(split, rho, fw.cost_of(rho), valid, hops, demand,
                    offered_vec, fp.num_links)


def _probe_schedule(iters: int, probes: int) -> tuple:
    """Per-probe Frank-Wolfe step budgets for the warm-started bisection.

    The first probe jumps half the load range away from the carried
    equilibrium and gets iters/2 steps to re-converge; the next four move
    geometrically less and start warm, so iters/4 suffices; probes beyond
    the fifth refine within 1/64 of the range from an almost-converged
    split and get iters/8.
    """
    sched = ([max(1, iters // 2)] + [max(1, iters // 4)] * 4
             + [max(1, iters // 8)] * max(0, probes - 5))
    return tuple(sched[:probes])


def _saturation_batch(fp: FlowPaths, iters: int, probe_schedule: tuple,
                      dev: torch.device) -> torch.Tensor:
    """Saturation bisection with warm-started Frank-Wolfe probes.

    A fully converged solve at offered = 1.0 (accepted at once when
    feasible), then one bisection step per `probe_schedule` entry over
    [0, 1], each re-equilibrating from the previous probe's split with that
    entry's step count, resuming the step-size schedule at `_WARM_T0`.
    `lo`, `hi` and `feasible` stay on the device; the caller reads the
    result once.
    """
    fw, demand, _, _ = _pieces(fp, dev)
    split = fw.equilibrate(fw.init, demand, iters)  # offered = 1.0
    max1 = _max_util(fw.loads(split, demand), fp.num_links)

    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.ones((), dtype=torch.float32, device=dev)
    for probe_iters in probe_schedule:
        mid = 0.5 * (lo + hi)
        d = demand * mid
        split = fw.equilibrate(split, d, probe_iters, t0=_WARM_T0)
        feasible = _max_util(fw.loads(split, d), fp.num_links) <= 1.0
        lo = torch.where(feasible, mid, lo)
        hi = torch.where(feasible, hi, mid)
    return torch.where(max1 <= 1.0, torch.ones_like(lo), lo)


def _truncation_gap(fp: FlowPaths, offered: float, iters: int,
                    dev: torch.device) -> torch.Tensor:
    """L-inf gap between last-iterate and averaged Frank-Wolfe link loads
    after `iters` steps from the cold-start split at `offered` load."""
    fw, demand, _, _ = _pieces(fp, dev)
    d = demand * offered
    t = torch.arange(iters, dtype=torch.float32, device=dev)
    gammas = torch.full_like(t, 2.0) / (t + 2.0)
    keeps = 1 - gammas
    split = fw.init
    acc = torch.zeros(fp.num_links, dtype=torch.float32, device=dev)
    for i in range(iters):
        rho = fw.loads(split, d)
        split = keeps[i] * split + gammas[i] * fw.fw_target(split, rho)
        acc = acc + rho
    return (fw.loads(split, d) - acc / iters).abs().max()


def _as_flow_paths(fp) -> FlowPaths:
    """A single FlowPaths passes through; a sequence of chunks is
    concatenated via `FlowPaths.concat`.  Callers issuing many solver
    calls should concatenate once themselves so the device-array cache
    persists across calls."""
    if isinstance(fp, FlowPaths):
        return fp
    if isinstance(fp, (list, tuple)):
        return FlowPaths.concat(fp)
    raise TypeError(f"expected FlowPaths or a sequence of them, got "
                    f"{type(fp).__name__}")


def evaluate_load(fp, offered: float, iters: int = 250,
                  certify: bool = False, trace: bool = False,
                  device="cuda") -> FluidResult:
    """FluidResult at one offered load, solved on `device`."""
    fp = _as_flow_paths(fp)
    _not_ported(certify, trace)
    dev = resolve_device(device)
    rec = get_recorder()
    with rec.span("fluid.evaluate_load", mode=fp.mode,
                  offered=float(offered)) as sp:
        split, rho, cost = sp.sync(_solve(fp, float(offered), iters, dev))
        split = split.cpu().numpy()
        rho = rho.cpu().numpy()
        cost = cost.cpu().numpy()
    max_util = float(rho.max()) if len(rho) else 0.0
    demand = fp.pattern.demand * offered
    wsum = (split * np.where(fp.valid, cost, 0.0)).sum(axis=1)
    lat = float((demand * wsum).sum() / max(demand.sum(), _EPS))
    hops = float((demand * (split * fp.hops).sum(axis=1)).sum()
                 / max(demand.sum(), _EPS))
    accepted = offered * min(1.0, 1.0 / max(max_util, _EPS))
    return FluidResult(offered=float(offered), accepted=float(accepted),
                       max_util=max_util, mean_latency=lat, mean_hops=hops)


def saturation_throughput(fp, tol: float = 0.005, iters: int = 250,
                          engine: str = "batched", return_info: bool = False,
                          certify: bool = False, trace: bool = False,
                          device="cuda"):
    """Largest per-endpoint offered load with max link utilization <= 1
    (bisection; adaptive splits re-equilibrate at every probe), solved on
    `device`.  `fp` is a FlowPaths or a sequence of FlowPaths chunks.

    engine="batched" (default) runs the bisection with warm-started probes
    and reads one value back at the end; engine="scalar" is the per-probe
    reference; the batched probes' step counts follow `_probe_schedule`.
    With `return_info=True` the result is a `SaturationResult` that also
    carries `truncation_error` at the returned load.
    """
    fp = _as_flow_paths(fp)
    _not_ported(certify, trace)
    dev = resolve_device(device)
    rec = get_recorder()
    if engine == "batched":
        probes = max(1, int(np.ceil(np.log2(1.0 / tol))))
        sched = _probe_schedule(iters, probes)
        with rec.span("fluid.saturation_throughput", mode=fp.mode,
                      probes=probes) as sp:
            sat = float(sp.sync(_saturation_batch(fp, iters, sched, dev)))
    elif engine != "scalar":
        raise ValueError(f"unknown engine {engine!r}")
    elif evaluate_load(fp, 1.0, iters, device=dev).max_util <= 1.0:
        sat = 1.0
    else:
        lo, hi = 0.0, 1.0
        while hi - lo > tol:
            mid = 0.5 * (lo + hi)
            if evaluate_load(fp, mid, iters, device=dev).max_util <= 1.0:
                lo = mid
            else:
                hi = mid
        sat = lo
    if not return_info:
        return sat
    return SaturationResult(saturation=sat,
                            truncation_err=truncation_error(fp, sat, iters,
                                                            device=dev))


def truncation_error(fp, offered: float, iters: int = 250,
                     device="cuda") -> float:
    """Estimated adaptive-mode Frank-Wolfe truncation error at `offered`
    load: the L-inf gap between last-iterate and averaged link loads after a
    cold `iters`-step solve (see `SaturationResult`).  0.0 for oblivious
    modes, whose splits are load-independent fixed points."""
    fp = _as_flow_paths(fp)
    dev = resolve_device(device)
    if fp.mode not in _ADAPTIVE or not fp.num_links or offered <= 0:
        return 0.0
    return float(_truncation_gap(fp, float(offered), iters, dev))


def latency_curve(fp, loads, iters: int = 250, engine: str = "batched",
                  certify: bool = False, trace: bool = False,
                  device="cuda"):
    """FluidResult per offered load, solved on `device`.  engine="batched"
    (default) solves every load at once along a leading load dimension;
    engine="scalar" calls `evaluate_load` per load (the reference)."""
    fp = _as_flow_paths(fp)
    _not_ported(certify, trace)
    dev = resolve_device(device)
    loads = [float(l) for l in loads]
    if engine == "batched":
        vec = torch.tensor(loads, dtype=torch.float32, device=dev)
        with get_recorder().span("fluid.latency_curve", mode=fp.mode,
                                 points=len(loads)) as sp:
            acc, mx, lat, hop = (x.cpu().numpy() for x in
                                 sp.sync(_solve_batch(fp, vec, iters, dev)))
        return [FluidResult(offered=l, accepted=float(a), max_util=float(m),
                            mean_latency=float(la), mean_hops=float(h))
                for l, a, m, la, h in zip(loads, acc, mx, lat, hop)]
    if engine != "scalar":
        raise ValueError(f"unknown engine {engine!r}")
    return [evaluate_load(fp, l, iters, device=dev) for l in loads]
