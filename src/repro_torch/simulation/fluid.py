"""Fluid-flow network simulator (PyTorch), reproducing the §VIII methodology.

The port of the JAX package's ``simulation/fluid.py``.
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

  * Every tensor of the uncertified engines is float32, as the reference
    pins it; demand is cast on entry (`FlowPaths.device_arrays`).
  * The step size ``gamma = 2/(t+2)`` is computed from a float ``t`` of
    the working dtype (the reference's ``t0 + arange(iters, float32)``),
    and as a true division: ``2.0 / tensor`` in PyTorch is
    ``reciprocal(tensor) * 2``, so the numerators are tensors.
  * The best response takes the first minimum, as ``jnp.argmin`` does
    (``torch.argmin`` documents the same); invalid candidates are masked
    to +inf first in both.

Certified engine (``certify=True`` on the public entry points): instead of
trusting a fixed iteration budget, the solver computes the Frank-Wolfe
duality gap

  g(split) = sum_f demand_f * <split_f - target_f, cost_f>  >=  Phi - Phi*

and drives everything off it.  The steps are conjugate Frank-Wolfe with an
exact line search on the Beckmann potential (Mitradjieva-Lindberg CFW);
UGAL_PF keeps the uncertified engines' harmonic steps, since its gated
target is not an oracle.  The gap is turned into a certified
max-utilization bracket [util_lb, util_ub] by per-link Bregman
localization (`_util_interval`) and, on the infeasible side, by the
potential-mass bound (`_phi_mass_lower_bound`).  A bisection probe is
certified feasible when util_ub <= 1 and certified infeasible when util_lb
> 1, and `_certified_saturation` stops each warm-started probe on that
decision.  The reference's ``lax.while_loop`` over ``_CERT_STRIDE``-step
chunks is a Python loop here that reads one flag back on the host per
chunk (the exit test) and nothing inside a chunk.  For mode="ugal" the gap
is a true duality gap (`Certificate.kind = "duality-gap"`); for
mode="ugal_pf" it is a fixed-point residual ("gated-residual"); oblivious
splits are exact fixed points (gap 0, "exact").  The fp32 gap has an
inner-product-cancellation noise floor (~1e-3 * total demand), so
``dtype="float64"`` certifies in float64 (default `util_tol` 0.01 instead
of 0.05) and launches the float64 path-cost kernel.  Unlike the reference,
it needs no ``JAX_ENABLE_X64``: the default stays float32, which is what
the reference returns without that flag, and the uncertified engines stay
float32 whatever the certification dtype.

``trace=True`` attaches a `repro_torch.obs.trace.ConvergenceTrace` to the
result: per-iteration (uncertified) or per-chunk (certified) gap, max
utilization, step size and certified bracket.  The samples are written
into preallocated device tensors in the loop, and read back once after it.

The entry points keep the reference's parameter order, with ``device``
last.  Oblivious modes never run a Frank-Wolfe step, so their saturations
never call the path-cost kernel; `evaluate_load` and `latency_curve` do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.minplus.ops import path_costs
from ..obs.record import get_recorder
from ..obs.trace import ConvergenceTrace
from .paths import FlowPaths

__all__ = ["FluidResult", "SaturationResult", "Certificate",
           "CertifiedResult", "evaluate_load", "saturation_throughput",
           "truncation_error", "latency_curve"]

_EPS = 1e-6
_RHO_CAP = 0.999
_BUF_PACKETS = 32.0  # 128-flit input buffers, 4-flit packets (paper §VIII-A)
# Warm-started probes resume the step-size schedule at this t: the first
# warm step moves 2/(t+2) = 1/3 of the way to the current best response,
# instead of gamma(0) = 1 which would discard the carried split entirely.
_WARM_T0 = 4.0
# Certified runs check the duality gap (and the early-exit decision) once
# per chunk of this many line-searched steps, and refresh the incrementally
# updated link loads from the split at the same cadence.
_CERT_STRIDE = 32
_ADAPTIVE = ("ugal", "ugal_pf")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class FluidResult:
    offered: float  # per-endpoint offered load (fraction of injection bw)
    accepted: float  # per-endpoint accepted throughput
    max_util: float
    mean_latency: float  # cycles
    mean_hops: float
    # convergence telemetry when the solve ran with trace=True (None
    # otherwise); kept in fixed-size device buffers during the solve and
    # assembled on the host afterwards (repro_torch.obs.trace)
    trace: ConvergenceTrace = None


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
    # per-probe convergence telemetry when trace=True (None otherwise);
    # truncation_err is NaN when trace=True was requested without
    # return_info (the trace subsumes the heuristic, and the extra cold
    # solve is not free)
    trace: ConvergenceTrace = None


@dataclass
class Certificate:
    """Convergence certificate attached to every `certify=True` result.

    `gap` is the Frank-Wolfe duality gap at the reported iterate, and
    `[util_lb, util_ub]` the certified bracket it induces on the *exact*
    Wardrop-equilibrium max link utilization via per-link Bregman
    localization of the Beckmann potential (`_util_interval`): both the
    measured max_util and the exact equilibrium's lie inside it, and
    `util_err_bound = util_ub - util_lb` is the bracket width the
    `util_tol` stopping rule acts on.  The bracket is theorem-grade when
    `kind == "duality-gap"` (mode="ugal": the target is the true
    linear-minimization oracle, so gap >= Phi - Phi*).  For mode="ugal_pf"
    the 2/3-occupancy gate biases the target away from the oracle, so
    |gap| is a fixed-point residual (`kind == "gated-residual"`): the same
    stopping rule and the same bracket formula, empirically validated
    rather than proven.  Oblivious splits are exact fixed points: gap is
    identically 0, the bracket has zero width, and `kind == "exact"`.

    `converged` is True when the run exited on the bracket test
    (util_err_bound <= util_tol) or, for saturation probes, on a certified
    feasibility decision -- False means the `cert_iters` budget ran out
    first, and `gap` / the bracket report how far the run actually got
    (still valid bounds).  `dtype` records the certification precision
    ("float32" or "float64").
    """
    gap: float
    util_lb: float
    util_ub: float
    util_err_bound: float
    util_tol: float
    iters: int
    dtype: str
    converged: bool
    kind: str


@dataclass
class CertifiedResult:
    """A certified value plus its `Certificate`.

    `value` is whatever the uncertified call would have returned
    (`FluidResult` for `evaluate_load`/`latency_curve`, the saturation
    float for `saturation_throughput`).  For saturations, `[sat_lo,
    sat_hi]` is the *certified* bracket: every probe at or below `sat_lo`
    was certified feasible (util_ub <= 1) and every probe at or above
    `sat_hi` certified infeasible (util_lb > 1), so the exact saturation
    load of the equilibrium model lies in the bracket (up to the bisection
    grid); the point value keeps the uncertified engines' convention
    (largest probed load with measured max_util <= 1).  NaN bracket fields
    on non-saturation results.
    """
    value: object
    cert: Certificate
    sat_lo: float = float("nan")
    sat_hi: float = float("nan")
    # per-stride convergence telemetry when trace=True (None otherwise);
    # trace.final_gap equals cert.gap -- the trace's last sample is
    # written from the same carried gap the certificate is built from
    trace: ConvergenceTrace = None


def _queue_delay(rho: torch.Tensor) -> torch.Tensor:
    """M/D/1 waiting time, capped near saturation."""
    r = rho.clamp(0.0, _RHO_CAP)
    return r / (2.0 * (1.0 - r))


def _queue_delay_prime(rho: torch.Tensor) -> torch.Tensor:
    """d/drho of `_queue_delay` below the cap: 1/(2(1-rho)^2) -- the
    diagonal Beckmann Hessian the conjugate-direction combination uses."""
    r = rho.clamp(0.0, _RHO_CAP)
    return 1.0 / (2.0 * (1.0 - r) ** 2)


# w(_RHO_CAP): the slope of the Beckmann integrand in the clipped region
_W_CAP = _RHO_CAP / (2.0 * (1.0 - _RHO_CAP))


def _w_integral(r: torch.Tensor) -> torch.Tensor:
    """W(r) = int_0^r w(s) ds for the capped M/D/1 delay `_queue_delay`:
    (1/2)(-log(1-r) - r) below the cap, linear with slope w(cap) above."""
    rc = r.clamp(0.0, _RHO_CAP)
    return 0.5 * (-torch.log1p(-rc) - rc) \
        + _W_CAP * (r - _RHO_CAP).clamp_min(0.0)


def _bregman(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-link Bregman divergence of the Beckmann integrand,
    D(x, y) = W(x) - W(y) - w(y)(x - y) >= 0, zero iff x == y (up to the
    zero-curvature region above the cap).  The linear '1 +' part of the
    link cost cancels in the divergence."""
    return _w_integral(x) - _w_integral(y) - _queue_delay(y) * (x - y)


def _util_interval(rho, gap, num_links: int, ymax: float = 4.0):
    """Certified bracket [mu_lb, mu_ub] for the exact Wardrop equilibrium's
    max link utilization, given Phi(rho) - Phi* <= gap with `rho` feasible.

    Phi is separable across links and rho* is first-order optimal over the
    feasible load polytope (rho is a member), so

      Phi(rho) - Phi*  =  grad Phi(rho*) . (rho - rho*) + sum_e D_e
                       >=  D(rho_e, rho*_e)   for every link e separately,

    i.e. each rho*_e lies in the interval where the per-link Bregman
    divergence `_bregman(rho_e, .)` stays <= gap.  The divergence is
    monotone on either side of rho_e, so the interval ends invert by
    bisection (60 steps, elementwise over the links; `rho` is [..., E] and
    `gap` [...]).  Then max_e lower_e <= mu* <= max_e upper_e.  Links
    whose upper interval end exceeds `ymax` report +inf (the divergence
    stops growing only above the cap, so by ymax = 4 that means the gap
    is still huge)."""
    if not num_links:
        z = rho.new_zeros(rho.shape[:-1])
        return z, z
    g = gap.clamp_min(0.0)[..., None]
    w_rho = _w_integral(rho)

    def div(y):
        # `_bregman(rho, y)`, the same arithmetic with W(rho) computed once
        return w_rho - _w_integral(y) - _queue_delay(y) * (rho - y)

    # both interval ends in one bisection, elementwise: row 0 from rho up
    # towards ymax, row 1 from rho down towards 0; invariant: D(rho,
    # inner) <= g, outer is on the far side
    hi0 = torch.full_like(rho, ymax)
    inner = torch.stack([rho, rho])
    outer = torch.stack([hi0, torch.zeros_like(rho)])
    for _ in range(60):
        mid = 0.5 * (inner + outer)
        ok = div(mid) <= g
        inner, outer = (torch.where(ok, mid, inner),
                        torch.where(ok, outer, mid))
    up = torch.where(div(hi0) <= g, float("inf"), inner[0])
    return inner[1].amax(dim=-1), up.amax(dim=-1)


def _phi_mass_lower_bound(phi_star_lb, traversals, ymax: float = 4.0):
    """Potential-mass lower bound on the equilibrium max utilization.

    The Bregman localization above is blind on the infeasible side: the
    capped integrand is linear above `_RHO_CAP`, so no gap can distinguish
    rho* = 1.001 from rho* = 4 there.  This closes that hole with a mass
    argument: if mu* <= m, then per-link convexity gives phi(rho*_e) <=
    rho*_e * phi(m)/m, and the total load is conserved --
    sum_e rho*_e <= `traversals` (total demand weighted by each flow's
    longest candidate path) -- so Phi* <= (phi(m)/m) * traversals.  Given
    `phi_star_lb` <= Phi* (the Frank-Wolfe lower bound Phi(rho) - gap),
    every m violating that inequality is excluded: the largest excluded m
    (monotone, found by a 60-step bisection) is a certified lower bound on
    mu*.  Returns 0 when nothing is excluded."""
    def excluded(m):
        m = m.clamp_min(1e-6)
        return phi_star_lb > (m + _w_integral(m)) / m * traversals

    lo = torch.zeros_like(phi_star_lb)
    hi = torch.full_like(lo, ymax)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        ex = excluded(mid)
        lo, hi = torch.where(ex, mid, lo), torch.where(ex, hi, mid)
    return lo


def _max_util(rho: torch.Tensor, num_links: int) -> torch.Tensor:
    if num_links:
        return rho.amax(dim=-1)
    return rho.new_zeros(rho.shape[:-1])


def _in_order(g: torch.Tensor) -> torch.Tensor:
    """``g.sum(dim=-2)`` from 0, one term after another."""
    acc = g.new_zeros(g.shape[:-2] + g.shape[-1:])
    for row in g.unbind(-2):
        acc = acc + row
    return acc


def _xla_row_sum(g: torch.Tensor, gathered: bool = True) -> torch.Tensor:
    """``g.sum(dim=-2)`` in the order XLA:CPU sums the reference's gathered
    link-load rows.  A row of more than 32 terms is cut into windows of 32,
    the padding split evenly before and after it (XLA's tree-reduction
    rewrite); each window is summed in order, and the windows' sums are
    summed as a row in turn (`gathered` false: in order up to 32).  A
    gathered row of up to 27 terms is summed in order; one of 28 to 32 in
    eight lanes (term j in lane j % 8 while whole groups of eight last),
    the lanes added by halves, then the rest in order, as the compiled
    loop does."""
    n = g.shape[-2]
    if n > 32:
        windows = -(-n // 32)
        lo = (windows * 32 - n) // 2
        return _xla_row_sum(torch.stack(
            [_in_order(g[..., max(0, 32 * i - lo):32 * (i + 1) - lo, :])
             for i in range(windows)], dim=-2), gathered=False)
    if n < 28 or not gathered:
        return _in_order(g)
    whole = n - n % 8
    lanes = [_in_order(g[..., j:whole:8, :]) for j in range(8)]
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + half] for i in range(half)]
    acc = lanes[0]
    for row in g[..., whole:, :].unbind(-2):
        acc = acc + row
    return acc


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for the Frank-Wolfe update and the UGAL_PF blend.

    On the CPU in float32 it is rounded once, as a fused multiply-add: the
    reference runs these updates under XLA:CPU, which contracts each into
    one FMA, and the iterate follows the reference's bit for bit only if it
    rounds as it does (one ulp apart at a step is enough to move a
    saturation on a plateau by a bisection step).  The float64 product of
    two float32 is exact; the float64 sum is made round-to-odd from its
    TwoSum residual, so its rounding to float32 is the correctly rounded
    FMA.  On the card, and in float64, it is ``a * b + c``.
    """
    if a.device.type != "cpu" or torch.result_type(a, b) != torch.float32:
        return a * b + c
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    odd = (err == 0) | ((s.view(torch.int64) & 1) == 1)
    return torch.where(odd, s, torch.nextafter(s, s + err)).float()


def _where_tree(keep, new, old):
    """`new` where the per-load flag `keep` [P] is set, else `old`, on
    every tensor of two matching nested tuples whose leading dim is P."""
    if isinstance(new, tuple):
        return tuple(_where_tree(keep, a, b) for a, b in zip(new, old))
    return torch.where(keep.view(keep.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _line_search(rho, drho, halvings: int):
    """argmin_gamma Phi(rho + gamma * drho) over [0, 1], per load (`rho`
    and `drho` are [..., E]): a short bisection brackets the root of the
    monotone derivative d Phi/d gamma = <drho, 1 + w(rho + g*drho)>, then
    three false-position (secant within the bracket) steps polish it --
    the reference's 2 + `halvings` + 3 derivative evaluations.  Above-cap
    links make the derivative piecewise linear in gamma, where the secant
    step is exact and pure bisection would stall at bracket resolution."""
    def dphi(g):
        return (drho * (1.0 + _queue_delay(rho + g[..., None] * drho))
                ).sum(dim=-1)

    def interp(lo, dlo, hi, dhi):
        denom = dhi - dlo
        g = torch.where(denom > 0, lo - dlo * (hi - lo) / denom,
                        0.5 * (lo + hi))
        return torch.clamp(g, lo, hi)

    def shrink(lo, dlo, hi, dhi, g):
        dg = dphi(g)
        pos = dg > 0
        return (torch.where(pos, lo, g), torch.where(pos, dlo, dg),
                torch.where(pos, g, hi), torch.where(pos, dg, dhi))

    zero = rho.new_zeros(rho.shape[:-1])
    one = torch.ones_like(zero)
    d1 = dphi(one)
    carry = (zero, dphi(zero), one, d1)
    for _ in range(halvings):
        carry = shrink(*carry, 0.5 * (carry[0] + carry[2]))
    for _ in range(3):
        carry = shrink(*carry, interp(*carry))
    return torch.where(d1 <= 0, one, interp(*carry))


class _FWPieces(NamedTuple):
    """`_fw_pieces` bundle; see its docstring for the field contracts."""
    init: torch.Tensor
    equilibrate: Callable
    loads: Callable
    cost_of: Callable
    fw_target: Callable
    target_of: Callable
    gap_of: Callable
    cert_equilibrate: Callable
    equilibrate_traced: Callable


def _fw_pieces(eidx, loads_rep, valid, is_min, first_edge, num_links: int,
               mode: str, dtype: torch.dtype = torch.float32) -> _FWPieces:
    """Shared Frank-Wolfe building blocks.

    Every closure accepts optional leading batch dimensions (one per
    offered load in `_solve_batch` and `_certified_batch`) in front of the
    per-flow ones:

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
      cert_equilibrate(split0, demand, max_iters, util_tol, t0, decide_at,
                        trace_cap)
                        gap-driven conjugate line-search Frank-Wolfe; see
                        below.
      equilibrate_traced(split0, demand, iters, t0)
                        `equilibrate` returning per-iteration (gap,
                        max_util, gamma) samples alongside the split.

    `dtype` is the arithmetic precision of every closure: the uncertified
    engines pass float32 explicitly, certified runs float32 or float64.

    Link loads use the incidence structure from `FlowPaths.device_arrays`:
    a padded per-edge gather matrix in the common case, or `index_add_`
    for pathologically skewed incidence counts.  The reference wraps the
    gathered tables in ``lax.optimization_barrier`` to keep XLA from fusing
    them into their consumers; eager PyTorch fuses nothing, so there is no
    barrier here.

    `cert_equilibrate(split0, demand, max_iters, util_tol, t0=0.0,
    decide_at=None, trace_cap=0)` returns `(split, rho, gap, mu_lb, mu_ub,
    iters, converged, trace)`, each with the batch shape of `split0`'s
    leading dims.  It runs `_CERT_STRIDE`-step chunks until the exit test
    holds.  For mode="ugal" each step is conjugate Frank-Wolfe with an
    exact line search on the Beckmann potential (link loads updated
    incrementally, since they are linear in the split); for mode="ugal_pf"
    each step is the harmonic 2/(t0+t+2) step toward the gated target.  At
    every chunk boundary the link loads are refreshed from the split, the
    duality gap is recomputed, and `_util_interval` turns it into the
    certified bracket [mu_lb, mu_ub], with `mu_lb` maxed with the
    potential-mass bound (`_phi_mass_lower_bound`).  The loop stops when
    the bracket is tighter than `util_tol` -- or, with `decide_at` set, as
    soon as the bracket puts max_util* on either side of `decide_at` -- or
    when `max_iters` is reached.  Nothing is read back on the host inside
    a chunk; the exit flag is read once per chunk.  With a batch of loads
    every load steps together, as under the reference's vmap: a load whose
    test holds keeps its carry (and its `iters`) unchanged while the others
    run on, and the loop ends when no load runs.  With `trace_cap > 0`
    (chunks + 1), `trace` is a tuple of fixed-size per-chunk sample buffers
    `(iter, gap, max_util, mu_lb, mu_ub, gamma, count)`, NaN-padded past
    `count`; `()` when tracing is off.  Oblivious modes return at once
    with gap 0 and a zero-width bracket.
    """
    k = eidx.shape[1]
    minvec = is_min.to(dtype)
    minvec = minvec / minvec.sum(dim=1, keepdim=True).clamp_min(1)
    uniform = valid.to(dtype) / valid.sum(dim=1, keepdim=True).clamp_min(1)
    has_alt = (valid & ~is_min).any(dim=1)
    slots = torch.arange(k, device=eidx.device)
    # longest valid candidate path per flow, in links: any split satisfies
    # sum_e rho_e <= sum_f demand_f * lmax_f (the potential-mass
    # infeasibility certificate's load-conservation budget)
    lmax = torch.where(valid, (eidx < num_links).sum(dim=-1), 0).amax(dim=1)

    inc_t = (loads_rep[1].t().contiguous() if loads_rep[0] == "pad"
             and loads_rep[1].device.type == "cpu" else None)

    def loads(split, demand):
        w = (split * demand[..., None]).flatten(-2)  # [..., F*K]
        if loads_rep[0] == "pad":
            inc = loads_rep[1]  # [E, W], pad index F*K -> zero weight
            w = torch.cat([w, w.new_zeros(w.shape[:-1] + (1,))], dim=-1)
            if w.device.type != "cpu":
                return w.index_select(-1, inc.reshape(-1)).unflatten(
                    -1, inc.shape).sum(dim=-1)  # [..., E]
            # on the CPU in XLA:CPU's order (`_xla_row_sum`): the loads
            # equal the reference's bit for bit
            return _xla_row_sum(w.index_select(-1, inc_t.reshape(-1))
                                .unflatten(-1, inc_t.shape))  # [..., E]
        # "scatter" fallback for pathologically skewed incidence counts:
        # slower, but rounding stays proportional to each edge's own load
        real = (eidx < num_links).to(w.dtype)  # [F, K, L]
        w3 = w.unflatten(-1, (eidx.shape[0], k))[..., None] * real
        rho = w.new_zeros(w.shape[:-1] + (num_links + 1,))
        rho.index_add_(-1, eidx.reshape(-1), w3.flatten(-3))  # reprolint-torch: allow[scatter-add] -- deliberate fallback for pathologically skewed incidence where the padded gather would blow memory; FlowPaths.device_arrays picks the pad path whenever it fits
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
            target = _fma(gate[..., None], target,
                          (1 - gate)[..., None] * minvec)
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

    def step_sizes(iters, t0, device):
        # a float t of the working dtype, as the reference's
        # t0 + arange(iters, dtype), and a tensor numerator: `2.0 / t`
        # would be reciprocal(t) * 2
        t = t0 + torch.arange(iters, dtype=dtype, device=device)
        gammas = torch.full_like(t, 2.0) / (t + 2.0)
        return gammas, 1 - gammas

    def equilibrate(split0, demand, iters: int, t0: float = 0.0):
        if mode not in _ADAPTIVE:
            return split0
        gammas, keeps = step_sizes(iters, t0, split0.device)
        split = split0
        for i in range(iters):
            rho = loads(split, demand)
            split = _fma(keeps[i], split, gammas[i] * fw_target(split, rho))
        return split

    def equilibrate_traced(split0, demand, iters: int, t0: float = 0.0):
        """`equilibrate` with per-iteration telemetry: returns (split,
        (gap [..., iters], max_util [..., iters], gamma [..., iters])).
        The same per-step arithmetic, so the split is bit-identical to
        `equilibrate`'s; the gap is one more reduction of the cost the step
        computes anyway.  Samples are written into preallocated device
        tensors: nothing is read back on the host.  Oblivious modes return
        their fixed point with one zero-gap sample."""
        batch = split0.shape[:-2]
        if mode not in _ADAPTIVE:
            mu = _max_util(loads(split0, demand), num_links).to(dtype)
            z = mu.new_zeros(batch + (1,))
            return split0, (z, mu[..., None], z)
        gammas, keeps = step_sizes(iters, t0, split0.device)
        gaps = split0.new_empty(batch + (iters,))
        mus = split0.new_empty(batch + (iters,))
        split = split0
        for i in range(iters):
            rho = loads(split, demand)
            cost = cost_of(rho)
            target = target_of(split, rho,
                               torch.where(valid, cost, float("inf")))
            gaps[..., i] = gap_of(split, target, cost, demand)
            mus[..., i] = _max_util(rho, num_links)
            split = _fma(keeps[i], split, gammas[i] * target)
        return split, (gaps, mus, gammas.expand(batch + (iters,)))

    # fp64 certification chases much smaller gaps and digs a deeper
    # bracket first (`_line_search`)
    ls_halvings = 20 if dtype == torch.float64 else 10

    def cert_equilibrate(split0, demand, max_iters: int, util_tol,
                         t0: float = 0.0, decide_at=None,
                         trace_cap: int = 0):
        batch = split0.shape[:-2]
        dev = split0.device

        def per_link(x):  # a per-load value against [..., E]
            return x[..., None]

        def per_path(x):  # a per-load value against [..., F, K]
            return x[..., None, None]

        def trace_init():
            if not trace_cap:
                return ()
            nan = torch.full(batch + (trace_cap,), float("nan"), dtype=dtype,
                             device=dev)
            return (torch.zeros(batch + (trace_cap,), dtype=torch.int32,
                                device=dev), nan, nan, nan, nan, nan,
                    torch.zeros(batch, dtype=torch.int32, device=dev))

        def trace_rec(tr, t_next, gap, rho, mu_lb, mu_ub, glast):
            # samples land in fixed-size buffers at index `count` -- no
            # host reads, no dynamic shapes; the valid prefix length rides
            # along as `count` and the host trims after the solve
            if not trace_cap:
                return tr
            titer, tgap, tmu, tlb, tub, tgm, cnt = tr
            idx = cnt.clamp_max(trace_cap - 1).long()[..., None]

            def put(buf, v):
                return buf.scatter(-1, idx, v.to(buf.dtype)[..., None])

            return (put(titer, t_next), put(tgap, gap),
                    put(tmu, _max_util(rho, num_links)), put(tlb, mu_lb),
                    put(tub, mu_ub), put(tgm, glast), cnt + 1)

        zeros_t = torch.zeros(batch, dtype=torch.int32, device=dev)
        rho0 = loads(split0, demand)
        if mode not in _ADAPTIVE:
            mu0 = _max_util(rho0, num_links).to(dtype)
            z = torch.zeros_like(mu0)
            return (split0, rho0, z, mu0, mu0, zeros_t,
                    torch.ones(batch, dtype=torch.bool, device=dev),
                    trace_rec(trace_init(), zeros_t, z, rho0, mu0, mu0, z))

        def residual(split, rho):
            cost = cost_of(rho)
            target = target_of(split, rho,
                               torch.where(valid, cost, float("inf")))
            return gap_of(split, target, cost, demand)

        def step_ugal(state, _gamma):
            # conjugate Frank-Wolfe (Mitradjieva-Lindberg CFW): combine the
            # previous combined target with the fresh best response so that
            # successive search directions are conjugate w.r.t. the diagonal
            # Beckmann Hessian in load space, then take an exact line-search
            # step
            split, rho, sbar, rbar, _g = state
            cost = cost_of(rho)
            target = target_of(split, rho,
                               torch.where(valid, cost, float("inf")))
            rho_t = loads(target, demand)
            h = _queue_delay_prime(rho)
            a = rbar - rho
            b = rho_t - rho
            bha = (b * h * a).sum(dim=-1)
            aha = (a * h * a).sum(dim=-1)
            beta = bha / (bha - aha)
            beta = torch.where(torch.isfinite(beta), beta, 0.0).clamp(
                0.0, 0.999)
            r_comb = per_link(beta) * rbar + per_link(1 - beta) * rho_t
            # keep it a descent direction; plain FW direction otherwise
            desc = ((r_comb - rho) * (1.0 + _queue_delay(rho))).sum(
                dim=-1) < 0
            beta = torch.where(desc, beta, 0.0)
            s_comb = per_path(beta) * sbar + per_path(1 - beta) * target
            r_comb = per_link(beta) * rbar + per_link(1 - beta) * rho_t
            gamma = _line_search(rho, r_comb - rho, ls_halvings)
            # loads are linear in the split, so rho tracks incrementally
            return (split + per_path(gamma) * (s_comb - split),
                    rho + per_link(gamma) * (r_comb - rho), s_comb, r_comb,
                    gamma)

        def step_pf(state, gamma):
            # UGAL_PF's gated target is not a linear-minimization oracle
            # (the residual can be negative), so line search on the
            # potential is meaningless: keep the harmonic schedule and let
            # the residual be the stopping/early-exit signal
            split, rho, sbar, rbar, _g = state
            target = fw_target(split, rho)
            return (split + gamma * (target - split),
                    rho + gamma * (loads(target, demand) - rho),
                    sbar, rbar, gamma.expand(batch))

        step = step_ugal if mode == "ugal" else step_pf
        traversals = (demand * lmax.to(dtype)).sum(dim=-1)

        def done_of(gap, rho):
            # abs: the gated-residual mode's gap can go negative
            resid = gap.abs()
            mu_lb, mu_ub = _util_interval(rho, resid, num_links)
            # Phi(rho) - gap lower-bounds Phi*; the mass bound turns that
            # into the infeasible-side certificate the Bregman bracket
            # cannot provide (see _phi_mass_lower_bound)
            phi = (rho + _w_integral(rho)).sum(dim=-1)
            mu_lb = torch.maximum(
                mu_lb, _phi_mass_lower_bound(phi - resid, traversals))
            done = (mu_ub - mu_lb) <= util_tol
            if decide_at is not None:
                done = done | (mu_ub <= decide_at) | (mu_lb > decide_at)
            return mu_lb, mu_ub, done

        def chunk(carry, t_host):
            state, _gap, _brk, t, _done, tr = carry
            gammas, _ = step_sizes(_CERT_STRIDE, t0 + t_host, dev)
            for j in range(_CERT_STRIDE):
                state = step(state, gammas[j])
            split, _rho_inc, sbar, rbar, glast = state
            rho = loads(split, demand)  # shed incremental-update rounding
            gap = residual(split, rho)
            mu_lb, mu_ub, done = done_of(gap, rho)
            tr = trace_rec(tr, t + _CERT_STRIDE, gap, rho, mu_lb, mu_ub,
                           glast)
            return ((split, rho, sbar, rbar, glast), gap, (mu_lb, mu_ub),
                    t + _CERT_STRIDE, done, tr)

        gap0 = residual(split0, rho0)
        lb0, ub0, done0 = done_of(gap0, rho0)
        z = torch.zeros(batch, dtype=dtype, device=dev)
        tr0 = trace_rec(trace_init(), zeros_t, gap0, rho0, lb0, ub0, z)
        # sbar = split0 makes the first conjugate combination degenerate
        # (a = 0 -> beta guarded to 0), i.e. a plain FW first step
        carry = ((split0, rho0, split0, rho0, z), gap0, (lb0, ub0), zeros_t,
                 done0, tr0)
        # every running load has stepped t_host times: the step sizes and
        # the budget test need no read of the device's counter
        t_host = 0
        while t_host < max_iters:
            running = ~carry[4]
            if not bool(running.any()):  # reprolint-torch: allow[host-sync] -- the one host read per 32-step chunk: the certified loop stops once every load is decided
                break
            new = chunk(carry, t_host)
            carry = _where_tree(running, new, carry) if batch else new
            t_host += _CERT_STRIDE
        (split, rho, _sb, _rb, _g), gap, (mu_lb, mu_ub), t, done, tr = carry
        return split, rho, gap, mu_lb, mu_ub, t, done, tr

    init = minvec if mode in ("min", "ugal", "ugal_pf") else uniform
    return _FWPieces(init, equilibrate, loads, cost_of, fw_target, target_of,
                     gap_of, cert_equilibrate, equilibrate_traced)


def _pieces(fp: FlowPaths, dev: torch.device,
            dtype: torch.dtype = torch.float32):
    """(`_fw_pieces` in `dtype`, demand [F] in `dtype`, valid, hops) on
    `dev`.  The uncertified engines take the float32 default; demand is
    float32 from `device_arrays` and cast for a float64 certification, as
    the reference's ``demand.astype(dt)``."""
    eidx, loads_rep, valid, is_min, first_edge, demand, hops = \
        fp.device_arrays(dev)
    fw = _fw_pieces(eidx, loads_rep, valid, is_min, first_edge, fp.num_links,
                    fp.mode, dtype=dtype)
    return fw, demand.to(dtype), valid, hops


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
                 dev: torch.device, trace: bool = False):
    """The cold-start equilibrium at every offered load at once, along a
    leading load dimension (the reference's vmap).  With `trace=True` the
    metrics tuple also carries the per-iteration (gap, max_util, gamma)
    samples, each [P, iters]."""
    fw, demand, valid, hops = _pieces(fp, dev)
    d = demand * offered_vec[:, None]  # [P, F]
    split0 = fw.init.expand(len(offered_vec), -1, -1)
    if trace:
        split, ys = fw.equilibrate_traced(split0, d, iters)
    else:
        split = fw.equilibrate(split0, d, iters)
    rho = fw.loads(split, d)
    m = _metrics(split, rho, fw.cost_of(rho), valid, hops, demand,
                 offered_vec, fp.num_links)
    return m + (ys,) if trace else m


def _solve_traced(fp: FlowPaths, offered: float, iters: int,
                  dev: torch.device):
    """`_solve` with per-iteration telemetry: (split, rho, cost,
    (gap, max_util, gamma))."""
    fw, demand, _, _ = _pieces(fp, dev)
    demand = demand * offered
    split, ys = fw.equilibrate_traced(fw.init, demand, iters)
    rho = fw.loads(split, demand)
    return split, rho, fw.cost_of(rho), ys


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


def _saturation_batch_traced(fp: FlowPaths, iters: int,
                             probe_schedule: tuple, dev: torch.device):
    """`_saturation_batch` with per-iteration telemetry on every probe.

    The same probe sequence and per-step arithmetic (each probe runs
    `equilibrate_traced` instead of `equilibrate`); returns (sat, traces,
    brackets) where `traces` is one (gap, max_util, gamma) tuple per probe
    (their lengths follow `probe_schedule`) and `brackets` is
    [probes + 1, 4] rows (offered, feasible, lo, hi) after each probe.
    Nothing is read back on the host.
    """
    fw, demand, _, _ = _pieces(fp, dev)
    split, ys0 = fw.equilibrate_traced(fw.init, demand, iters)
    max1 = _max_util(fw.loads(split, demand), fp.num_links)

    one = torch.ones((), dtype=torch.float32, device=dev)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = one
    yss = [ys0]
    brs = [(one, (max1 <= 1.0).to(torch.float32), lo, hi)]
    for probe_iters in probe_schedule:
        mid = 0.5 * (lo + hi)
        d = demand * mid
        split, ys = fw.equilibrate_traced(split, d, probe_iters, t0=_WARM_T0)
        feasible = _max_util(fw.loads(split, d), fp.num_links) <= 1.0
        lo = torch.where(feasible, mid, lo)
        hi = torch.where(feasible, hi, mid)
        yss.append(ys)
        brs.append((mid, feasible.to(torch.float32), lo, hi))
    sat = torch.where(max1 <= 1.0, one, lo)
    brackets = torch.stack([torch.stack(b) for b in brs])
    return sat, tuple(yss), brackets


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
        split = _fma(keeps[i], split, gammas[i] * fw.fw_target(split, rho))
        acc = acc + rho
    # the reference divides by the constant as a product with its
    # reciprocal, contracted with the difference into one FMA
    recip = torch.ones((), dtype=acc.dtype, device=dev) / iters
    return _fma(acc, -recip, fw.loads(split, d)).abs().max()


def _certified_solve(fp: FlowPaths, offered: float, util_tol: float,
                     max_iters: int, dtype: str, trace_cap: int,
                     dev: torch.device):
    """Single-load certified solve: metrics + (gap, mu_lb, mu_ub, iters,
    converged, trace)."""
    dt = _DTYPES[dtype]
    fw, dbase, valid, hops = _pieces(fp, dev, dt)
    d = dbase * offered
    split, rho, gap, mu_lb, mu_ub, iters, ok, tr = fw.cert_equilibrate(
        fw.init, d, max_iters, util_tol, trace_cap=trace_cap)
    off = torch.full((1,), offered, dtype=dt, device=dev)
    metrics = _metrics(split[None], rho[None], fw.cost_of(rho)[None], valid,
                       hops, dbase, off, fp.num_links)
    return tuple(m[0] for m in metrics) + (gap, mu_lb, mu_ub, iters, ok, tr)


def _certified_batch(fp: FlowPaths, offered_vec: torch.Tensor,
                     util_tol: float, max_iters: int, dtype: str,
                     trace_cap: int, dev: torch.device):
    """The certified equilibrium at every offered load at once, along a
    leading load dimension, with the reference's vmapped while-loop
    semantics: every load steps together, a load that is done keeps its
    carry and its iteration count, and the loop ends when no load runs."""
    fw, dbase, valid, hops = _pieces(fp, dev, _DTYPES[dtype])
    d = dbase * offered_vec[:, None]
    split0 = fw.init.expand(len(offered_vec), -1, -1)
    split, rho, gap, mu_lb, mu_ub, iters, ok, tr = fw.cert_equilibrate(
        split0, d, max_iters, util_tol, trace_cap=trace_cap)
    m = _metrics(split, rho, fw.cost_of(rho), valid, hops, dbase,
                 offered_vec, fp.num_links)
    return m + (gap, mu_lb, mu_ub, iters, ok, tr)


def _certified_saturation(fp: FlowPaths, util_tol: float, max_iters: int,
                          probes: int, dtype: str, trace_cap: int,
                          dev: torch.device):
    """Certified saturation bisection with gap early-exit probes.

    The probe sequence of `_saturation_batch` (offered = 1.0 first, then
    `probes` bisection steps over [0, 1], each warm-started from the
    previous probe's split at `_WARM_T0`), but every probe runs
    `cert_equilibrate` with `decide_at=1.0`: it stops as soon as the gap's
    utilization bracket certifies the probe's feasibility either way.
    Alongside the bisection's measured (lo, hi) it narrows a *certified*
    bracket: `lo_c` rises only on certified-feasible probes and `hi_c`
    falls only on certified-infeasible ones.  Every probe runs, as in the
    reference's unrolled loop, also when offered = 1.0 is feasible.

    Returns (sat, lo_c, hi_c, gap, mu_lb, mu_ub, total_iters,
    all_converged, traces, brackets) with gap / bracket from the final
    probe.  With `trace_cap > 0`, `traces` stacks each probe's sample
    buffers along a leading [probes + 1] axis and `brackets` is
    [probes + 1, 4] rows (offered, feasible, lo, hi) after each probe;
    both are `()` when tracing is off.
    """
    dt = _DTYPES[dtype]
    fw, d1, _, _ = _pieces(fp, dev, dt)
    split, rho, gap, mu_lb, mu_ub, it, ok, tr = fw.cert_equilibrate(
        fw.init, d1, max_iters, util_tol, decide_at=1.0,
        trace_cap=trace_cap)
    mu1 = _max_util(rho, fp.num_links)
    total = it
    all_ok = ok

    one = torch.ones((), dtype=dt, device=dev)
    lo, hi = torch.zeros_like(one), one
    lo_c = torch.where(mu_ub <= 1.0, one, torch.zeros_like(one))
    hi_c = one
    trs = [tr]
    brs = [(one, (mu1 <= 1.0).to(dt), lo, hi)]
    for _ in range(probes):
        mid = 0.5 * (lo + hi)
        dd = d1 * mid
        split, rho, gap, mu_lb, mu_ub, it, ok, tr = fw.cert_equilibrate(
            split, dd, max_iters, util_tol, t0=_WARM_T0, decide_at=1.0,
            trace_cap=trace_cap)
        feasible = _max_util(rho, fp.num_links) <= 1.0
        lo = torch.where(feasible, mid, lo)
        hi = torch.where(feasible, hi, mid)
        lo_c = torch.where(mu_ub <= 1.0, torch.maximum(lo_c, mid), lo_c)
        hi_c = torch.where(mu_lb > 1.0, torch.minimum(hi_c, mid), hi_c)
        total = total + it
        all_ok = all_ok & ok
        trs.append(tr)
        brs.append((mid, feasible.to(dt), lo, hi))
    sat = torch.where(mu1 <= 1.0, one, lo)
    if trace_cap:
        traces = tuple(torch.stack(parts) for parts in zip(*trs))
        brackets = torch.stack([torch.stack(b) for b in brs])
    else:
        traces, brackets = (), ()
    return (sat, lo_c, hi_c, gap, mu_lb, mu_ub, total, all_ok,
            traces, brackets)


def _cert_params(mode: str, util_tol, dtype, iters: int, cert_iters):
    """Resolve the certify=True knobs: (dtype, util_tol, max_iters, kind).
    `dtype` is "float32" (the default) or "float64"; anything else raises.
    The default `util_tol` tightens 0.05 -> 0.01 in float64, which can
    resolve the smaller duality gaps the tighter bracket needs (the fp32
    gap's noise floor is an inner-product cancellation, ~1e-3 * total
    demand).  The reference gates float64 on JAX_ENABLE_X64; PyTorch needs
    no such switch, so float64 simply runs."""
    if dtype is None:
        dtype = "float32"
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported certification dtype {dtype!r}")
    if util_tol is None:
        util_tol = 0.01 if dtype == "float64" else 0.05
    max_iters = int(cert_iters) if cert_iters is not None \
        else max(int(iters), 2000)
    kind = {"ugal": "duality-gap", "ugal_pf": "gated-residual"}.get(
        mode, "exact")
    return dtype, float(util_tol), max_iters, kind


def _certificate(gap, mu_lb, mu_ub, iters, ok, util_tol, dtype, kind):
    lb, ub = float(mu_lb), float(mu_ub)
    return Certificate(gap=float(gap), util_lb=lb, util_ub=ub,
                       util_err_bound=ub - lb, util_tol=util_tol,
                       iters=int(iters), dtype=dtype, converged=bool(ok),
                       kind=kind)


def _cert_trace(mode, kind, tr, brackets=None):
    """Host-side `ConvergenceTrace` from `cert_equilibrate` buffers.

    `tr` is one trace tuple (single solve) or the stacked [P+1, cap]
    form from `_certified_saturation`; each probe's valid prefix is
    trimmed by its `cnt` and the iteration axis is made cumulative
    across probes."""
    titer, tgap, tmu, tlb, tub, tgm, cnt = (np.asarray(x) for x in tr)  # reprolint-torch: allow[host-sync] -- tr holds the numpy copies `_host` made after the solve
    if titer.ndim == 1:
        titer, tgap, tmu, tlb, tub, tgm = (
            a[None] for a in (titer, tgap, tmu, tlb, tub, tgm))
        cnt = np.asarray([cnt])
    rows = []
    offset = 0
    for p in range(titer.shape[0]):
        n = int(cnt[p])
        it = offset + titer[p, :n].astype(np.int64)
        rows.append((np.full(n, p, np.int64), it, tgap[p, :n], tmu[p, :n],
                     tlb[p, :n], tub[p, :n], tgm[p, :n]))
        if n:
            offset = int(it[-1])
    probe, iters, gap, mu, lb, ub, gm = (
        np.concatenate(cols) for cols in zip(*rows))
    br = np.asarray(brackets, np.float64) if brackets is not None \
        else np.zeros((0, 4))
    return ConvergenceTrace(mode=mode, kind=kind, stride=_CERT_STRIDE,
                            iters=iters, gap=gap, max_util=mu, util_lb=lb,
                            util_ub=ub, step_size=gm, probe=probe,
                            brackets=br)


def _fw_trace(mode, yss, brackets=None):
    """Host-side `ConvergenceTrace` from `equilibrate_traced` outputs
    (one (gap, max_util, gamma) tuple per probe; stride-1 samples, NaN
    certified bounds -- these runs carry no certificate)."""
    rows = []
    offset = 0
    for p, ys in enumerate(yss):
        gap, mu, gm = (np.asarray(a, np.float64) for a in ys)  # reprolint-torch: allow[host-sync] -- ys holds the numpy copies `_host` made after the solve
        n = gap.shape[0]
        nan = np.full(n, np.nan)
        rows.append((np.full(n, p, np.int64),
                     offset + np.arange(n, dtype=np.int64),
                     gap, mu, nan, nan, gm))
        offset += n
    probe, iters, gap, mu, lb, ub, gm = (
        np.concatenate(cols) for cols in zip(*rows))
    br = np.asarray(brackets, np.float64) if brackets is not None \
        else np.zeros((0, 4))
    return ConvergenceTrace(mode=mode, kind="uncertified", stride=1,
                            iters=iters, gap=gap, max_util=mu, util_lb=lb,
                            util_ub=ub, step_size=gm, probe=probe,
                            brackets=br)


def _host(x):
    """Numpy copies of every tensor in a nested tuple (after the solve)."""
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    return x.detach().cpu().numpy()


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
                  certify: bool = False, util_tol: float = None,
                  dtype: str = None, cert_iters: int = None,
                  trace: bool = False, device="cuda"):
    """FluidResult at one offered load, solved on `device`; with
    `certify=True`, a `CertifiedResult` wrapping the FluidResult whose
    certificate bounds the reported utilizations' distance from the exact
    equilibrium (gap-driven line-search Frank-Wolfe instead of a fixed
    `iters` budget; `cert_iters` caps the certified run, default
    max(iters, 2000); `util_tol` and `dtype` as in `_cert_params`).

    With `trace=True` the result additionally carries a
    `repro_torch.obs.trace.ConvergenceTrace` in its `trace` field:
    per-stride (certified) or per-iteration (uncertified) duality gap,
    step size and max utilization, kept on the device during the solve.

    The parameters are the reference's, in its order, with `device` last.
    """
    fp = _as_flow_paths(fp)
    dev = resolve_device(device)
    rec = get_recorder()
    if certify:
        dtype, util_tol, max_iters, kind = _cert_params(
            fp.mode, util_tol, dtype, iters, cert_iters)
        trace_cap = (max_iters // _CERT_STRIDE + 2) if trace else 0
        with rec.span("fluid.evaluate_load", mode=fp.mode, certify=True,
                      offered=float(offered)) as sp:
            out = sp.sync(_certified_solve(fp, float(offered), util_tol,
                                           max_iters, dtype, trace_cap, dev))
        acc, mu, lat, hop, gap, mu_lb, mu_ub, it, ok, tr = _host(out)
        res = FluidResult(offered=float(offered), accepted=float(acc),
                          max_util=float(mu), mean_latency=float(lat),
                          mean_hops=float(hop))
        return CertifiedResult(
            value=res,
            cert=_certificate(gap, mu_lb, mu_ub, it, ok, util_tol, dtype,
                              kind),
            trace=_cert_trace(fp.mode, kind, tr) if trace else None)
    with rec.span("fluid.evaluate_load", mode=fp.mode,
                  offered=float(offered)) as sp:
        if trace:
            split, rho, cost, ys = _host(sp.sync(
                _solve_traced(fp, float(offered), iters, dev)))
        else:
            split, rho, cost = _host(sp.sync(
                _solve(fp, float(offered), iters, dev)))
    max_util = float(rho.max()) if len(rho) else 0.0
    demand = fp.pattern.demand * offered
    wsum = (split * np.where(fp.valid, cost, 0.0)).sum(axis=1)
    lat = float((demand * wsum).sum() / max(demand.sum(), _EPS))
    hops = float((demand * (split * fp.hops).sum(axis=1)).sum()
                 / max(demand.sum(), _EPS))
    accepted = offered * min(1.0, 1.0 / max(max_util, _EPS))
    return FluidResult(offered=float(offered), accepted=float(accepted),
                       max_util=max_util, mean_latency=lat, mean_hops=hops,
                       trace=_fw_trace(fp.mode, [ys]) if trace else None)


def saturation_throughput(fp, tol: float = 0.005, iters: int = 250,
                          engine: str = "batched", probe_iters: int = 0,
                          return_info: bool = False, certify: bool = False,
                          util_tol: float = None, dtype: str = None,
                          cert_iters: int = None, trace: bool = False,
                          device="cuda"):
    """Largest per-endpoint offered load with max link utilization <= 1
    (bisection; adaptive splits re-equilibrate at every probe), solved on
    `device`.  `fp` is a FlowPaths or a sequence of FlowPaths chunks.

    engine="batched" (default) runs the bisection with warm-started probes
    and reads one value back at the end; engine="scalar" is the per-probe
    reference.  `probe_iters` (batched only) fixes every warm probe's
    Frank-Wolfe step count; 0 picks the default front-loaded schedule
    (`_probe_schedule`).  With `return_info=True` the result is a
    `SaturationResult` that also carries `truncation_error` at the returned
    load.

    With `certify=True` the result is a `CertifiedResult`: the bisection
    runs gap-driven probes that stop on certified feasibility decisions
    (`_certified_saturation`), `value` is the saturation float and
    `[sat_lo, sat_hi]` the certified bracket.  `util_tol` / `dtype` /
    `cert_iters` are the certification knobs (`_cert_params`); `certify`
    supersedes `return_info` (asking for both raises) and `probe_iters`.

    With `trace=True` (batched or certified engines) the result carries a
    `ConvergenceTrace` covering every bisection probe -- per-probe gap /
    step-size / max-util samples plus a bracket row per probe -- and the
    uncertified return type becomes `SaturationResult` (its
    `truncation_err` is NaN unless `return_info` also asked for it).

    The parameters are the reference's, in its order, with `device` last.
    """
    fp = _as_flow_paths(fp)
    dev = resolve_device(device)
    rec = get_recorder()
    if certify:
        if return_info:
            raise ValueError("return_info is subsumed by certify=True: the "
                             "certificate's gap bounds the truncation error")
        dtype, util_tol, max_iters, kind = _cert_params(
            fp.mode, util_tol, dtype, iters, cert_iters)
        trace_cap = (max_iters // _CERT_STRIDE + 2) if trace else 0
        probes = max(1, int(np.ceil(np.log2(1.0 / tol))))
        with rec.span("fluid.saturation_throughput", mode=fp.mode,
                      certify=True, probes=probes) as sp:
            out = sp.sync(_certified_saturation(
                fp, util_tol, max_iters, probes, dtype, trace_cap, dev))
        sat, lo_c, hi_c, gap, mu_lb, mu_ub, total_it, ok, trs, brs = \
            _host(out)
        return CertifiedResult(
            value=float(sat),
            cert=_certificate(gap, mu_lb, mu_ub, total_it, ok, util_tol,
                              dtype, kind),
            sat_lo=float(lo_c), sat_hi=float(hi_c),
            trace=_cert_trace(fp.mode, kind, trs, brs) if trace else None)
    tr = None
    if engine == "batched":
        probes = max(1, int(np.ceil(np.log2(1.0 / tol))))
        sched = ((probe_iters,) * probes if probe_iters > 0
                 else _probe_schedule(iters, probes))
        with rec.span("fluid.saturation_throughput", mode=fp.mode,
                      probes=probes) as sp:
            if trace:
                sat, yss, brs = _host(sp.sync(
                    _saturation_batch_traced(fp, iters, sched, dev)))
                sat = float(sat)
                tr = _fw_trace(fp.mode, yss, brs)
            else:
                sat = float(sp.sync(_saturation_batch(fp, iters, sched,
                                                      dev)))
    elif engine != "scalar":
        raise ValueError(f"unknown engine {engine!r}")
    elif trace:
        raise ValueError("trace=True needs engine='batched' or "
                         "certify=True (the scalar reference solves each "
                         "probe on its own and keeps no trace buffers)")
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
    if not (return_info or trace):
        return sat
    terr = truncation_error(fp, sat, iters, device=dev) if return_info \
        else float("nan")
    return SaturationResult(saturation=sat, truncation_err=terr, trace=tr)


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


def latency_curve(fp, loads, iters: int = 250, engine: str = "batched",  # reprolint-torch: allow[host-sync] -- host assembly: its loops run over the caller's loads and the numpy copies `_host` made after the one device call
                  certify: bool = False, util_tol: float = None,
                  dtype: str = None, cert_iters: int = None,
                  trace: bool = False, device="cuda"):
    """FluidResult per offered load, solved on `device`.  engine="batched"
    (default) solves every load at once along a leading load dimension;
    engine="scalar" calls `evaluate_load` per load (the reference).  With
    `certify=True`, one batched certified solve returning a
    `CertifiedResult` per load (each wrapping its FluidResult, with a
    per-load certificate; `_certified_batch`).  With `trace=True`, each
    result carries its own per-load `ConvergenceTrace`.

    The parameters are the reference's, in its order, with `device` last.
    """
    fp = _as_flow_paths(fp)
    dev = resolve_device(device)
    rec = get_recorder()
    loads = [float(l) for l in loads]
    if certify:
        dtype, util_tol, max_iters, kind = _cert_params(
            fp.mode, util_tol, dtype, iters, cert_iters)
        trace_cap = (max_iters // _CERT_STRIDE + 2) if trace else 0
        vec = torch.tensor(loads, dtype=_DTYPES[dtype], device=dev)
        with rec.span("fluid.latency_curve", mode=fp.mode, certify=True,
                      points=len(loads)) as sp:
            out = sp.sync(_certified_batch(fp, vec, util_tol, max_iters,
                                           dtype, trace_cap, dev))
        acc, mx, lat, hop, gap, mu_lb, mu_ub, it, ok, tr = _host(out)
        traces = [_cert_trace(fp.mode, kind, tuple(p[i] for p in tr))
                  if trace else None for i in range(len(loads))]
        return [CertifiedResult(
                    value=FluidResult(offered=l, accepted=float(a),
                                      max_util=float(m),
                                      mean_latency=float(la),
                                      mean_hops=float(h)),
                    cert=_certificate(g, lb, ub, i, o, util_tol, dtype, kind),
                    trace=t)
                for l, a, m, la, h, g, lb, ub, i, o, t in zip(
                    loads, acc, mx, lat, hop, gap, mu_lb, mu_ub, it, ok,
                    traces)]
    if engine == "batched":
        vec = torch.tensor(loads, dtype=torch.float32, device=dev)
        with rec.span("fluid.latency_curve", mode=fp.mode,
                      points=len(loads)) as sp:
            out = _host(sp.sync(_solve_batch(fp, vec, iters, dev, trace)))
        if trace:
            acc, mx, lat, hop, (g, mu, gm) = out
            traces = [_fw_trace(fp.mode, [(g[i], mu[i], gm[i])])
                      for i in range(len(loads))]
        else:
            acc, mx, lat, hop = out
            traces = [None] * len(loads)
        return [FluidResult(offered=l, accepted=float(a), max_util=float(m),
                            mean_latency=float(la), mean_hops=float(h),
                            trace=t)
                for l, a, m, la, h, t in zip(loads, acc, mx, lat, hop,
                                             traces)]
    if engine != "scalar":
        raise ValueError(f"unknown engine {engine!r}")
    return [evaluate_load(fp, l, iters, trace=trace, device=dev)
            for l in loads]
