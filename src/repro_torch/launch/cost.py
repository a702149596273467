"""Per-device cost of one traced call, for the roofline analysis.

The port's counterpart of the JAX package's ``launch/hlo.py``.  That
module parses XLA's post-optimization HLO text, because a compiled JAX
step is one program whose loops run many times.  The port has no HLO: a
PyTorch step runs eagerly, op by op, so one call is traced as it runs,
under a ``TorchDispatchMode`` (`CostMode`), and every op is counted as
often as it runs (no loop trip counts to recover: `unknown_trip_loops`
is always 0).  It accumulates, as the reference does:

  * GEMM FLOPs and GEMM memory traffic (lhs + rhs + out bytes) of the
    matrix-product aten ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``dot``; ``matmul``, ``einsum`` and ``linear`` decompose into
    these, under ``inference_mode`` too) at
    the **local** shapes: a DTensor op is left to DTensor (the mode
    returns NotImplemented), which runs it as local ops on each rank's
    shards, and those are what is counted -- counting the DTensor op
    itself would give the whole mesh's work;
  * the hand-written flash-attention kernels from their launch shapes
    (`kernels.flash_attention.ops.OBSERVERS`: a ctypes launch is no aten
    op), forward ``4 B Hq S S D`` and backward ``8 B Hq S S D`` FLOPs,
    the dots of plain attention (QK^T, PV; dP, dV, dQ, dK) over the whole
    S x S as the reference's dot count has them, masked pairs included;
  * collective wire bytes of the ``_c10d_functional`` collectives under
    the reference's ring accounting, unchanged:
      all-reduce  2 S (g-1)/g   | all-gather S (g-1)/g | reduce-scatter S (g-1)
      all-to-all  S (g-1)/g     | collective-permute S
    (S = per-device result bytes, g = the process group's size).

``dot_bytes_flash`` keeps its meaning: attention streams Q, K, V and O
(and dO, dQ, dK, dV in the backward) and never the scores.  The kernels
count so in it, and in ``dot_bytes`` as plain attention's dots would
move them (the float32 scores written and read once by each dot).  A
batched product (``bmm``/``baddbmm``) whose output or operand is
logits-shaped (last dim >= `seq_threshold`) -- plain attention on the
CPU -- counts only its streaming operands there, the reference's rule.
``total_wire_bytes_bf16`` counts float32 collectives at half their bytes
(the reference's, for XLA's CPU upcasts; here a float32 collective is
float32 on the card too, so it reads as "if it ran in bf16").
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
import traceback
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor as _DTensor

from ..parallel.compat import (TorchDispatchMode, active_fake_mode,
                               current_autograd_node, process_group_size)

__all__ = ["ModuleCost", "CostMode", "trace_cost", "ring_wire_bytes",
           "flash_cost"]

# bytes per element by torch dtype (the reference's _DTYPE_BYTES by name)
_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.bfloat16: 2, torch.float16: 2,
    torch.int32: 4, torch.float32: 4, torch.int64: 8, torch.float64: 8,
    torch.complex64: 8, torch.complex128: 16,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(t.dtype, 4)


def ring_wire_bytes(kind: str, size: float, g: int) -> float:
    """Wire bytes of one collective of `kind` with per-device result
    bytes `size` in a group of `g` (the reference's ring accounting)."""
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if kind == "all-gather":
        return size * (g - 1) / g
    if kind == "reduce-scatter":
        return float(size) * (g - 1)
    if kind == "all-to-all":
        return size * (g - 1) / g
    if kind == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class ModuleCost:
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    # dot_bytes with attention-score traffic removed (module docstring)
    dot_bytes_flash: float = 0.0
    coll_counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    coll_wire_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    coll_result_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # wire bytes if float32 collectives ran in bf16
    coll_wire_bytes_bf16: float = 0.0
    unknown_trip_loops: int = 0
    # hand-written kernel calls by route, from their launch shapes
    kernel_calls: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.coll_wire_bytes.values()))

    @property
    def total_wire_bytes_bf16(self) -> float:
        return float(self.coll_wire_bytes_bf16)

    def summary(self) -> Dict:
        return {
            "dot_flops": self.dot_flops,
            "dot_bytes": self.dot_bytes,
            "dot_bytes_flash": self.dot_bytes_flash,
            "collective_counts": dict(self.coll_counts),
            "collective_wire_bytes": {k: float(v) for k, v in self.coll_wire_bytes.items()},
            "total_wire_bytes": self.total_wire_bytes,
            "total_wire_bytes_bf16": self.total_wire_bytes_bf16,
            "unknown_trip_loops": self.unknown_trip_loops,
        }

    def add_collective(self, kind: str, size: float, g: int,
                       dtype: torch.dtype, times: int = 1) -> None:
        wire = ring_wire_bytes(kind, size, g)
        self.coll_counts[kind] += times
        self.coll_result_bytes[kind] += times * size
        self.coll_wire_bytes[kind] += times * wire
        self.coll_wire_bytes_bf16 += times * wire * (
            0.5 if dtype == torch.float32 else 1.0)


def flash_cost(route: str, q: torch.Tensor, k: torch.Tensor):
    """(flops, dot_bytes, dot_bytes_flash) of one flash-attention kernel
    call at its launch shapes q [B, Hq, S, D], k [B, Hkv, S, D]: the
    forward routes ("sm90", "simt") or the backward's ("bwd_sm90",
    "bwd")."""
    b, hq, s, d = q.shape
    qb, kb = _nbytes(q), _nbytes(k)
    scores = 4.0 * b * hq * s * s  # one float32 [B, Hq, S, S]
    if route.startswith("bwd"):
        flops = 8.0 * b * hq * s * s * d
        flash = 4 * qb + 4 * kb  # q, o, do in + dq out; k, v in + dk, dv out
        return flops, flash + 4 * scores, flash
    flops = 4.0 * b * hq * s * s * d
    flash = 2 * qb + 2 * kb  # q in, o out; k, v in
    return flops, flash + 2 * scores, flash


_GEMMS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot"}
_COMPOSITES = {"matmul", "einsum", "linear", "tensordot"}
_BATCHED = {"bmm", "baddbmm"}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _kind(func) -> str:
    """What `CostMode` counts an op as: "gemm", "collective", "alltoall",
    "composite" (decomposed first) or "other"."""
    ns, name = func.namespace, func.overloadpacket.__name__
    if ns == "aten" and name in _GEMMS:
        return "gemm"
    if ns == "aten" and name in _COMPOSITES:
        return "composite"
    if ns == "_c10d_functional":
        return "collective"
    if ns == "_dtensor" and name == "shard_dim_alltoall":
        return "alltoall"
    return "other"


class CostMode(TorchDispatchMode):
    """Counts a traced call into ``self.cost`` (a `ModuleCost`).

    `run`, if given, runs each op in place of calling it (the dry run's
    `dryrun.MetaCache`), and `observe` is called with each op and its
    result (the dry run's `memdebug.MemoryTrace`): one mode does the
    three, as a Python dispatch mode costs tens of microseconds an op."""

    def __init__(self, seq_threshold: int = 1024,
                 collectives: bool = False, run=None, observe=None):
        super().__init__()
        self._run = run
        self._observe = observe
        self.cost = ModuleCost()
        self.seq_threshold = seq_threshold
        self._fake = None
        # with `collectives`: one (kind, dtype[shape], g, wire bytes,
        # region) a collective, for `launch.collbreak`
        self.record = collectives
        self.rows: List[Tuple[str, str, int, float, str]] = []
        self._kinds: Dict = {}  # op -> what it counts as (`_kind`)

    def __enter__(self):
        # DTensor's sharding propagation may run ops under a fake mode of
        # its own to find output shapes: only ops under the fake mode (or
        # none) active at entry are the call's own
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _DTensor in types or any(issubclass(t, _DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops
        kwargs = kwargs or {}
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func)
        if kind == "composite":
            # under inference_mode these reach the mode whole: run their
            # decomposition here, so the products are counted as under
            # autograd (as torch's FlopCounterMode does)
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs) if self._run is None \
            else self._run(func, args, kwargs)
        if (kind == "other" and self._observe is None) \
                or active_fake_mode() is not self._fake:
            return out
        if self._observe is not None:
            self._observe(func, out)
        name = func.overloadpacket.__name__
        if kind == "gemm":
            self._gemm(name, args, out)
        elif kind == "collective":
            self._collective(name, args, out)
        elif kind == "alltoall":
            self._add("all-to-all", out, process_group_size(args[-1]))
        return out

    def _add(self, kind: str, out: torch.Tensor, g: int) -> None:
        self.cost.add_collective(kind, _nbytes(out), g, out.dtype)
        if self.record:
            self.rows.append((kind, f"{str(out.dtype)[6:]}{list(out.shape)}",
                              g, ring_wire_bytes(kind, _nbytes(out), g),
                              _region()))

    def _gemm(self, name: str, args, out: torch.Tensor) -> None:
        a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
            else (args[0], args[1])
        flops = 2.0 * out.numel() * a.shape[-1]
        lb, rb, ob = _nbytes(a), _nbytes(b), _nbytes(out)
        c = self.cost
        c.dot_flops += flops
        c.dot_bytes += lb + rb + ob
        if name in _BATCHED and out.shape[-1] >= self.seq_threshold:
            c.dot_bytes_flash += lb + rb      # QK^T: stream Q, K only
        elif name in _BATCHED and a.shape[-1] >= self.seq_threshold:
            c.dot_bytes_flash += rb + ob      # P V: stream V, O only
        elif name in _BATCHED and b.shape[-1] >= self.seq_threshold:
            c.dot_bytes_flash += lb + ob      # dP-style transposes
        else:
            c.dot_bytes_flash += lb + rb + ob

    def _collective(self, name: str, args, out) -> None:
        kind = _COLLECTIVES.get(name)
        if kind is None:  # wait_tensor, broadcast and the coalesced forms
            if name.endswith("_coalesced"):
                raise NotImplementedError(f"cost of {name} not counted")
            return
        group = args[-1]
        g = args[-2] if name in ("all_gather_into_tensor",
                                 "reduce_scatter_tensor") \
            else process_group_size(group)
        self._add(kind, out, int(g))

    def kernel(self, route: str, q: torch.Tensor, k: torch.Tensor,
               causal: bool, window: Optional[int]) -> None:
        """`kernels.flash_attention.ops`' observer."""
        flops, raw, flash = flash_cost(route, q, k)
        c = self.cost
        c.dot_flops += flops
        c.dot_bytes += raw
        c.dot_bytes_flash += flash
        c.kernel_calls[route] += 1


def _region() -> str:
    """Where a collective runs: "bwd:<autograd node>" inside the backward
    (autograd's engine runs it from C++), else "fwd:" or "opt/other:" and
    the port's innermost frame (the reference's op_name regions)."""
    node = current_autograd_node()
    if node is not None:
        return "bwd:" + node.name()
    for f in reversed(traceback.extract_stack(limit=64)):
        if "/repro_torch/" in f.filename and "/launch/" not in f.filename \
                and "/parallel/sharding" not in f.filename:
            name = f.filename.split("/repro_torch/", 1)[1]
            phase = "opt/other" if name.startswith("train/optimizer") \
                else "fwd"
            return f"{phase}:{name}:{f.lineno} {f.name}"
    return "opt/other:?"


@contextmanager
def trace_cost(seq_threshold: int = 1024, collectives: bool = False,
               run=None, observe=None) -> Iterator[CostMode]:
    """``with trace_cost() as mode:`` counts everything run inside into
    ``mode.cost`` (a `ModuleCost`), the flash kernels included; with
    `collectives` ``mode.rows`` lists every collective (`run`, `observe`:
    `CostMode`'s)."""
    from ..kernels.flash_attention import ops

    mode = CostMode(seq_threshold, collectives, run, observe)
    ops.OBSERVERS.append(mode.kernel)
    try:
        with mode:
            yield mode
    finally:
        ops.OBSERVERS.remove(mode.kernel)
