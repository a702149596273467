"""Structured tracing and metrics: spans, counters, and a trace Recorder.

This module is dependency-free (stdlib only; torch is imported lazily and
only inside :meth:`Span.sync`).  It gives the solver, the blockwise
executor, and the packet engine a shared vocabulary:

- **Spans** are nested wall-clock intervals.  A span's clock obeys the
  same discipline as ``benchmarks.common.timed``: asynchronous device
  work must be drained *before* the closing clock read, via an explicit
  :meth:`Span.sync` boundary (which calls ``torch.cuda.synchronize``).
  A span that never calls ``sync`` measures host wall time only.
- **Counters** accumulate (sum over the run); **gauges** keep the last
  value; **histograms** bin a batch of integer-valued samples;
  **series** store a (downsampled) time series such as a per-cycle
  occupancy trace.
- The :class:`Recorder` buffers everything as Chrome-trace events and
  dumps them as JSONL (one JSON event per line), the format the JAX
  package's ``repro.obs.report --to-chrome`` wraps for Perfetto.

The process-global default recorder is a :class:`NullRecorder` whose
spans are a single reusable no-op context manager — instrumented hot
paths pay only a ``get_recorder()`` attribute chase plus one virtual
call when tracing is off.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

__all__ = [
    "Recorder",
    "NullRecorder",
    "Span",
    "get_recorder",
    "set_recorder",
    "recording",
]


# The recorder owns the clock: span boundaries drain async device work
# first (Span.sync, same discipline common.timed encodes), so the read
# below is behind the sync boundary rather than racing it.
def _now() -> float:  # reprolint-torch: allow[naked-clock] -- recorder-internal clock; spans sync devices before the closing read
    return time.perf_counter()


class Span:
    """A live span handle.  Use via ``with recorder.span(name): ...``.

    ``sync(out)`` marks the explicit device-sync boundary: it blocks on
    the CUDA device that produced ``out`` and returns it, so the span's
    duration includes the device work that produced it.
    """

    __slots__ = ("_rec", "name", "args", "_t0")

    def __init__(self, rec: "Recorder", name: str, args: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.args = args
        self._t0 = 0.0

    def set(self, **attrs: Any) -> None:
        """Attach attributes to this span (rendered as Chrome-trace args)."""
        self.args.update(attrs)

    def sync(self, out: Any = None) -> Any:
        """Block until ``out`` is ready on device; returns ``out``.

        This is the explicit device-sync boundary: call it on the jitted
        result before the span closes so the measured duration covers
        the asynchronously dispatched work.
        """
        if out is not None:
            import torch

            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        return out

    def __enter__(self) -> "Span":
        self._t0 = self._rec._clock()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = self._rec._clock()
        self._rec._complete(self.name, self._t0, t1, self.args)
        return False


class _NullSpan:
    """Reusable no-op span; the default when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass

    def sync(self, out: Any = None) -> Any:
        return out


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """No-op recorder: every operation is a constant-time no-op.

    This is the process default so instrumented code needs no ``if``
    guards; the only cost on hot paths is one virtual call returning the
    shared no-op span.
    """

    __slots__ = ()

    def span(self, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def counter(self, name: str, value: float = 1.0, **args: Any) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def histogram(self, name: str, values: Sequence[int]) -> None:
        pass

    def series(self, name: str, values: Sequence[float], max_points: int = 512) -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def metrics(self) -> Dict[str, Any]:
        return {}

    def span_summary(self) -> Dict[str, Dict[str, float]]:
        return {}

    def summary(self) -> Dict[str, Any]:
        return {}

    def dump(self, path: str) -> None:
        pass


class Recorder:
    """Buffers trace events and aggregates metric tables.

    Events follow the Chrome trace event format (``ph`` codes): ``X``
    complete events for spans (``ts``/``dur`` in microseconds), ``C``
    counter events, and ``i`` instant events carrying histogram bins.
    ``dump`` writes one event per line (JSONL); the JAX package's ``repro.obs.report`` reads it
    for rendering and Perfetto conversion.

    ``clock`` is injectable for deterministic tests; it must be a
    monotonic float-seconds callable like ``time.perf_counter``.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock if clock is not None else _now
        self._t0 = self._clock()
        self._events: List[Dict[str, Any]] = []

    # -- event ingestion ------------------------------------------------

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _complete(self, name: str, t0: float, t1: float, args: Dict[str, Any]) -> None:
        self._events.append(
            {
                "name": name,
                "ph": "X",
                "ts": round(self._us(t0), 3),
                "dur": round((t1 - t0) * 1e6, 3),
                "pid": 1,
                "tid": 1,
                "args": dict(args),
            }
        )

    def span(self, name: str, **args: Any) -> Span:
        """Open a nested wall-clock span (context manager)."""
        return Span(self, name, dict(args))

    def counter(self, name: str, value: float = 1.0, **args: Any) -> None:
        """Accumulate ``value`` onto counter ``name`` (summed in metrics)."""
        ev = {
            "name": name,
            "ph": "C",
            "ts": round(self._us(self._clock()), 3),
            "pid": 1,
            "tid": 1,
            "args": {"value": value, **args},
        }
        self._events.append(ev)

    def gauge(self, name: str, value: float) -> None:
        """Record an instantaneous value; metrics keep last/min/max/mean."""
        self._events.append(
            {
                "name": name,
                "ph": "C",
                "ts": round(self._us(self._clock()), 3),
                "pid": 1,
                "tid": 1,
                "args": {"value": value, "gauge": True},
            }
        )

    def histogram(self, name: str, values: Sequence[int]) -> None:
        """Bin non-negative integer samples; stores ``bins[d] = count``."""
        bins: Dict[int, int] = {}
        count = 0
        for v in values:
            k = int(v)
            bins[k] = bins.get(k, 0) + 1
            count += 1
        self._events.append(
            {
                "name": name,
                "ph": "i",
                "s": "g",
                "ts": round(self._us(self._clock()), 3),
                "pid": 1,
                "tid": 1,
                "args": {
                    "histogram": {str(k): bins[k] for k in sorted(bins)},
                    "count": count,
                },
            }
        )

    def series(self, name: str, values: Sequence[float], max_points: int = 512) -> None:
        """Record a time series (e.g. per-cycle occupancy), downsampled.

        Long inputs are strided down to at most ``max_points`` samples;
        the stride is recorded so consumers can recover the time axis.
        """
        n = len(values)
        stride = max(1, -(-n // max_points))
        sampled = [float(values[i]) for i in range(0, n, stride)]
        self._events.append(
            {
                "name": name,
                "ph": "i",
                "s": "g",
                "ts": round(self._us(self._clock()), 3),
                "pid": 1,
                "tid": 1,
                "args": {"series": sampled, "stride": stride, "n": n},
            }
        )

    # -- aggregation ----------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def span_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: count, total/mean/max duration (us)."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self._events:
            if ev["ph"] != "X":
                continue
            row = out.setdefault(
                ev["name"], {"count": 0, "total_us": 0.0, "max_us": 0.0}
            )
            row["count"] += 1
            row["total_us"] += ev["dur"]
            row["max_us"] = max(row["max_us"], ev["dur"])
        for row in out.values():
            row["mean_us"] = row["total_us"] / row["count"]
        return out

    def metrics(self) -> Dict[str, Any]:
        """Aggregated counter/gauge/histogram tables keyed by name."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, Dict[str, float]] = {}
        histograms: Dict[str, Dict[str, int]] = {}
        for ev in self._events:
            name, args = ev["name"], ev.get("args", {})
            if ev["ph"] == "C":
                v = float(args.get("value", 0.0))
                if args.get("gauge"):
                    g = gauges.setdefault(
                        name, {"last": v, "min": v, "max": v, "sum": 0.0, "count": 0}
                    )
                    g["last"] = v
                    g["min"] = min(g["min"], v)
                    g["max"] = max(g["max"], v)
                    g["sum"] += v
                    g["count"] += 1
                else:
                    counters[name] = counters.get(name, 0.0) + v
            elif ev["ph"] == "i" and "histogram" in args:
                h = histograms.setdefault(name, {})
                for k, c in args["histogram"].items():
                    h[k] = h.get(k, 0) + int(c)
        for g in gauges.values():
            g["mean"] = g["sum"] / g["count"]
        return {"counters": counters, "gauges": gauges, "histograms": histograms}

    def summary(self) -> Dict[str, Any]:
        """Compact summary for embedding in BENCH_*.json ``obs`` tables."""
        spans = self.span_summary()
        met = self.metrics()
        top = sorted(spans.items(), key=lambda kv: -kv[1]["total_us"])[:8]
        return {
            "events": len(self._events),
            "spans": {
                name: {k: round(v, 3) for k, v in row.items()}
                for name, row in top
            },
            "counters": met["counters"],
            "gauges": {
                name: round(g["last"], 6) for name, g in met["gauges"].items()
            },
        }

    # -- output ---------------------------------------------------------

    def lines(self) -> Iterator[str]:
        for ev in self._events:
            yield json.dumps(ev, sort_keys=True)

    def dump(self, path: str) -> None:
        """Write buffered events as Chrome-trace-event JSONL."""
        with open(path, "w") as fh:
            for line in self.lines():
                fh.write(line + "\n")

    def clear(self) -> None:
        self._events.clear()


_RECORDER: Any = NullRecorder()


def get_recorder() -> Any:
    """The process-global recorder (a NullRecorder unless installed)."""
    return _RECORDER


def set_recorder(rec: Any) -> Any:
    """Install ``rec`` as the global recorder; returns the previous one."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec
    return prev


class recording:
    """Context manager installing ``rec`` for the enclosed block.

    >>> from repro_torch.obs import Recorder, recording, get_recorder
    >>> rec = Recorder()
    >>> with recording(rec):
    ...     with get_recorder().span("step"):
    ...         pass
    >>> rec.span_summary()["step"]["count"]
    1
    """

    def __init__(self, rec: Any):
        self._rec = rec
        self._prev: Any = None

    def __enter__(self) -> Any:
        self._prev = set_recorder(self._rec)
        return self._rec

    def __exit__(self, *exc: Any) -> bool:
        set_recorder(self._prev)
        return False
