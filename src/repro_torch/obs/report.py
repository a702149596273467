"""Render a span/metric summary from a Chrome-trace-event JSONL file.

A copy of the JAX package's ``repro.obs.report``: the port's recorder
(`repro_torch.obs.record`) writes the same event schema.

Usage::

    python -m repro_torch.obs.report <trace.jsonl>            # text summary
    python -m repro_torch.obs.report <trace.jsonl> --format json
    python -m repro_torch.obs.report <trace.jsonl> --to-chrome out.json

``--to-chrome`` wraps the JSONL events into the ``{"traceEvents": [...]}``
JSON-array form that Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load directly; the JSONL itself is one event per
line so it can be streamed/appended and diffed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence


def load_events(path: str) -> List[Dict[str, Any]]:
    """Parse a trace JSONL file into a list of event dicts."""
    events = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad trace line: {e}") from e
    return events


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate span/counter/gauge/histogram tables from raw events."""
    spans: Dict[str, Dict[str, float]] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    histograms: Dict[str, Dict[str, int]] = {}
    for ev in events:
        ph = ev.get("ph")
        name = ev.get("name", "?")
        args = ev.get("args", {})
        if ph == "X":
            row = spans.setdefault(name, {"count": 0, "total_us": 0.0, "max_us": 0.0})
            row["count"] += 1
            row["total_us"] += float(ev.get("dur", 0.0))
            row["max_us"] = max(row["max_us"], float(ev.get("dur", 0.0)))
        elif ph == "C":
            v = float(args.get("value", 0.0))
            if args.get("gauge"):
                gauges[name] = v
            else:
                counters[name] = counters.get(name, 0.0) + v
        elif ph == "i" and "histogram" in args:
            h = histograms.setdefault(name, {})
            for k, c in args["histogram"].items():
                h[k] = h.get(k, 0) + int(c)
    for row in spans.values():
        row["mean_us"] = row["total_us"] / row["count"]
    return {
        "spans": spans,
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.1f}us"


def render_text(summary: Dict[str, Any]) -> str:
    lines: List[str] = []
    spans = summary["spans"]
    if spans:
        lines.append(f"{'span':<40} {'count':>7} {'total':>10} {'mean':>10} {'max':>10}")
        for name, row in sorted(spans.items(), key=lambda kv: -kv[1]["total_us"]):
            lines.append(
                f"{name:<40} {row['count']:>7d} {_fmt_us(row['total_us']):>10} "
                f"{_fmt_us(row['mean_us']):>10} {_fmt_us(row['max_us']):>10}"
            )
    if summary["counters"]:
        lines.append("")
        lines.append(f"{'counter':<40} {'total':>12}")
        for name, v in sorted(summary["counters"].items()):
            lines.append(f"{name:<40} {v:>12g}")
    if summary["gauges"]:
        lines.append("")
        lines.append(f"{'gauge':<40} {'last':>12}")
        for name, v in sorted(summary["gauges"].items()):
            lines.append(f"{name:<40} {v:>12g}")
    for name, bins in sorted(summary["histograms"].items()):
        lines.append("")
        total = sum(bins.values()) or 1
        lines.append(f"histogram {name} (n={total})")
        for k in sorted(bins, key=lambda s: int(s)):
            frac = bins[k] / total
            bar = "#" * max(1, round(40 * frac))
            lines.append(f"  {k:>6} {bins[k]:>10d} {bar}")
    if not lines:
        lines.append("(empty trace)")
    return "\n".join(lines)


def to_chrome(events: List[Dict[str, Any]], path: str) -> None:
    """Write events in the JSON-array form Perfetto loads directly."""
    meta = {
        "name": "process_name",
        "ph": "M",
        "pid": 1,
        "tid": 1,
        "args": {"name": "repro_torch.obs"},
    }
    with open(path, "w") as fh:
        json.dump({"traceEvents": [meta] + events}, fh)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs trace JSONL file.",
    )
    ap.add_argument("trace", help="trace JSONL file written by Recorder.dump")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument(
        "--to-chrome",
        metavar="OUT",
        help="also write a Perfetto-loadable Chrome trace JSON array",
    )
    args = ap.parse_args(argv)

    events = load_events(args.trace)
    if args.to_chrome:
        to_chrome(events, args.to_chrome)
        print(f"wrote {args.to_chrome} ({len(events)} events)", file=sys.stderr)
    summary = summarize(events)
    if args.format == "json":
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(render_text(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
