"""Roofline terms + report assembly.

The JAX package's ``launch/roofline.py`` with the hardware as an input:
`roofline_terms` takes an `HW` (peak dense bf16 FLOP/s, HBM bytes/s and
link bytes/s of one device) instead of module constants.  `H100_SXM` is
the NVIDIA H100 SXM5 80GB at its 700 W limit; its link rate is the
caller's (`with_link`), as `fabric/`'s cost models take theirs.

All inputs are PER-DEVICE quantities (`launch.cost`'s trace of one rank),
so the terms are seconds per step on one device; the formulas equal the
global forms ``compute = FLOPs_global / (devices * peak)``, etc.

  PYTHONPATH=src python -m repro_torch.launch.roofline \
      [--results results/dryrun_torch] [--tag T]
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["HW", "H100_SXM", "roofline_terms", "load_results",
           "format_table"]


@dataclass(frozen=True)
class HW:
    """One device's rates: dense bf16 FLOP/s, HBM bytes/s and the bytes/s
    of the link a collective's wire bytes cross (None: not given)."""
    peak_flops: float
    hbm_bw: float
    link_bw: Optional[float] = None

    def with_link(self, link_bw: float) -> "HW":
        """This device with `link_bw` bytes/s on its collective links."""
        return dataclasses.replace(self, link_bw=float(link_bw))


# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column (80 GB, up to
# 700 W): "BF16 Tensor Core 1,979 teraFLOPS" is with 2:4 sparsity, so
# dense bf16 is half of it, 989.4 TFLOP/s; "GPU memory bandwidth
# 3.35TB/s" (HBM3).  The datasheet's NVLink figure, 900 GB/s, is both
# directions of all 18 links together, not the rate of one collective's
# ring: the caller names the link rate it models (`HW.with_link`).
H100_SXM = HW(peak_flops=989.4e12, hbm_bw=3.35e12)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, n_dev: int,
                   model_flops: float, hw: HW) -> Dict:
    """The three terms on `hw` and the reference's derived ratios.  The
    collective term needs ``hw.link_bw``: without it (None) a step with
    wire bytes raises ValueError, one without has a 0 s term."""
    if hw.link_bw is None and wire_bytes_per_dev:
        raise ValueError("the collective term needs the link rate: pass "
                         "hw.with_link(bytes_per_s)")
    compute_s = flops_per_dev / hw.peak_flops
    memory_s = bytes_per_dev / hw.hbm_bw
    collective_s = wire_bytes_per_dev / hw.link_bw if wire_bytes_per_dev \
        else 0.0
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get).replace("_s", "")
    bound = max(terms.values())
    useful = model_flops / max(flops_per_dev * n_dev, 1.0)
    # fraction of the roofline-optimal step time actually spent on useful
    # model FLOPs if the dominant term were perfectly overlapped with others
    mfu_bound = (model_flops / n_dev / hw.peak_flops) / max(bound, 1e-30)
    return dict(terms, dominant=dominant, step_bound_s=bound,
                useful_flops_ratio=useful, roofline_fraction=mfu_bound,
                n_dev=n_dev)


def load_results(results_dir: str, tag: str = "") -> List[Dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        base = os.path.basename(p)[:-5]
        parts = base.split("__")
        if tag and (len(parts) < 4 or parts[3] != tag):
            continue
        if not tag and len(parts) > 3:
            continue
        with open(p) as f:
            out.append(json.load(f))
    return out


def format_table(results: List[Dict]) -> str:
    """Markdown table.  Primary terms are the flash ones (attention's
    Q/K/V/O traffic only); the plain-attention terms in parens.  The fit
    column reads the dry run's memory against the budget it was given:
    the measured peak / the planner's estimate (the reference's "raw /
    TPU-est" column, whose second figure has no counterpart here)."""
    rows = ["| arch | shape | mesh | compute (s) | memory (s) | collective (s)"
            " | dominant | useful | frac | fit (raw/TPU-est) |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"*skipped: sub-quadratic-only shape* | | | | | | |")
            continue
        if not r.get("ok"):
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"FAILED: {r.get('error','?')[:60]} | | | | | | |")
            continue
        t = r.get("roofline_flash", r["roofline"])
        raw = r["roofline"]
        m = r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {t['compute_s']:.4g} | {t['memory_s']:.4g} ({raw['memory_s']:.3g}) "
            f"| {t['collective_s']:.4g} ({raw['collective_s']:.3g}) "
            f"| **{t['dominant']}** "
            f"| {t['useful_flops_ratio']:.2f} | {t['roofline_fraction']:.2f} "
            f"| {m.get('fits_hbm')}/{m.get('fits_hbm_estimate')} |")
    return "\n".join(rows)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results",
        "dryrun_torch"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    print(format_table(load_results(args.results, args.tag)))
