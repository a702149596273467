"""Collective breakdown for perf iteration: attribute the wire bytes of a
traced cell to (op kind, shape, group size, source region) so that
hillclimbing targets the right collective.

The JAX package's ``launch/collbreak.py``, which reads them off the
compiled HLO with its trip counts.  Here `launch.dryrun.trace_cell`
traces the cell's step on the fake world and `launch.cost.CostMode`
records every ``_c10d_functional`` collective as it runs, once per run
(no trip counts): the region is "fwd:" and the port's innermost frame
(``file:line function``), "bwd:" and the autograd node running it in the
backward (autograd's engine runs the backward from C++), or "opt/other:"
(the optimizer), the reference's op_name regions.

  PYTHONPATH=src python -m repro_torch.launch.collbreak --hbm-gb 80 \
      --arch X --shape Y [--multipod] [--top 15] [--remat full|2level|none]
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..models.common import REMAT

__all__ = ["breakdown", "main"]


def breakdown(rows: List[Tuple[str, str, int, float, str]], top: int = 15):
    """(the `top` (key, wire bytes) by bytes, counts by key, total): a key
    is (kind, dtype[shape], "g<group size>", region), from `CostMode`'s
    ``rows``."""
    wire: Dict[tuple, float] = defaultdict(float)
    counts: Dict[tuple, int] = defaultdict(int)
    for kind, shape, g, w, region in rows:
        key = (kind, shape, f"g{g}", region)
        wire[key] += w
        counts[key] += 1
    out = sorted(wire.items(), key=lambda kv: -kv[1])[:top]
    return out, counts, sum(wire.values())


def main(argv: Optional[List[str]] = None) -> None:
    from . import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-parallel", dest="sp", default=None,
                    choices=["on", "off"])
    ap.add_argument("--remat", default=None, choices=list(REMAT),
                    help="in place of the plan's remat")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="device memory where no card is present")
    ap.add_argument("--link-gbps", type=float, default=dryrun.LINK_GBPS,
                    help="GB/s a device for the collective term "
                         "(launch.dryrun.LINK_GBPS)")
    args = ap.parse_args(argv)
    extra = {}
    if args.microbatches:
        extra["num_microbatches"] = args.microbatches
    if args.sp:
        extra["seq_parallel"] = args.sp == "on"
    if args.remat:
        extra["remat"] = args.remat
    _, mode, _, _, _ = dryrun.trace_cell(
        args.arch, args.shape, "multipod" if args.multipod else "pod",
        _hbm(ap, args.hbm_gb), extra or None, collectives=True)
    rows, counts, total = breakdown(mode.rows, args.top)
    print(f"total wire bytes/device: {total/1e9:.2f} GB "
          f"(collective term {total/(args.link_gbps * 1e9):.2f} s)")
    for key, wire in rows:
        kind, shape, g, region = key
        print(f"{wire/1e9:9.2f} GB  {100*wire/max(total, 1e-30):5.1f}%  "
              f"x{counts[key]:<6d}{kind:18s} {shape:28s} {g:5s} {region}")


def _hbm(ap, hbm_gb):
    from . import dryrun

    try:
        return dryrun.hbm_bytes(hbm_gb)
    except ValueError as e:
        ap.error(str(e))


if __name__ == "__main__":
    main()
