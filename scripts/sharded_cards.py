#!/usr/bin/env python3
"""qwen3-4b's whole `train_4k` step on four cards: 256 sequences of
4096 tokens (1,048,576 tokens) at the plan `launch.cells.plan_cell`
gives on the live (2, 2) ("data", "model") DeviceMesh at the card's
memory (16 microbatches of 8 sequences a data rank, remat "full", AdamW
with float32 state, bf16).

    python3 scripts/sharded_cards.py [--out FILE]

One process a card (`launch.ranks.run_ranks`, NCCL), each running
`launch.cards.rank_cards`' ``train_4k`` part: one step under
`launch.cost`'s trace (per-device FLOPs, the collectives' wire bytes; it
warms up), one timed step (wall, flash launches, peak memory beside the
plan's estimate), one step under ``torch.profiler`` (device busy and idle
share, the NCCL kernels by name), then the bus rate of each collective
kind at the step's sizes (and all-gather, reduce-scatter and all-reduce
over the four cards) and the step's roofline bound on
`roofline.H100_SXM` at that link rate.  Prints the summary
(`launch.cards.train_4k_summary`: rank 0's plan, cost and rates, each
rank's record) as one JSON line, then the card's name and power limit,
and writes every record to FILE (default build/sharded_cards.json).  The
step is too long for chip_smoke.py, whose ``cards`` phase runs 2 of the
plan's microbatches.  Exits 2 without four cards, 1 if a rank fails, its
loss is not finite or its flash launches are not
`launch.cards.train_4k_launches` of the step.  The ranks are killed after
`DEADLINE_S` seconds.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 900.0  # the whole step took 53 s a rank on four H100s


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "sharded_cards.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("sharded_cards: needs four CUDA cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.launch import cards
    from repro_torch.launch.ranks import run_ranks

    _build.build_all()  # once, before the ranks load it
    smi = nvidia_smi()
    # the plan's own microbatch count: the whole step
    parts = {"train_4k": dict(cards.CARD_PARTS["train_4k"],
                              microbatches=None)}
    with tempfile.TemporaryDirectory(prefix="sharded_cards_") as tmp:
        ranks = run_ranks(cards.rank_cards, 4, tmp, "cuda", parts,
                          timeout=DEADLINE_S)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"nvidia_smi": smi, "ranks": ranks}, fh, indent=1)
    summary, problems = cards.train_4k_summary(ranks)
    print(json.dumps({"nvidia_smi": smi, **summary,
                      "problems": problems}), flush=True)
    print(smi, flush=True)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
