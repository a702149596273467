"""How far does the bf16 EP prefill's yardstick ratio move from one token
draw to the next at the CPU tests' size?

`launch.cards`' part ``moe_prefill`` (deepseek-moe-16b scaled down, bf16,
expert parallelism on a (1, 4) mesh of four gloo ranks on the CPU) holds
the EP logits' relative RMS distance from the float32 prefill of the same
parameter values to 1 + `EP_BF16_SLACK` times the meshless bf16 logits'
distance.  This runs the part at each batch and sequence length given and
each token seed, and prints one JSON line a run: the two distances, their
ratio, the share of positions whose argmax agrees, whether the next token
is equal, and the part's verdict; then the same ratio over the tokens no
routing flip between the two bf16 runs reaches (``held``, of ``tokens``),
the flips in each MoE layer (and how many are not at a near tie), and
each run's margin between its two largest logits at the last position.

    PYTHONPATH=src python scripts/ep_bf16_yardstick.py \
        [--shapes 1x32,2x32,1x64] [--seeds 0-6]
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.cards import rank_cards  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="1x32,2x32,1x64",
                    help="batch x sequence length, comma separated")
    ap.add_argument("--seeds", default="0-6", help="first-last token seed")
    args = ap.parse_args(argv)
    first, last = map(int, args.seeds.split("-"))
    for shape in args.shapes.split(","):
        b, s = map(int, shape.split("x"))
        for seed in range(first, last + 1):
            c = {"arch": "deepseek-moe-16b", "batch": b, "seq": s,
                 "scaled": True, "seed": seed}
            t = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                ranks = run_ranks(rank_cards, 4, tmp, "cpu",
                                  {"moe_prefill": c}, backend="gloo",
                                  timeout=300)
            row = ranks[0]["moe_prefill"]
            print(json.dumps({
                "batch": b, "seq": s, "seed": seed,
                "meshless_vs_float32": row["meshless_vs_float32"],
                "ep_vs_float32": row["ep_vs_float32"],
                "ratio": row["ep_over_meshless"],
                "argmax_agree_share": row["argmax_agree_share"],
                "next_token_equal":
                    row["next_token"] == row["next_token_meshless"],
                "finite": row["finite"], "ok": row["ok"],
                "tokens": b * s, "held": row["held_tokens"],
                "ratio_held": row["ep_over_meshless_held"],
                "flips": [f["flips"] for f in row["flips"]],
                "unexplained": sum(f["unexplained"] for f in row["flips"]),
                "next_margin": row["next_margin"],
                "next_margin_meshless": row["next_margin_meshless"],
                "s": round(time.perf_counter() - t, 1)}), flush=True)


if __name__ == "__main__":
    main()
