"""Training driver with checkpoint/restart, failure injection, straggler
detection and resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50 \\
      --fail-at 20            # injected crash; rerun the command to resume
  PYTHONPATH=src python -m repro_torch.launch.train --preset full --data fixed \\
      --batch 4 --seq 2048 --steps 10   # qwen2-0.5b at full width, bf16

The JAX package's ``launch/train.py`` on the port, with the same options
and ``--device`` (default ``cuda``; ``--device cpu`` runs the plain
versions).  ``--preset smoke`` is the config scaled down in float32
without remat; ``--preset full`` is its published widths in bf16 with
``remat="full"``.  The parameters are random from ``--seed``.  The loop
resumes from the latest checkpoint under ``--ckpt-dir`` (default: a
directory in the system's temporary directory), draws the step's batch
(so a resumed run sees the batches it would have seen), saves
asynchronously every ``--ckpt-every`` steps, and reads the loss on the
host only at the steps it prints.  ``--data markov`` builds a V x V
matrix on the host, which a full vocabulary does not fit (185 GB at
qwen2-0.5b's): take ``random`` or ``fixed`` there.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..train import (AdamW, DataConfig, SyntheticPipeline, cosine_schedule,
                     init_state, make_train_step)
from ..train import checkpoint as ckpt
from ..train.elastic import FailureInjector, StragglerDetector

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--data", default="markov",
                    choices=["markov", "random", "fixed"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress", default=None, choices=[None, "int8"])
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--slow-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.scaled_down(dtype="float32")
    model = build_model(cfg, device=dev, seed=args.seed,
                        remat="none" if args.preset == "smoke" else "full")
    opt = AdamW(learning_rate=cosine_schedule(args.lr, 10, args.steps),
                weight_decay=0.0)
    step_fn = make_train_step(model, opt, num_microbatches=args.microbatches,
                              compress=args.compress)
    dc = DataConfig(global_batch=args.batch, seq_len=args.seq,
                    vocab_size=cfg.vocab_size, kind=args.data, seed=args.seed,
                    frames=cfg.encoder_frames, d_model=cfg.d_model)
    pipe = SyntheticPipeline(dc, device=dev)

    ckpt_dir = os.path.join(args.ckpt_dir, cfg.name)
    os.makedirs(ckpt_dir, exist_ok=True)
    state = init_state(model, opt)
    latest = ckpt.latest_step(ckpt_dir)
    start = 0
    if latest is not None:
        state = ckpt.restore(state, ckpt_dir, latest)
        start = latest
        print(f"[resume] restored step {latest} from {ckpt_dir}")

    injector = FailureInjector(fail_at_step=args.fail_at,
                               slow_at_step=args.slow_at)
    detector = StragglerDetector()
    metrics = None
    for step in range(start, args.steps):
        detector.start()
        batch = pipe.batch_at(step)  # deterministic skip-to-step resume
        injector.maybe_fail(step)
        state, metrics = step_fn(state, batch)
        stats = detector.stop()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "  # reprolint-torch: allow[host-sync] -- the CLI's progress line every 10 steps reads the loss, as the reference's does
                  f"gnorm {float(metrics['grad_norm']):.3f} "  # reprolint-torch: allow[host-sync] -- the same progress line's gradient norm
                  f"dt {stats['step_time']*1e3:.0f}ms"
                  + (" [straggler]" if stats["straggler"] else ""))
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            ckpt.save_async(state, ckpt_dir, step + 1)
    ckpt.wait_pending()
    final = f"{float(metrics['loss']):.4f}" if metrics is not None \
        else "n/a (no step left to run)"
    print(f"[done] final loss {final} "
          f"(markov entropy floor {pipe.entropy_floor():.3f}); "
          f"straggler report: {detector.recommendation()}")
    return state, metrics


if __name__ == "__main__":
    main()
