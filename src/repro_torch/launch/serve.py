"""Serving entry point: batched autoregressive decode with KV caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --preset full

The JAX package's ``launch/serve.py`` on the port: random parameters from
``--seed``, a random prompt, the prompt fed token by token through the
decode step (the fused prefill is ``model.forward``), then greedy
(``--temperature 0``) or sampled decoding.  Runs on the card unless
``--device cpu``.  Every family is ported; MoE decode routes dropless, as
the reference's does.  For the encoder-decoder (Whisper) the random frames
[B, encoder_frames, d_model] * 0.1 come from the same generator in
float32, as the reference draws them, and are encoded by ``init_cache``:
under ``--preset full`` (bf16 parameters) the encoder computes in float32,
as the reference's promotes, on the CUDA-core flash kernel.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model

__all__ = ["generate", "main"]


def generate(model, cache, prompt: torch.Tensor, tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0) -> torch.Tensor:
    """Feed `prompt` [B, P] through the decode step, then generate `tokens`
    more: argmax at temperature 0, else a draw from softmax(logits / T)
    with `generator` (on the model's device).  Returns [B, tokens] int64.
    The reference's loop, step for step: the last generated token is fed
    through one more step too."""
    plen = prompt.shape[1]
    logits = None
    for pos in range(plen):
        logits, cache = model.decode_step(cache, prompt[:, pos:pos + 1], pos)
    out = []
    for step in range(tokens):
        last = logits[:, -1]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        else:
            nxt = torch.argmax(last, dim=-1, keepdim=True)
        out.append(nxt)
        logits, cache = model.decode_step(cache, nxt, plen + step)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.scaled_down(dtype="float32")
    model = build_model(cfg, device=dev, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    max_seq = args.prompt_len + args.tokens
    if cfg.family == "encdec":
        frames = torch.randn((args.batch, cfg.encoder_frames, cfg.d_model),
                             generator=gen, device=dev,
                             dtype=torch.float32) * 0.1
        cache = model.init_cache(args.batch, max_seq, frames=frames)
    else:
        cache = model.init_cache(args.batch, max_seq)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    gen_tokens = generate(model, cache, prompt, args.tokens, gen,
                          args.temperature).cpu()
    dt = time.perf_counter() - t0
    total = args.batch * (args.prompt_len + args.tokens)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[{cfg.name}] generated {tuple(gen_tokens.shape)} in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. prefill, {where})")
    print("sample:", gen_tokens[0][:16].tolist())
    return gen_tokens


if __name__ == "__main__":
    main()
