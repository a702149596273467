"""Deterministic, resumable synthetic data pipeline.

The JAX package's ``train/data.py``: every batch is a pure function of
(seed, step), drawn with numpy exactly as the reference draws it, so the
port's tokens, targets and (bf16-rounded) frames equal the reference's bit
for bit; only the container differs (torch tensors on the pipeline's
device).  Generators:

  * "random"  -- i.i.d. tokens (throughput/dry-run work).
  * "markov"  -- a fixed random order-1 Markov chain over the vocab; has
                 learnable structure, so example trainings show a real loss
                 gap vs the i.i.d. entropy floor.  Its V x V transition
                 matrix is float64 on the host (185 GB at qwen2-0.5b's
                 151,936 tokens: full vocabularies take "random" or
                 "fixed").
  * "fixed"   -- one memorizable batch repeated (overfit tests).

Host sharding: ``process_index`` / ``process_count`` split the global
batch (one process gets the whole batch).  `iterate` keeps `depth` batches
ahead in a background thread.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DataConfig", "SyntheticPipeline"]


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    kind: str = "markov"  # random | markov | fixed
    seed: int = 1234
    frames: int = 0  # whisper: encoder frame count (0 = no frames)
    d_model: int = 0  # whisper: frame embedding dim
    mrope: bool = False


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1,
                 device: Union[str, torch.device, None] = "cuda"):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.device = resolve_device(device)
        if cfg.global_batch % process_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {process_count} processes")
        self.local_batch = cfg.global_batch // process_count
        if cfg.kind == "markov":
            rng = np.random.default_rng(cfg.seed)
            # sparse-ish transition matrix with strong structure
            logits = rng.gumbel(size=(cfg.vocab_size, cfg.vocab_size)) * 2.0
            self._trans = np.exp(logits - logits.max(1, keepdims=True))
            self._trans /= self._trans.sum(1, keepdims=True)
            self._trans_cum = np.cumsum(self._trans, axis=1)

    # -- batch generation -------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, Any]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed,
                                     step if cfg.kind != "fixed" else 0))
        b, s = self.local_batch, cfg.seq_len
        if cfg.kind in ("random", "fixed"):
            toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1),
                                dtype=np.int64)
        elif cfg.kind == "markov":
            toks = np.zeros((b, s + 1), dtype=np.int64)
            toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
            u = rng.random(size=(b, s))
            for t in range(s):
                cum = self._trans_cum[toks[:, t]]
                toks[:, t + 1] = (u[:, t:t + 1] < cum).argmax(axis=1)
        else:
            raise ValueError(cfg.kind)
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)
                                            ).to(dev),
                 "targets": torch.from_numpy(toks[:, 1:].astype(np.int32)
                                             ).to(dev)}
        if cfg.frames:
            fr = rng.standard_normal((b, cfg.frames, cfg.d_model)).astype(
                np.float32)
            # rounded to bf16 (nearest even) as jnp.asarray(.., bfloat16)
            batch["frames"] = torch.from_numpy(fr * 0.1).to(
                torch.bfloat16).to(dev)
        return batch

    # -- prefetching iterator ---------------------------------------------
    def iterate(self, start_step: int = 0,
                depth: int = 2) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    def entropy_floor(self) -> float:
        """Expected NLL of the exact generator (markov only)."""
        if self.cfg.kind != "markov":
            return float(np.log(self.cfg.vocab_size))
        p = self._trans
        h = -(p * np.log(np.maximum(p, 1e-12))).sum(1)
        return float(h.mean())
