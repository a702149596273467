"""Checkpoint/restart (no external deps), in the JAX package's layout.

Layout: <dir>/step_<N>/
  manifest.json        -- step, and each leaf's shape and dtype
  arrays.npz           -- the state's leaves keyed by path ("opt/mu/layers/
                          attn/wq"), as ``jax.tree_util`` names them

A checkpoint written by either package restores into the other.  numpy
has no bfloat16: the reference's bf16 leaves (ml_dtypes arrays) land in
the npz as raw 2-byte voids ('<V2'), and so do the port's (the tensor's
bits viewed as int16, no ml_dtypes); `restore` reads the manifest's dtype
and views such a leaf's bits as bfloat16 again.  Writes commit by an
atomic rename, so `latest_step` never sees a partial one; `save_async`
copies the state to the host at once and writes it in a background
thread.

On a mesh, `save` gathers each DTensor leaf (``full_tensor``: every rank
takes part) and rank 0 of the world writes the same bytes a meshless
state would give; the other ranks wait for the commit.  `restore` with
``shardings`` (a tree of ``(mesh, placements)``,
`parallel.sharding.tree_specs_to_shardings`) places each leaf on its
mesh, so a checkpoint written on one mesh restores onto any other, or
onto none.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import tree_from_items, tree_items
from ..parallel.sharding import is_dtensor

__all__ = ["save", "save_async", "restore", "latest_step", "wait_pending"]

_pending: list = []


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _host(t: torch.Tensor) -> np.ndarray:
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # its bits, as the reference's '<V2'
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _snapshot(state) -> Dict[str, tuple]:
    """{path: (numpy array, dtype name)}: the leaves copied to the host."""
    return {"/".join(path): (_host(leaf), _dtype_name(leaf))
            for path, leaf in tree_items(state)}


def _write(host: Dict[str, tuple], ckpt_dir: str, step: int) -> str:
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if _rank() != 0:  # one writer
        return final
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in host.items()})
    manifest = {"step": step,
                "keys": {k: {"shape": list(a.shape), "dtype": name}
                         for k, (a, name) in host.items()}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def save(state, ckpt_dir: str, step: int) -> str:
    """Write `state` (a tree of tensors, DTensors among them on a mesh) as
    step `step`; returns its directory.  In a process group every rank
    calls it, and it returns once rank 0 has committed."""
    final = _write(_snapshot(state), ckpt_dir, step)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
    return final


def save_async(state, ckpt_dir: str, step: int) -> threading.Thread:
    """Snapshot to host memory synchronously, write to disk in background."""
    host = _snapshot(state)  # device -> host now
    t = threading.Thread(target=_write, args=(host, ckpt_dir, step),
                         daemon=False)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    for t in _pending:
        t.join()
    _pending.clear()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":  # 2-byte voids (or ml_dtypes): the bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(template, ckpt_dir: str, step: int,
            device: Union[str, torch.device, None] = None, shardings=None):
    """Restore into the structure of `template` (a tree of tensors): each
    leaf in the template leaf's dtype, on `device` (default: the template
    leaf's; pass one for a template on the meta device).  `shardings`, a
    matching tree of ``(mesh, placements)``, places each leaf on its mesh
    (this rank's shard of it, on the mesh's device); without it the
    leaves are plain tensors."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        keys = json.load(f)["keys"]
    flat_s = dict(tree_items(shardings)) if shardings is not None else None
    items = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for p, leaf in tree_items(template):
            key = "/".join(p)
            t = _tensor(data[key], keys[key]["dtype"])
            if flat_s is None:
                items.append((p, t.to(device or leaf.device, leaf.dtype)))
                continue
            from torch.distributed.tensor import distribute_tensor

            mesh, places = flat_s[p]
            dev = device or (torch.device("cuda", torch.cuda.current_device())
                             if mesh.device_type == "cuda" else "cpu")
            items.append((p, distribute_tensor(t.to(dev, leaf.dtype), mesh,
                                               places, src_data_rank=None)))
    return tree_from_items(items)

