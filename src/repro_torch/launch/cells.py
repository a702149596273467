"""(architecture x input-shape) cells: applicability, input specs, memory plan.

The JAX package's ``launch/cells.py`` on a `parallel.sharding.MeshShape`
or a torch ``DeviceMesh``.  Shapes (assignment):
  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> forward (prefill)
  decode_32k   seq 32768,  global_batch 128   -> decode_step (1 new
                                                 token, 32k KV/state)
  long_500k    seq 524288, global_batch 1     -> decode_step; sub-quadratic
               archs only (falcon-mamba, recurrentgemma); skipped for
               full-attention archs

The memory planner picks (microbatches, optimizer dtype, grad-accum dtype,
sequence-parallel residuals) per cell to fit a budget per device, the
reference's logic unchanged: its candidate microbatch counts stop at 32,
and a cell that fits at none of them falls back to one sequence a
microbatch with a note.  The budget is the caller's: ``hbm_per_chip``
bytes of device memory, of which ``budget`` (default: all but
`HEADROOM`, the reference's 2.5 GB for fragmentation and runtime
buffers) may be planned.  At ``hbm_per_chip=16e9, budget=13.5e9`` every
plan equals the reference's.  Parameter counts come from the `defs`
tables, so planning builds no parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.api import model_parts
from ..models.common import count_params
from ..models.config import ModelConfig
from ..parallel.sharding import (DEFAULT_RULES, AxisRules, batch_axes,
                                 mesh_axis_sizes, spec_for)

__all__ = ["SHAPES", "LONG_CONTEXT_OK", "HEADROOM", "cell_supported",
           "CellPlan", "plan_cell", "active_param_count", "batch_specs"]

# bytes a device keeps free of the plan (the reference's 16 GB - 13.5 GB)
HEADROOM = 2.5e9

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

LONG_CONTEXT_OK = {"falcon-mamba-7b", "recurrentgemma-9b"}


def cell_supported(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, ("full-attention architecture: O(seq) KV cache / "
                       "O(seq^2) attention at 524k is out of scope per "
                       "assignment (sub-quadratic archs only)")
    return True, ""


@dataclass
class CellPlan:
    arch: str
    shape: str
    kind: str
    batch: int
    seq: int
    num_microbatches: int = 1
    profile: str = "tp2d"  # sharding profile: tp2d | fsdp
    opt_dtype: str = "float32"
    optimizer: str = "adamw"  # adamw | adafactor (>=100B: PaLM-style)
    accum_dtype: str = "float32"
    remat: str = "full"  # full | 2level (sqrt-checkpointing, >=100B)
    seq_parallel: bool = False
    est_bytes_per_chip: float = 0.0
    note: str = ""


def _param_count(cfg: ModelConfig) -> int:
    return count_params(model_parts(cfg)[0](cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k routed + shared + attention)."""
    total = _param_count(cfg)
    if not cfg.num_experts:
        return total
    e, d, f = cfg.experts_padded, cfg.d_model, cfg.d_ff
    per_expert = 3 * d * f
    routed_layers = cfg.num_layers - (1 if cfg.first_dense_d_ff else 0)
    dead = routed_layers * (e - cfg.top_k) * per_expert
    return total - dead


def plan_cell(cfg: ModelConfig, shape_name: str, mesh, *,
              hbm_per_chip: float, budget: Optional[float] = None
              ) -> CellPlan:
    """The plan of one cell on `mesh` (a `MeshShape` or a `DeviceMesh`)
    for devices of `hbm_per_chip` bytes, planning at most `budget` bytes
    of each (default ``hbm_per_chip - HEADROOM``)."""
    budget = hbm_per_chip - HEADROOM if budget is None else budget
    sh = SHAPES[shape_name]
    kind, seq, batch = sh["kind"], sh["seq"], sh["batch"]
    sizes = mesh_axis_sizes(mesh)
    n_dev = 1
    for s in sizes.values():
        n_dev *= s
    dp = 1
    for a in batch_axes(mesh):
        dp *= sizes[a]
    tp = sizes.get("model", 1)
    params = _param_count(cfg)
    plan = CellPlan(arch=cfg.name, shape=shape_name, kind=kind,
                    batch=batch, seq=seq)

    pbytes = params * 2 / n_dev  # bf16, fully sharded (ZeRO-3 over the mesh)
    if kind != "train":
        # decode/prefill: params + cache/activations
        if kind == "decode":
            cache = _cache_bytes(cfg, batch, seq)
            plan.est_bytes_per_chip = pbytes + cache / n_dev
        else:
            # prefill of 1M tokens: shard the residual seq dim too
            plan.seq_parallel = True
            act = batch * seq * cfg.d_model * 2 * 4  # transient working set
            plan.est_bytes_per_chip = pbytes + act / n_dev
        return plan

    if params > 1e11:  # 340B-class: factored optimizer + bf16 accumulation
        plan.optimizer = "adafactor"
        plan.accum_dtype = "bfloat16"
        plan.remat = "2level"
        opt_b = params * 4 * 0.02 / n_dev  # row+col factors are ~2/min(dim)
    else:
        plan.opt_dtype = "bfloat16" if params > 5e10 else "float32"
        opt_b = params * 2 * (2 if plan.opt_dtype == "bfloat16" else 4) / n_dev
    acc_b = 2 if plan.accum_dtype == "bfloat16" else 4
    grad_b = params * acc_b * 3 / n_dev  # accum carry (x2 in scan) + live vjp
    state = pbytes + opt_b + grad_b

    local_batch = max(1, batch // dp)
    layers_saved = cfg.num_layers
    # residual checkpoints per layer (remat="full" saves the carry)
    for mub in [m for m in (1, 2, 4, 8, 16, 32) if m <= local_batch]:
        for sp in (False, True):
            shard = tp if sp else 1
            tok_local = local_batch * seq / mub / shard
            act = tok_local * cfg.d_model * 2 * layers_saved
            act += tok_local * cfg.d_model * 4 * 12  # working set of one layer
            # CE block: f32 logits + softmax + cotangent (~4 live copies)
            act += (local_batch * seq / mub) * cfg.vocab_size / tp * 4 * 4
            total = state + act
            if total < budget:
                plan.num_microbatches = mub
                plan.seq_parallel = sp
                plan.est_bytes_per_chip = total
                return plan
    plan.num_microbatches = local_batch
    plan.seq_parallel = True
    plan.est_bytes_per_chip = state
    plan.note = "memory plan exceeds budget even at max microbatching"
    return plan


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    if cfg.family == "ssm":
        return (cfg.num_layers * batch
                * (cfg.d_inner * cfg.ssm_state * 4 + cfg.d_inner * 3 * 2))
    if cfg.family == "hybrid":
        g = cfg.num_layers // 3
        rec = 2 * g * batch * (cfg.lru_width * 4 + 3 * cfg.lru_width * 2)
        att = g * batch * cfg.num_kv_heads * min(cfg.local_window or seq, seq) \
            * cfg.head_dim * 2 * 2
        return rec + att
    per_layer = batch * cfg.num_kv_heads * cfg.head_dim * 2 * 2  # k+v bf16
    total = 0.0
    pattern = cfg.layer_pattern
    for i in range(cfg.num_layers):
        kindp = pattern[i % len(pattern)]
        length = (min(cfg.local_window, seq)
                  if (kindp == "local" and cfg.local_window) else seq)
        total += per_layer * length
    return total


def batch_specs(cfg: ModelConfig, shape_name: str, mesh,
                rules: Optional[AxisRules] = None):
    """({name: (shape, dtype)}, {name: PartitionSpec}) of the data batch
    (the reference's ShapeDtypeStruct and spec trees)."""
    rules = rules or DEFAULT_RULES
    sh = SHAPES[shape_name]
    seq, batch = sh["seq"], sh["batch"]
    sds = {"tokens": ((batch, seq), torch.int32),
           "targets": ((batch, seq), torch.int32)}
    specs = {"tokens": spec_for((batch, seq), ("batch", None), mesh, rules),
             "targets": spec_for((batch, seq), ("batch", None), mesh, rules)}
    if cfg.family == "encdec":
        fshape = (batch, cfg.encoder_frames, cfg.d_model)
        sds["frames"] = (fshape, torch.bfloat16)
        specs["frames"] = spec_for(fshape, ("batch", None, None), mesh, rules)
    return sds, specs
