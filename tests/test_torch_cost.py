"""`repro_torch.launch.cost`, the port's counterpart of the JAX package's
HLO cost parser (`repro.launch.hlo`).

* The ring accounting on the five collective kinds, with
  tests/test_sharding.py's fixture numbers (an all-reduce of 8x16 f32 in
  groups of 4, 5 times: 5 * 2 * S * 3/4), equal to the reference's parse
  of that fixture.
* On a fake (2, 2) world (torch's ``fake`` process group, meta
  parameters) a 2-layer forward at qwen2-0.5b's widths: the per-rank
  ``dot_flops`` equal a hand count from the config (every GEMM and the
  flash kernel's 4 B Hq S S D split evenly over the 4 ranks: the one-hot
  embedding and the unembedding under ``local_map``, the weights
  gathered over ``data`` and the heads split over ``model``), and the
  collective counts equal ``CommDebugMode``'s.  In a subprocess: a
  process group lives as long as its process.
* The counts are of local shapes, on plain CPU tensors too: a meshless
  2-layer forward counts its attention's batched products (plain
  attention on the CPU) with the reference's logits-shaped rule for
  ``dot_bytes_flash``.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import cost  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HLO_FIXTURE = """
HloModule jit_f, is_scheduled=true

%add (a: f32[], b: f32[]) -> f32[] {
  ROOT %r = f32[] add(%a, %b)
}

%body (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %p0 = s32[] get-tuple-element(%p), index=0
  %x = f32[8,16]{1,0} get-tuple-element(%p), index=1
  %w = f32[16,16]{1,0} parameter(1)
  %d = f32[8,16]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[8,16]{1,0} all-reduce(%d), replica_groups=[2,4]<=[8], to_apply=%add
  ROOT %t = (s32[], f32[8,16]) tuple(%p0, %ar)
}

%cond (p: (s32[], f32[8,16])) -> pred[] {
  ROOT %c = pred[] constant(true)
}

ENTRY %main (x: f32[8,16]) -> f32[8,16] {
  %init = (s32[], f32[8,16]) tuple(s32[] constant(0), %x)
  %wl = (s32[], f32[8,16]) while(%init), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"5"}}
  ROOT %out = f32[8,16]{1,0} get-tuple-element(%wl), index=1
}
"""


def test_ring_accounting_matches_reference_fixture():
    from repro.launch.hlo import parse_module

    ref = parse_module(HLO_FIXTURE)
    c = cost.ModuleCost()
    s = 8 * 16 * 4
    c.add_collective("all-reduce", s, 4, torch.float32, times=5)
    assert c.coll_wire_bytes["all-reduce"] == 5 * 2 * s * 0.75
    assert c.coll_wire_bytes["all-reduce"] == ref.coll_wire_bytes["all-reduce"]
    assert c.coll_counts["all-reduce"] == ref.coll_counts["all-reduce"] == 5
    assert c.total_wire_bytes_bf16 == ref.total_wire_bytes_bf16
    assert c.summary().keys() == ref.summary().keys()
    assert c.summary()["unknown_trip_loops"] == 0


@pytest.mark.parametrize("kind,want", [
    ("all-reduce", 2 * 512 * 3 / 4), ("all-gather", 512 * 3 / 4),
    ("reduce-scatter", 512 * 3), ("all-to-all", 512 * 3 / 4),
    ("collective-permute", 512)])
def test_ring_formulas(kind, want):
    assert cost.ring_wire_bytes(kind, 512, 4) == want
    c = cost.ModuleCost()
    c.add_collective(kind, 512, 4, torch.bfloat16, times=2)
    assert c.coll_wire_bytes[kind] == 2 * want
    assert c.total_wire_bytes_bf16 == 2 * want
    assert c.coll_result_bytes[kind] == 1024


PROBE = r'''
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor.debug import CommDebugMode
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch.configs import get_config
from repro_torch.launch.cost import trace_cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import model_parts
from repro_torch.models.common import tree_map

b, s = int(sys.argv[1]), int(sys.argv[2])
mesh = make_mesh((2, 2), ("data", "model"))
cfg = get_config("qwen2-0.5b").with_(num_layers=2)
defs, cls = model_parts(cfg)
params = tree_map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16,
                                        device="meta"), defs(cfg))
model = cls(cfg, params, mesh=mesh)
tokens = torch.zeros((b, s), dtype=torch.int64, device="meta")
with CommDebugMode() as cm, trace_cost() as mode, torch.no_grad():
    logits = model.forward(tokens)
c = mode.cost
print(json.dumps({"summary": c.summary(), "kernels": dict(c.kernel_calls),
                  "comm": {k.__name__: v
                           for k, v in cm.get_comm_counts().items()},
                  "shape": list(logits.shape)}))
'''


def test_fake_world_forward_per_rank_flops():
    from repro_torch.configs import get_config

    b, s = 8, 256
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", PROBE, str(b), str(s)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    cfg = get_config("qwen2-0.5b")
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    t, layers = b * s, 2
    per_layer = (2 * t * d * (hq + 2 * hkv) * hd  # q, k, v projections
                 + 2 * t * hq * hd * d             # output projection
                 + 3 * 2 * t * d * cfg.d_ff        # gate, up, down
                 + 4 * b * hq * s * s * hd)        # flash: QK^T and PV
    embed = 2 * 2 * t * cfg.vocab_size * d         # one-hot in, unembed out
    assert got["summary"]["dot_flops"] == (layers * per_layer + embed) / 4
    assert got["kernels"] == {"sm90": layers}
    assert got["shape"] == [b, s, cfg.vocab_size]
    names = {"all_reduce": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
    comm = {names[k]: v for k, v in got["comm"].items()}
    assert comm == got["summary"]["collective_counts"]
    assert sum(comm.values()) > 0


def test_meshless_cpu_counts_plain_attention():
    """A meshless float32 forward on the CPU: plain attention's batched
    products are counted, and its scores leave ``dot_bytes_flash``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen2-0.5b").scaled_down(dtype="float32",
                                               num_layers=2)
    model = build_model(cfg, device="cpu", seed=0)
    b, s = 2, 1024
    tokens = torch.zeros((b, s), dtype=torch.int64)
    with cost.trace_cost() as mode, torch.inference_mode():
        model.forward(tokens)
    c = mode.cost
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    t = b * s
    per_layer = (2 * t * d * (hq + 2 * hkv) * hd + 2 * t * hq * hd * d
                 + 3 * 2 * t * d * cfg.d_ff + 4 * b * hq * s * s * hd)
    assert c.dot_flops == 2 * per_layer + 2 * t * cfg.vocab_size * d
    assert not c.kernel_calls and not c.coll_counts
    scores = 2 * (b * hq * s * s * 4)  # written by QK^T, read by PV
    assert c.dot_bytes - c.dot_bytes_flash == 2 * scores
