"""The four-card train step's collectives against the reference's
compiled step (fault F11).

qwen3-4b `train_4k` on a (2, 2) ("data", "model") mesh at the plan
`launch.cells.plan_cell` gives the port there at 80 GB a card: tp2d,
remat "full", AdamW with float32 state and accumulation, 16 microbatches
of 16 sequences (8 a data rank), so the residual stream a rank holds is
one [8, 4096, 2560] bf16 activation.  The port's step runs on meta
tensors in a fake world of 4 ranks (torch's ``fake`` process group, in a
subprocess: a process group lives as long as its process) under
`launch.cost.trace_cost(collectives=True)`, at 1 and at 2 of the plan's
microbatches; the difference of the two is one microbatch's collectives.
The reference's counts are its compiled step's on 4 forced CPU devices
(tests/fixtures/torch_port_collectives_reference.json, from
``scripts/make_torch_port_reference.py --collectives``), the whole step
over its 16 microbatches.

Held, a layer and microbatch: at most `launch.cards.TRAIN_4K_ALL_REDUCES`
(6) all-reduces of the activation (Megatron's two a pass forward and
backward and the recompute's two under full remat; the reference
compiles to 5.06, printed beside it), the bar the four-card run holds; no
reduce-scatter or all-gather of its size (the reference has none), and
at most 52 GB of wire bytes a device a microbatch (half of the 104.19 GB
the step traced while the embedding's partial sums stayed unreduced
through every block).  With sequence parallelism on, at the same plan:
no more activation-sized collectives than the reference's.  Activation-
sized calls a layer are counted by `launch.cards.activation_collectives`
(`launch.collbreak.activation_sized`: a result of the activation's
elements, half of them or twice them, whatever the dtype), as the
four-card run counts them.
"""
import json
import os
import subprocess
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.cards import TRAIN_4K_ALL_REDUCES  # noqa: E402
from repro_torch.launch.cards import activation_collectives  # noqa: E402
from repro_torch.launch.collbreak import result_dims  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_collectives_reference.json")
MESH = (2, 2)  # ("data", "model")
WIRE_BAR = 52e9  # bytes a device a microbatch
RUNS = {"tp2d": False, "tp2d_sp": True}

PROBE = r'''
import json, sys
from collections import defaultdict
import torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.cells import plan_cell
from repro_torch.launch.cost import trace_cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.sharding import MeshShape

sp = sys.argv[1] == "1"
cfg = get_config("qwen3-4b")
dryrun.fake_world(4)
mesh = make_mesh((2, 2), ("data", "model"))
plan = plan_cell(cfg, "train_4k", MeshShape(("data", "model"), (2, 2)),
                 hbm_per_chip=80e9)
per_mb = plan.batch // plan.num_microbatches
plan.seq_parallel = sp
out = {}
for mb in (1, 2):
    plan.num_microbatches = mb
    call, _, _ = dryrun._cell_call(cfg, plan, "train_4k", mesh,
                                   torch.device("meta"), batch=per_mb * mb)
    with trace_cost(collectives=True, run=dryrun.MetaCache()) as mode:
        call()
    rows = defaultdict(lambda: [0, 0.0])
    for kind, what, g, wire, region in mode.rows:
        key = f"{kind}|{what}|{g}|{region.split(':', 1)[0]}"
        rows[key][0] += 1
        rows[key][1] += wire
    out[mb] = rows
print(json.dumps({"layers": cfg.num_layers, "per_mb": per_mb,
                  "rows": out}))
'''


def _trace(sp: bool):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", PROBE, "1" if sp else "0"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@lru_cache(maxsize=None)
def _port():
    """{run: (one microbatch's rows {(kind, dims, phase): [calls, wire]},
    layers)}: the two traces of each run, side by side."""
    with ThreadPoolExecutor(len(RUNS)) as ex:
        traced = dict(zip(RUNS, ex.map(_trace, RUNS.values())))
    out = {}
    for name, t in traced.items():
        one = defaultdict(lambda: [0, 0.0])
        for sign, mb in ((-1, "1"), (1, "2")):
            for key, (calls, wire) in t["rows"][mb].items():
                kind, what, _, phase = key.split("|")
                row = one[(kind, tuple(result_dims(what)[1]), phase)]
                row[0] += sign * calls
                row[1] += sign * wire
        out[name] = (dict(one), t["layers"])
    return out


def _reference():
    with open(FIXTURE) as fh:
        return json.load(fh)


def _ref_rows(run):
    """The reference's run as {(kind, dims, phase): [calls, wire]} a
    microbatch, and its layers."""
    mb = run["microbatches"]
    rows = defaultdict(lambda: [0.0, 0.0])
    for r in run["rows"]:
        row = rows[(r["kind"], tuple(r["dims"]), r["phase"])]
        row[0] += r["calls"] / mb
        row[1] += r["wire_bytes"] / mb
    return dict(rows), run["layers"]


@lru_cache(maxsize=None)
def _plan():
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import plan_cell
    from repro_torch.parallel.sharding import MeshShape

    cfg = get_config("qwen3-4b")
    return cfg, plan_cell(cfg, "train_4k", MeshShape(("data", "model"),
                                                     MESH),
                          hbm_per_chip=80e9)


def _activation(rows, layers):
    """Activation-sized calls a layer, by kind: the [B, S, d] residual
    stream a rank holds a microbatch at the plan, over "model"."""
    cfg, plan = _plan()
    act = [plan.batch // plan.num_microbatches // MESH[0], plan.seq,
           cfg.d_model]
    return activation_collectives(
        ((kind, dims, calls) for (kind, dims, _), (calls, _) in rows.items()),
        act, MESH[1], layers)


def _wire(rows):
    return sum(w for _, w in rows.values())


def test_fixture_plan_is_the_ports_four_card_plan():
    """The fixture's plan fields are what the port's planner gives the
    four-card cell today, and its runs are the two the tests read."""
    doc = _reference()
    c = doc["config"]
    assert (c["arch"], c["shape"], c["mesh"], c["axes"]) == (
        "qwen3-4b", "train_4k", list(MESH), ["data", "model"])
    cfg, plan = _plan()
    assert {k: getattr(plan, k) for k in c["plan"]} == c["plan"]
    assert plan.seq_parallel is False
    assert c["runs"] == RUNS
    for name, sp in RUNS.items():
        run = doc["runs"][name]
        assert run["seq_parallel"] is sp
        assert run["layers"] == cfg.num_layers
        assert run["microbatches"] == plan.num_microbatches
        assert run["wire_bytes"] == pytest.approx(
            sum(r["wire_bytes"] for r in run["rows"]))
        for r in run["rows"]:
            assert set(r) == {"kind", "dtype", "dims", "g", "phase", "op",
                              "calls", "wire_bytes"}
            assert r["phase"] in ("fwd", "bwd", "opt/other")
            assert r["calls"] > 0 and r["wire_bytes"] >= 0


def test_four_card_step_all_reduces_the_activation_at_most_six_times():
    rows, layers = _port()["tp2d"]
    ref = _activation(*_ref_rows(_reference()["runs"]["tp2d"]))
    got = _activation(rows, layers).get("all-reduce", 0.0)
    print(f"activation all-reduces a layer and microbatch: port {got:.3f}, "
          f"reference (compiled) {ref['all-reduce']:.3f}, bar "
          f"{TRAIN_4K_ALL_REDUCES}")
    assert got <= TRAIN_4K_ALL_REDUCES, (got, ref, rows)


def test_four_card_step_neither_scatters_nor_gathers_the_activation():
    rows, layers = _port()["tp2d"]
    ref = _activation(*_ref_rows(_reference()["runs"]["tp2d"]))
    assert set(ref) == {"all-reduce"}, ref
    got = _activation(rows, layers)
    print(f"activation-sized collectives a layer and microbatch: port "
          f"{got}, reference (compiled) {ref}")
    assert set(got) <= {"all-reduce"}, (got, rows)


def test_four_card_step_wire_bytes_a_microbatch_halved():
    rows, _ = _port()["tp2d"]
    ref = _ref_rows(_reference()["runs"]["tp2d"])[0]
    got = _wire(rows)
    print(f"wire bytes a device a microbatch: port {got / 1e9:.2f} GB "
          f"(bf16), reference (compiled) {_wire(ref) / 1e9:.2f} GB "
          f"(float32 on the CPU), bar {WIRE_BAR / 1e9:.0f} GB")
    assert got <= WIRE_BAR, (got, rows)


def test_sequence_parallel_step_no_more_activation_collectives():
    rows, layers = _port()["tp2d_sp"]
    ref = _activation(*_ref_rows(_reference()["runs"]["tp2d_sp"]))
    got = _activation(rows, layers)
    print(f"sequence parallel, activation-sized collectives a layer and "
          f"microbatch: port {got}, reference (compiled) {ref}")
    assert sum(got.values()) <= sum(ref.values()), (got, ref, rows)
