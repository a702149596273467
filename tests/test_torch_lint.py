"""reprolint-torch, the port's linter (`repro_torch.analysis`), held
against the JAX package's reprolint (`repro.analysis`) case for case:

* the engine: on every reprolint fixture (its pragma token swapped to
  ``reprolint-torch``) the pragmas, the meta findings and the JSON report
  equal the reference's, and the summary line differs only in its name;
* the rules: on the torch translation of each reference bad fixture, the
  port's rule fires on the same lines as the reference rule on the
  original, and the good fixtures are quiet with the same suppressed
  counts; each torch-only form has a firing and a quiet case;
* the gate: the port's tree (``src/repro_torch``, ``chip_smoke.py``) has
  no finding, the linter runs with torch, numpy and jax hidden, and every
  reference pragma in a file the port copied has its port counterpart;
* the torch shim (`repro_torch.parallel.compat`)."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis.pragmas import parse_pragmas as ref_parse  # noqa: E402
from repro.analysis.rules import ALL_RULES as REF_RULES  # noqa: E402
from repro_torch.analysis.lint import (DEFAULT_PATHS, DEFAULT_SCOPE,  # noqa: E402
                                       lint_paths, main)
from repro_torch.analysis.pragmas import parse_pragmas  # noqa: E402
from repro_torch.analysis.report import render_json, render_text  # noqa: E402
from repro_torch.analysis.rules import (ALL_RULES, RULES_BY_ID,  # noqa: E402
                                        FileContext)
from repro_torch.analysis.rules.host_sync import (HostSyncRule,  # noqa: E402
                                                  reached_lines)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "reprolint")
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "reprolint_torch")

# run a rule on arbitrary fixture paths regardless of the repo scope config
WIDE = {r.id: (("*",), ()) for r in ALL_RULES}
REF_WIDE = {r.id: (("*",), ()) for r in REF_RULES}
META = ("bad-pragma", "unused-pragma", "parse-error")
REF_FIXTURE_FILES = sorted(f for f in os.listdir(REF_FIXTURES)
                           if f.endswith(".py"))
RULE_IDS = ["dense-square", "scatter-add", "host-sync", "naked-clock",
            "compat-shim", "sentinel"]
# tests/test_reprolint.py's counts
BAD_COUNTS = {"dense-square": 5, "scatter-add": 1, "host-sync": 5,
              "naked-clock": 4, "compat-shim": 4, "sentinel": 3}
GOOD_SUPPRESSED = {"dense-square": 1, "scatter-add": 1, "host-sync": 1,
                   "naked-clock": 2, "compat-shim": 0, "sentinel": 1}


def run_rule(rule_id, path):
    return lint_paths([path], scope=WIDE, select=[rule_id])


def ref_run_rule(rule_id, path):
    return ref_lint.lint_paths([path], scope=REF_WIDE, select=[rule_id])


def fixture(rule_id, kind):
    return os.path.join(FIXTURES, f"{rule_id.replace('-', '_')}_{kind}.py")


def swapped(tmp_path, name):
    """A copy of a reprolint fixture with the port's pragma token."""
    with open(os.path.join(REF_FIXTURES, name)) as fh:
        src = fh.read()
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace("reprolint:", "reprolint-torch:"))
    return str(path)


def meta(res):
    return sorted((os.path.basename(f.path), f.line, f.col, f.rule)
                  for f in res.findings if f.rule in META)


# ---------------------------------------------------------------- engine

def _parsed(parse, path):
    """(line, rules, reason) of each pragma, or the error tokenizing
    raised (parse_error.py does not tokenize)."""
    with open(path) as fh:
        src = fh.read()
    try:
        return [(p.line, p.rules, p.reason) for p in parse(src)]
    except Exception as e:  # the same error from both parsers
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", REF_FIXTURE_FILES)
def test_pragmas_parse_as_the_reference(tmp_path, name):
    assert _parsed(parse_pragmas, swapped(tmp_path, name)) == \
        _parsed(ref_parse, os.path.join(REF_FIXTURES, name))


@pytest.mark.parametrize("select", [[], ["naked-clock"]],
                         ids=["no-rules", "naked-clock"])
@pytest.mark.parametrize("name", REF_FIXTURE_FILES)
def test_meta_findings_as_the_reference(tmp_path, name, select):
    """bad-pragma, unused-pragma and parse-error on the same lines (with
    no rule, every valid pragma is unused; naked-clock is the rule both
    packages read alike on time.* calls)."""
    ref = ref_lint.lint_paths([os.path.join(REF_FIXTURES, name)],
                              scope=REF_WIDE, select=select)
    got = lint_paths([swapped(tmp_path, name)], scope=WIDE, select=select)
    assert meta(got) == meta(ref)
    assert got.files_scanned == ref.files_scanned == 1


@pytest.mark.parametrize("name", REF_FIXTURE_FILES)
def test_reports_render_as_the_reference(tmp_path, name, monkeypatch):
    """The JSON report equals the reference's once the token is read back
    and the summary line differs only in the tool's name."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ref").mkdir()
    with open(os.path.join(REF_FIXTURES, name)) as fh:
        (tmp_path / "ref" / name).write_text(fh.read())
    ref = ref_lint.lint_paths([f"ref/{name}"], scope=REF_WIDE, select=[])
    swapped(tmp_path / "port", name)
    got = lint_paths([f"port/{name}"], scope=WIDE, select=[])
    got_json = render_json(got).replace("port/", "ref/").replace(
        "reprolint-torch:", "reprolint:")
    assert got_json == ref_report.render_json(ref)
    got_text = render_text(got).replace("port/", "ref/").replace(
        "reprolint-torch:", "reprolint:")
    assert got_text == ref_report.render_text(ref)
    assert render_text(got).splitlines()[-1].startswith("reprolint-torch: ")


def test_pragma_meta_findings(tmp_path):
    res = lint_paths([swapped(tmp_path, "pragma_cases.py")], scope=WIDE,
                     select=["naked-clock"])
    by_rule = {}
    for f in res.findings:
        by_rule.setdefault(f.rule, []).append(f)
    # reason-less pragma: reported AND does not suppress its line's finding
    assert len(by_rule["bad-pragma"]) == 2  # no reason + unknown rule
    assert any(f.rule == "naked-clock" and f.line == 6
               for f in res.findings)
    assert "reprolint-torch: allow[rule]" in by_rule["bad-pragma"][0].message
    assert len(by_rule["unused-pragma"]) == 1
    # def-line pragma covers both clock reads in whole_body
    assert res.suppressed == 2
    assert res.suppressed_by_rule == {"naked-clock": 2}
    assert not any(f.line > 17 for f in by_rule.get("naked-clock", []))


def test_pragma_tokens_do_not_cross():
    """The port honours no `# reprolint:` pragma and the reference none
    of the port's, so each linter's gate can scan all of src/."""
    ours = "x = 1  # reprolint-torch: allow[sentinel] -- r\n"
    theirs = "x = 1  # reprolint: allow[sentinel] -- r\n"
    assert len(parse_pragmas(ours)) == 1 and parse_pragmas(theirs) == []
    assert len(ref_parse(theirs)) == 1 and ref_parse(ours) == []
    src = 'MSG = "# reprolint-torch: allow[sentinel] -- not a comment"\n'
    assert parse_pragmas(src) == []


def test_parse_error_is_a_finding():
    res = lint_paths([os.path.join(REF_FIXTURES, "parse_error.py")],
                     scope=WIDE)
    assert [f.rule for f in res.findings] == ["parse-error"]
    assert res.exit_code == 1


def test_json_reporter_schema():
    res = run_rule("sentinel", fixture("sentinel", "bad"))
    doc = json.loads(render_json(res))
    assert doc["exit_code"] == 1
    assert doc["counts_by_rule"] == {"sentinel": 3}
    assert doc["files_scanned"] == 1
    assert {f["rule"] for f in doc["findings"]} == {"sentinel"}
    assert all({"path", "line", "col", "rule", "message"} <= set(f)
               for f in doc["findings"])


# ----------------------------------------------------------------- rules

@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fires_where_the_reference_fires(rule_id):
    """The torch translation of the reference's bad fixture, line for
    line: the same lines, the same count."""
    ref = ref_run_rule(rule_id, os.path.join(
        REF_FIXTURES, f"{rule_id.replace('-', '_')}_bad.py"))
    res = run_rule(rule_id, fixture(rule_id, "bad"))
    assert sorted(f.line for f in res.findings) == \
        sorted(f.line for f in ref.findings)
    assert len(res.findings) == BAD_COUNTS[rule_id]
    assert all(f.rule == rule_id for f in res.findings)
    assert res.exit_code == 1


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_quiet_where_the_reference_is_quiet(rule_id):
    ref = ref_run_rule(rule_id, os.path.join(
        REF_FIXTURES, f"{rule_id.replace('-', '_')}_good.py"))
    res = run_rule(rule_id, fixture(rule_id, "good"))
    assert res.findings == [], [f.location() for f in res.findings]
    assert res.suppressed == ref.suppressed == GOOD_SUPPRESSED[rule_id]
    assert res.exit_code == 0


def test_dense_square_reference_exemption():
    # dense_square_good.py's dense_reference() allocates [n, n] with no
    # pragma; only the name-based exemption keeps it quiet
    res = run_rule("dense-square", fixture("dense-square", "good"))
    assert res.findings == []


def test_host_sync_annotated_scalar_is_not_a_sync():
    # float(scale) with `scale: float` reads a Python scalar (the
    # counterpart of a static_argnames parameter): host_sync_good.py's
    # static_step and assigned_static
    res = run_rule("host-sync", fixture("host-sync", "good"))
    assert res.findings == []


def _forms(path):
    """{form name: line} of the `# form: <name>` markers in a fixture."""
    out = {}
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            m = re.search(r"# form: (\w+)$", line.rstrip())
            if m:
                assert m.group(1) not in out, m.group(1)
                out[m.group(1)] = i
    return out


EXTRA_FORMS = {
    "dense-square": ["varargs", "varargs_attr", "batched", "new_zeros",
                     "new_ones_varargs", "new_full", "new_empty",
                     "numpy_zeros", "eye_attr"],
    "scatter-add": ["index_add", "torch_index_add", "scatter_add_",
                    "torch_scatter_add", "scatter_reduce_",
                    "torch_scatter_reduce", "index_put_kw",
                    "index_put_positional", "torch_index_put", "put_",
                    "put"],
    "host-sync": ["tolist", "cpu", "numpy", "to_cpu", "to_device_cpu",
                  "np_array", "bool", "int_of_reduction", "float_of_local",
                  "if_any", "equal", "torch_nonzero", "nonzero_method",
                  "unique", "masked_select", "masked_select_method",
                  "where_one_arg", "one_hot", "synchronize", "while_all",
                  "while_bool", "comprehension", "assert_any",
                  "nested_in_step"],
    "naked-clock": ["timed_without_sync", "sync_after_closing_read",
                    "sync_before_opening_read", "aliased_clock",
                    "time_time"],
    "compat-shim": ["private_module_import", "private_name_import",
                    "old_dtensor_home", "private_function_import",
                    "experimental_module_import", "testing_internal",
                    "private_through_alias", "private_cuda",
                    "memory_history", "private_through_module_alias",
                    "torch_c"],
    "sentinel": ["full_like", "new_full", "fill_value_kw",
                 "numpy_fill_value_kw", "not_equal"],
}


@pytest.mark.parametrize("rule_id,form", [
    (r, f) for r in RULE_IDS for f in EXTRA_FORMS[r]])
def test_torch_only_form(rule_id, form):
    """Each torch-only form fires on its line of the `_torch_extra_bad`
    fixture, and its counterpart in `_torch_extra_good` is quiet."""
    bad = fixture(rule_id, "torch_extra_bad")
    good = fixture(rule_id, "torch_extra_good")
    fired = {f.line for f in run_rule(rule_id, bad).findings}
    assert _forms(bad)[form] in fired
    quiet = {f.line for f in run_rule(rule_id, good).findings}
    assert _forms(good)[form] not in quiet


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_torch_extra_fixtures_are_whole(rule_id):
    """Every marked form is a case above; the bad fixture fires nowhere
    else and the good one nowhere at all."""
    bad = fixture(rule_id, "torch_extra_bad")
    good = fixture(rule_id, "torch_extra_good")
    assert sorted(_forms(bad)) == sorted(_forms(good)) == \
        sorted(EXTRA_FORMS[rule_id])
    res = run_rule(rule_id, bad)
    assert sorted(f.line for f in res.findings) == \
        sorted(_forms(bad).values())
    assert run_rule(rule_id, good).findings == []


# ------------------------------------------------------ host-sync vs card

# what chip_smoke.py runs under torch.cuda.set_sync_debug_mode("error")
SYNC_FREE = {
    "src/repro_torch/simulation/fluid.py": ["_saturation_batch_traced"],
    "src/repro_torch/simulation/packet.py": ["_BatchedRun.run",
                                             "_BatchedRun.cycle"],
    "src/repro_torch/kernels/minplus/ops.py": ["path_costs"],
}


def _context(path):
    with open(os.path.join(REPO_ROOT, path)) as fh:
        return FileContext(path, fh.read())


@pytest.mark.parametrize("path", sorted(SYNC_FREE))
def test_host_sync_quiet_where_the_card_sees_no_sync(path):
    """No raw host-sync finding, suppressed or not, on the lines the sync
    debug run executes."""
    ctx = _context(path)
    lines = reached_lines(ctx, SYNC_FREE[path])
    assert len(lines) > 50
    raw = [f for f in HostSyncRule().check(ctx) if f.line in lines]
    assert raw == [], [f.location() + " " + f.message for f in raw]


def test_reached_lines_follow_calls():
    """`_BatchedRun.run` reaches `cycle`, `fail` and `_record` by name, and
    a sync put into `cycle` is seen."""
    path = "src/repro_torch/simulation/packet.py"
    ctx = _context(path)
    defs = {f"{ctx.parent(fn).name}.{fn.name}": fn
            for fn in ctx.function_defs()
            if isinstance(ctx.parent(fn), ast.ClassDef)}
    lines = reached_lines(ctx, ["_BatchedRun.run"])
    for name in ("_BatchedRun.cycle", "_BatchedRun.fail",
                 "_BatchedRun._record"):
        assert defs[name].body[-1].lineno in lines
    assert defs["_BatchedRun.fetch"].body[-1].lineno not in lines
    cycle = defs["_BatchedRun.cycle"]
    src = ctx.source.splitlines()
    at = cycle.body[-1].lineno  # the last statement, `self._record(t)`
    indent = src[at - 1][:len(src[at - 1]) - len(src[at - 1].lstrip())]
    src.insert(at - 1, indent + "n_live = int(occ.sum())")
    mutated = FileContext(path, "\n".join(src) + "\n")
    hits = [f for f in HostSyncRule().check(mutated)
            if f.line in reached_lines(mutated, ["_BatchedRun.run"])]
    assert [f.line for f in hits] == [at]


# ------------------------------------------------------- gate and scope

def test_port_is_clean(monkeypatch):
    """The port's gate: zero unsuppressed findings over the port and the
    smoke script, and the documented exceptions fired."""
    monkeypatch.chdir(REPO_ROOT)
    res = lint_paths(list(DEFAULT_PATHS))
    assert res.findings == [], [f.location() + " " + f.message
                                for f in res.findings]
    assert res.suppressed > 0
    assert set(res.suppressed_by_rule) == set(RULE_IDS) - {"compat-shim"}
    assert list(DEFAULT_PATHS) == ["src/repro_torch", "chip_smoke.py"]


def test_cli_runs_without_torch_numpy_or_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    code = ("import sys; "
            "sys.modules['torch'] = sys.modules['numpy'] = "
            "sys.modules['jax'] = None; "
            "from repro_torch.analysis.lint import main; "
            "sys.exit(main([]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "reprolint-torch: 0 finding(s)" in proc.stdout


def test_cli_module_entry_point():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lint", *args],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=120)

    proc = cli("--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["findings"] == [] and doc["suppressed"] > 0
    proc = cli("--select", "sentinel,dense-square,host-sync",
               "src/repro_torch/core")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("reprolint-torch: 0 finding(s), 13 "
                                  "suppressed"), proc.stdout


def test_import_loads_no_torch():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    code = ("import sys, repro_torch.analysis.lint; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'numpy', 'jax', 'repro')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", \
        proc.stdout + proc.stderr


def test_cli_lists_all_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for r in ALL_RULES:
        assert r.id in out


def test_cli_rejects_unknown_rule():
    with pytest.raises(SystemExit):
        main(["--select", "no-such-rule", FIXTURES])


def test_default_scope_covers_every_rule():
    assert set(DEFAULT_SCOPE) == set(RULES_BY_ID)
    assert set(RULES_BY_ID) == {r.id for r in REF_RULES}


def test_reference_scope_is_not_widened():
    assert ref_lint.DEFAULT_SCOPE["naked-clock"] == (
        ("benchmarks/*.py", "src/repro/obs/*.py"), ())
    assert not any("repro_torch" in p for inc, exc in
                   ref_lint.DEFAULT_SCOPE.values() for p in inc + exc)


# files of the JAX package that the port copied and that carry pragmas
COPIED = ["core/graph.py", "core/layout.py", "core/metrics.py",
          "core/routing.py", "simulation/paths.py", "obs/record.py"]


def _pragma_lines(path, parse, token):
    with open(path) as fh:
        lines = fh.read().splitlines()
    out = {}
    for p in parse("\n".join(lines) + "\n"):
        code = lines[p.line - 1].split("# " + token)[0].rstrip()
        out[code] = (p.rules, p.reason)
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_reference_pragmas_have_port_counterparts(rel):
    """Each reference pragma in a file the port copied: a port pragma on
    the line with the same code, naming the same rule, with the same
    reason."""
    ref = _pragma_lines(os.path.join(REPO_ROOT, "src", "repro", rel),
                        ref_parse, "reprolint:")
    port = _pragma_lines(os.path.join(REPO_ROOT, "src", "repro_torch", rel),
                         parse_pragmas, "reprolint-torch:")
    assert ref
    for code, want in ref.items():
        assert port.get(code) == want, code


def test_scatter_fallback_keeps_the_reference_reason():
    ref = _pragma_lines(os.path.join(REPO_ROOT, "src", "repro", "simulation",
                                     "fluid.py"), ref_parse, "reprolint:")
    port = _pragma_lines(os.path.join(REPO_ROOT, "src", "repro_torch",
                                      "simulation", "fluid.py"),
                         parse_pragmas, "reprolint-torch:")
    (rules, reason), = ref.values()
    assert ("scatter-add",) == rules
    assert (rules, reason) in port.values()


def test_known_defect_pragma_names_its_roadmap_item():
    port = _pragma_lines(os.path.join(REPO_ROOT, "src", "repro_torch", "core",
                                      "routing.py"),
                         parse_pragmas, "reprolint-torch:")
    reason = port["            if not bool(newly.any()):"][1]
    assert "ROADMAP item 14" in reason


# ------------------------------------------------------------------ shim

def test_compat_local_map_is_torch_local_map():
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel import compat

    assert compat.local_map is local_map
    assert compat.active_fake_mode() is None
    assert compat.current_autograd_node() is None
    assert compat.profiler_enabled() is False
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert compat.profiler_enabled() is True
    with pytest.raises(AttributeError):
        compat.no_such_name  # noqa: B018


def test_compat_shim_rule_excludes_only_the_shims():
    include, exclude = DEFAULT_SCOPE["compat-shim"]
    assert include == ("*",)
    assert set(exclude) == {"src/repro_torch/parallel/compat.py",
                            "src/repro_torch/launch/mesh.py"}


def test_package_exports_resolve_device_lazily():
    from repro_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
