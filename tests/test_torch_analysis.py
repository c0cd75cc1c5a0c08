"""The port's static analysis (after tests/test_analysis.py): the lint
rules R1, R2, R3 and R5 over ``src/repro_torch``, allowlists, the report,
the CLI, and schedule conformance over the collective log.

Each rule runs on fixture sources written for ``repro_torch`` and must
give the verdicts the reference's rule gives on the ``repro`` versions
(the reference linter runs in this process: it is pure AST, and its R5
imports the reference registry).  The reference's R4 (``pure_callback``
closures) has no counterpart in eager torch and is not ported; the HLO
parse cases have none either (the collective log stands in for it).

Conformance: ``expected_collectives`` must equal the reference's in
every registry cell (the reference runs once in a subprocess with 8
forced host devices, this file run as a script), every cell must
conform on 8 stacked ranks and on 4 gloo ranks (this file run as a
script, one process a rank, each rank's log gathered), and each
corruption of a real log must flip its verdict.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_spawn import join, save, spawn  # noqa: E402
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

WORLD = 4
SHAPE = dict(m=64, n=64, r=16, c=2, nnz_row=4)


def _port_lint(path, code):
    from repro_torch.analysis import lint
    return lint.lint_file(path, textwrap.dedent(code))


def _ref_lint(path, code):
    from repro.analysis import lint
    return lint.lint_file(path, textwrap.dedent(code))


def _verdicts(found):
    return [(f.rule, f.line) for f in found]


# ---------------------------------------------------------------------------
# Per-file rules on fixture sources, against the reference's verdicts
# ---------------------------------------------------------------------------

# (path under the package, source); "{pkg}" is repro or repro_torch
FIXTURES = {
    "r1_eager": ("{pkg}/core/fake.py", """
        import numpy as np
        from {pkg}.obs import tracer
    """),
    "r1_lazy": ("{pkg}/core/fake.py", """
        def f():
            from {pkg}.obs import tracer
            return tracer.active()
    """),
    "r1_upper_layer": ("{pkg}/training/fake.py", """
        from {pkg}.serving import batcher
    """),
    "r1_conditional": ("{pkg}/kernels/fake.py", """
        try:
            import {pkg}.training.loop
        except ImportError:
            pass
    """),
    "r1_class_body": ("{pkg}/core/fake.py", """
        class A:
            import {pkg}.serving.pool as pool
    """),
    "r2_bad": ("{pkg}/core/fake.py", """
        class DistProblem:
            def sddmm(self, X, Y):
                return self._run(X, Y)
    """),
    "r2_guard_only": ("{pkg}/core/fake.py", """
        class DistProblem:
            def fusedmm(self, X, Y):
                faults.guard("fusedmm", self)
                return self._run(X, Y)
    """),
    "r2_good": ("{pkg}/core/fake.py", """
        class DistProblem:
            def sddmm(self, X, Y):
                faults.guard("sddmm", self)
                tr = _tracer_active()
                return self._run(X, Y)
    """),
    "r2_other_class": ("{pkg}/core/fake.py", """
        class Other:
            def sddmm(self):
                pass
    """),
    "r3_zeros_todense": ("{pkg}/kernels/fake.py", """
        def f(prob, S):
            out = np.zeros((prob.m, prob.n))
            return out + S.todense()
    """),
    "r3_sharded": ("{pkg}/core/fake.py", """
        def f(prob):
            return np.zeros((prob.m, prob.r))
    """),
    "r3_transposed": ("{pkg}/core/fake.py", """
        def f(m, n):
            return jnp.ones((n, m))
    """),
    "r3_cold_path": ("{pkg}/obs/fake.py", """
        def f(m, n):
            return np.zeros((m, n))
    """),
    "r3_serving": ("{pkg}/serving/fake.py", """
        def f(dep):
            return np.full([dep.m, dep.n], 0.0)
    """),
}


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_rules_give_the_references_verdicts(case):
    path, code = FIXTURES[case]
    want = _verdicts(_ref_lint(path.format(pkg="repro"),
                               code.format(pkg="repro")))
    got = _port_lint(path.format(pkg="repro_torch"),
                     code.format(pkg="repro_torch"))
    assert _verdicts(got) == want
    assert all(f.path.startswith("repro_torch/") for f in got)


def test_r2_flags_both_missing_checks():
    found = _port_lint("repro_torch/core/fake.py",
                       FIXTURES["r2_bad"][1].format(pkg="repro_torch"))
    assert len(found) == 2
    assert all(f.symbol == "DistProblem.sddmm" for f in found)


def test_r3_flags_torch_allocations_and_to_dense():
    found = _port_lint("repro_torch/core/fake.py", """
        def f(prob, S, x, m, n):
            a = torch.zeros(m, n)
            b = x.new_zeros((prob.n, prob.m))
            c = torch.empty(prob.m, prob.n, device=x.device)
            d = torch.full((m, n), 1.0)
            e = torch.zeros(prob.m, prob.r)
            return S.to_dense()
    """)
    assert _verdicts(found) == [("R3", 3), ("R3", 4), ("R3", 5), ("R3", 6),
                                ("R3", 8)]


def _with_line(src, anchor, line):
    assert anchor in src
    return src.replace(anchor, anchor + line, 1)


def test_r1_flags_the_old_eager_imports():
    """The eager forms this slice repaired: core/api.py's module-scope
    import of the metrics registry and core/common.py's of compression."""
    from repro_torch.analysis import lint
    root = lint.default_src_root()
    for rel, line in (("repro_torch/core/api.py",
                       "from repro_torch.obs import metrics as "
                       "obs_metrics\n"),
                      ("repro_torch/core/common.py",
                       "from repro_torch.training import compression\n")):
        with open(os.path.join(root, rel)) as f:
            src = f.read()
        assert not [x for x in lint.lint_file(rel, src) if x.rule == "R1"]
        old = _with_line(src, "import torch\n\n", line)
        found = [x for x in lint.lint_file(rel, old) if x.rule == "R1"]
        assert len(found) == 1 and found[0].symbol == line.split()[1]


# ---------------------------------------------------------------------------
# R5 - registry cells (fake registries; the live one must be clean)
# ---------------------------------------------------------------------------

class _FakeSched:
    @staticmethod
    def schedule_events(grid, op, elision="none"):
        return [("phase", 0), ("shift", 0)]

    @staticmethod
    def schedule_words(grid, plan, op, elision="none",
                       pre_gathered=False):
        return []


class _FakeAlg:
    def __init__(self, sched):
        self._sched_mod = sched
        self.elisions = ("none",)


class _NoWords:
    schedule_events = _FakeSched.schedule_events


class _Raises:
    @staticmethod
    def schedule_events(grid, op, elision="none"):
        raise ValueError("boom")
    schedule_words = _FakeSched.schedule_words


class _BadWords:
    schedule_events = _FakeSched.schedule_events

    @staticmethod
    def schedule_words(grid, op):
        return []


@pytest.mark.parametrize("sched", [_FakeSched, _NoWords, _Raises,
                                   _BadWords, None])
def test_r5_gives_the_references_verdicts(sched):
    from repro.analysis.rules.r5_registry_cells import \
        check_registry as ref_check
    from repro_torch.analysis.rules.r5_registry_cells import check_registry
    reg = {"fake": _FakeAlg(sched)}
    want = [(f.symbol, f.message) for f in ref_check(reg)]
    got = [(f.symbol, f.message) for f in check_registry(reg)]
    assert got == want
    assert bool(got) == (sched is not _FakeSched)


def test_r5_live_registry_is_clean():
    from repro_torch.analysis.rules.r5_registry_cells import check_registry
    assert check_registry() == []


# ---------------------------------------------------------------------------
# Allowlists, the real tree, the CLI, the report
# ---------------------------------------------------------------------------

def test_allowlist_marks_but_keeps_findings():
    from repro_torch.analysis import findings as F
    entries = F.parse_allowlist("""
        # comment
        repro_torch/core/*.py::to_dense -- debug-only view
    """)
    hit = F.Finding("R3", "repro_torch/core/api.py", 10, "msg",
                    symbol="SparseResult.to_dense")
    miss = F.Finding("R3", "repro_torch/core/api.py", 20, "msg",
                     symbol="hot_path")
    out = F.apply_allowlist([hit, miss], entries)
    assert out[0].allowlisted and out[0].note == "debug-only view"
    assert not out[1].allowlisted
    assert F.violations(out) == [miss]


def test_four_rules_each_with_a_reasoned_allowlist():
    from repro_torch.analysis.rules import all_rules
    rules = all_rules()
    assert sorted(rules) == ["R1", "R2", "R3", "R5"]
    for rule in rules.values():
        for entry in rule.allowlist():
            assert entry.reason, (rule.id, entry)


def test_repo_lints_clean_with_documented_allowlists():
    from repro_torch.analysis import findings as F
    from repro_torch.analysis import lint
    findings, scanned = lint.run_lint()
    assert scanned > 40
    bad = F.violations(findings)
    assert not bad, "\n".join(f.render() for f in bad)
    assert any(f.allowlisted and f.rule == "R3"
               and "to_dense" in f.symbol for f in findings)
    assert all(f.path.startswith("repro_torch/") for f in findings)


def test_cli_exits_nonzero_on_violating_tree(tmp_path, monkeypatch):
    from repro_torch.analysis.__main__ import main
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text("from repro_torch.obs import tracer\n")
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    assert main(["lint", "--root", str(tmp_path / "src")]) == 1
    assert main(["lint"]) == 0          # the real tree is clean
    assert os.listdir(work) == []       # no report unless one is named
    assert main(["lint", "--report", str(work / "r.json")]) == 0
    assert json.load(open(work / "r.json"))["lint"]["violations"] == 0


def test_report_json_round_trip(tmp_path):
    from repro_torch.analysis import findings as F
    from repro_torch.analysis import lint
    findings, scanned = lint.run_lint(with_registry=False)
    report = {"schema": 1, "lint": F.lint_report(findings, scanned)}
    path = str(tmp_path / "report.json")
    F.write_report(report, path)
    loaded = F.load_report(path)
    assert loaded == json.loads(json.dumps(report))
    back = F.findings_from_report(loaded)
    assert [f.to_dict() for f in back] == [f.to_dict() for f in findings]


# ---------------------------------------------------------------------------
# Conformance against the reference's schedule, on stacked ranks
# ---------------------------------------------------------------------------

def _key(spec):
    return "/".join(str(spec[k]) for k in ("family", "comm", "op",
                                            "elision", "session"))


def _reference():
    """Subprocess body: the reference's expected collectives and Session
    sensitivity of every registry cell at its sweep shape (nothing is
    lowered)."""
    from repro.analysis import conformance as jconf
    from repro.core import api as japi
    probs, out = {}, {}
    for spec in jconf.conformance_cells():
        key = (spec["family"], spec["comm"])
        if key not in probs:
            probs[key] = jconf._make_problem(*key, **SHAPE)
        prob = probs[key]
        exp = jconf.expected_collectives(
            prob, spec["op"], spec["elision"],
            session=japi.Session() if spec["session"] else None)
        sens = jconf._session_sensitive(
            probs[key] if spec["comm"] == "dense" else prob,
            spec["op"], spec["elision"])
        out[_key(spec)] = [None if exp is None else [list(e) for e in exp],
                           sens]
    print(json.dumps(out))


@pytest.fixture(scope="module")
def reference_expected():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "reference"],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _cpu(p):
    import torch
    return [torch.device("cpu")] * p


_PROBS = {}


def _prob_of(fam, comm):
    """The sweep's problem of (family, comm) on 8 stacked ranks (cached)."""
    from repro_torch.analysis import conformance as C
    if (fam, comm) not in _PROBS:
        _PROBS[fam, comm] = C.make_cell_problem(fam, comm, devices=_cpu(8),
                                                **SHAPE)
    return _PROBS[fam, comm]


def test_expected_collectives_equal_the_references(reference_expected):
    from repro_torch.analysis import conformance as C
    from repro_torch.core import api
    cells = C.conformance_cells()
    assert sorted(_key(s) for s in cells) == sorted(reference_expected)
    for spec in cells:
        prob = _prob_of(spec["family"], spec["comm"])
        exp = C.expected_collectives(
            prob, spec["op"], spec["elision"],
            session=api.Session() if spec["session"] else None)
        want, sens = reference_expected[_key(spec)]
        got = None if exp is None else [list(e) for e in exp]
        assert got == want, _key(spec)
        assert C.session_sensitive(prob, spec["op"],
                                   spec["elision"]) == sens, _key(spec)


def test_every_cell_conforms_on_eight_stacked_ranks():
    from repro_torch.analysis import conformance as C
    rep = C.run_conformance(devices=_cpu(8))
    bad = [(r["cell"], r["errors"]) for r in rep["cells"]
           if r["verdict"] != "pass"]
    assert not bad, bad
    assert rep["p"] == 8 and rep["fail"] == 0
    dense = [r for r in rep["cells"] if r["comm"] == "dense"]
    sparse = [r for r in rep["cells"] if r["comm"] == "sparse"]
    assert all(r["mode"] == "full" for r in dense)
    assert all(r["mode"] == "structural" for r in sparse)
    assert len(sparse) == rep["structural"] == len(dense)
    for r in dense:
        assert r["measured_words"] == r["modeled_words"], r["cell"]
        assert set(r["checks"]) == {"sequence", "groups", "rendezvous"}


def _real(fam="s25", op="fusedmm", el="none"):
    """A real stacked cell: (problem, its log's collectives, the
    schedule's expected events)."""
    from repro_torch.analysis import conformance as C
    prob = _prob_of(fam, "dense")
    X = np.ones((SHAPE["m"], SHAPE["r"]), np.float32)
    log = C.run_cell(prob, op, el, None, X, X)
    return prob, C.log_collectives(prob.grid, log), \
        C.expected_collectives(prob, op, el)


def _errors(prob, colls, expected):
    from repro_torch.analysis import conformance as C
    seq = C.match_sequence([(e.kind, e.words) for e in expected],
                           C.fold_moves(colls))
    groups = C.check_groups(colls, prob.p)
    sim = C.simulate_rendezvous(C.rank_programs(colls, prob.p))
    return seq, groups, sim


def test_a_real_log_conforms_and_each_corruption_flips_it():
    import dataclasses
    prob, colls, exp = _real()
    seq, groups, sim = _errors(prob, colls, exp)
    assert seq == [] and groups == [] and sim["ok"]
    kinds = [c.kind for c in colls]
    assert kinds.count("reduce-scatter") == 1 and "all-gather" in kinds
    # a dropped event
    assert _errors(prob, colls[:-1], exp)[0]
    # a duplicated event (folds into its point: the words double)
    dup = colls + [colls[-1]]
    assert any("words" in e for e in _errors(prob, dup, exp)[0])
    # a swapped pair of different kinds
    i = kinds.index("reduce-scatter")
    sw = list(colls)
    sw[i], sw[i + 1] = sw[i + 1], sw[i]
    assert any("sequence" in e for e in _errors(prob, sw, exp)[0])
    # wrong words
    bad = list(colls)
    bad[0] = dataclasses.replace(bad[0], words=bad[0].words + 1)
    assert any("words" in e for e in _errors(prob, bad, exp)[0])
    # a broken group partition
    bad = list(colls)
    bad[i] = dataclasses.replace(bad[i], groups=bad[i].groups[1:])
    assert any("full mesh" in e for e in _errors(prob, bad, exp)[1])
    # a permute that is not a permutation
    j = kinds.index("collective-permute")
    pairs = bad[j].pairs
    bad[j] = dataclasses.replace(bad[j], pairs=((pairs[0][0], pairs[1][1]),)
                                 + pairs[1:])
    assert any("permutation" in e for e in _errors(prob, bad, exp)[1])
    # one rank skips a collective: the simulation deadlocks
    from repro_torch.analysis import conformance as C
    prog = C.rank_programs(colls, prob.p)
    prog[3] = prog[3][1:]
    sim = C.simulate_rendezvous(prog)
    assert not sim["ok"] and 3 in sim["stuck"]


def test_verify_cell_fails_a_corrupted_schedule_and_per_rank_logs():
    from repro_torch.analysis import conformance as C
    prob, colls, exp = _real("d15", "fusedmm", "fused")
    X = np.ones((SHAPE["m"], SHAPE["r"]), np.float32)
    ok = C.verify_cell(prob, "fusedmm", "fused", None, X, X)
    assert ok.ok and ok["mode"] == "full"
    row = C.verify_cell(prob, "fusedmm", "fused", None, X, X,
                        expected_override=exp[1:])
    assert not row.ok and row["checks"]["sequence"] == "fail"
    logs = {r: list(colls) for r in range(prob.p)}
    assert C.verify_cell(prob, "fusedmm", "fused", None, X, X,
                         logs=logs).ok
    logs[5] = logs[5][:2] + logs[5][3:]
    row = C.verify_cell(prob, "fusedmm", "fused", None, X, X, logs=logs)
    assert row["checks"]["rendezvous"] == "fail"


# ---------------------------------------------------------------------------
# The pure matcher and simulator on hand-built programs
# ---------------------------------------------------------------------------

GROUPS8 = ((0, 1), (2, 3), (4, 5), (6, 7))
RING8 = tuple((i, (i + 2) % 8) for i in range(8))


def _coll(kind, words, *, groups=None, pairs=None, i=0, point=None):
    from repro_torch.analysis.conformance import Collective
    return Collective(f"{kind}.{i}", kind, "fiber", float(words), point,
                      groups=groups, pairs=pairs)


def _schedule():
    return [("all-gather", 64.0), ("collective-permute", 32.0),
            ("collective-permute", 32.0), ("reduce-scatter", 64.0)]


def _matching():
    return [_coll("all-gather", 64, groups=GROUPS8, i=1),
            _coll("collective-permute", 32, pairs=RING8, i=2),
            _coll("collective-permute", 32, pairs=RING8, i=3),
            _coll("reduce-scatter", 64, groups=GROUPS8, i=4)]


def test_match_sequence_accepts_and_catches_corruptions():
    from repro_torch.analysis.conformance import fold_moves, match_sequence
    got = fold_moves(_matching())
    assert match_sequence(_schedule(), got) == []
    assert match_sequence(_schedule()[1:], got)
    bad = _schedule()
    bad[-1] = ("all-gather", 64.0)
    assert match_sequence(bad, got)
    bad = _schedule()
    bad[1] = ("collective-permute", 999.0)
    errors = match_sequence(bad, got)
    assert errors and "words" in errors[0]
    swapped = _schedule()
    swapped.insert(1, swapped.pop(-1))
    assert match_sequence(swapped, got)


def test_moves_of_one_point_fold_into_one_event():
    """One shift event may move several tensors (a traveling pack and
    its partial dots): tagged with one point they are one event."""
    from repro_torch.analysis.conformance import fold_moves, match_sequence
    moves = [_coll("collective-permute", 32, pairs=RING8, i=i,
                   point=("shift", 0)) for i in range(3)]
    assert fold_moves(moves) == [("collective-permute", 96.0)]
    assert match_sequence([("collective-permute", 96.0)],
                          fold_moves(moves)) == []
    untagged = [_coll("collective-permute", 32, pairs=RING8, i=i)
                for i in range(3)]
    assert len(fold_moves(untagged)) == 3


def test_rendezvous_drains_and_catches_corruptions():
    from repro_torch.analysis.conformance import (rank_programs,
                                                  simulate_rendezvous)
    prog = rank_programs(_matching(), 8)
    sim = simulate_rendezvous(prog)
    assert sim["ok"] and sim["fired"] == 2 * len(GROUPS8) + 2
    prog = rank_programs(_matching(), 8)
    prog[3] = prog[3][1:]
    sim = simulate_rendezvous(prog)
    assert not sim["ok"] and 3 in sim["stuck"]
    prog = rank_programs(_matching(), 8)
    prog[5][0], prog[5][1] = prog[5][1], prog[5][0]
    assert not simulate_rendezvous(prog)["ok"]
    prog = rank_programs(_matching(), 8)
    prog[0].append(prog[0][-1])
    sim = simulate_rendezvous(prog)
    assert not sim["ok"] and 0 in sim["stuck"]
    a, b = (0, (0, 1), "all-gather"), (1, (2, 3), "all-gather")
    assert simulate_rendezvous({0: [a], 1: [a], 2: [b], 3: [b]})["ok"]


def test_check_groups_rejects_partial_mesh_and_bad_permutation():
    from repro_torch.analysis.conformance import check_groups
    assert check_groups(_matching(), 8) == []
    bad = [_coll("all-gather", 64, groups=((0, 1), (2, 3)))]
    assert any("full mesh" in e for e in check_groups(bad, 8))
    bad = [_coll("all-gather", 64, groups=((0, 1), (1, 2, 3, 4, 5, 6, 7)))]
    assert any("overlap" in e or "unequal" in e
               for e in check_groups(bad, 8))
    bad = [_coll("collective-permute", 32, pairs=((0, 2), (1, 2)))]
    assert any("permutation" in e for e in check_groups(bad, 8))


def test_groups_come_from_the_grid_axes():
    """A fiber all-gather on a (4, 2) grid runs in the 4 fibers; a shift
    on "layer" pairs each rank with the next layer's."""
    from repro_torch.analysis.conformance import log_collectives
    from repro_torch.core.collectives import Event
    from repro_torch.core.grid import make_grid15
    grid = make_grid15(2, devices=_cpu(8))
    colls = log_collectives(grid, [
        Event("all-gather", "fiber", 8.0, ("gather", 0)),
        Event("collective-permute", "layer", 4.0, ("shift", 0), 1),
        Event("collective-permute", "layer", 4.0, None, 4)])
    assert colls[0].groups == ((0, 1), (2, 3), (4, 5), (6, 7))
    assert colls[1].pairs == tuple((i, (i + 2) % 8) for i in range(8))
    assert len(colls) == 2          # a permute by the axis size is no move


# ---------------------------------------------------------------------------
# Conformance on 4 gloo ranks: every rank's own log, gathered
# ---------------------------------------------------------------------------

#: the families' c at p = 4 (a 2.5D grid needs p / c square)
GLOO_C = {"d15": 2, "s15": 2, "d25": 1, "s25": 1}


def _worker(rank, world, init, out_dir):
    dist = join(rank, world, init)
    from repro_torch.analysis import conformance as C
    try:
        rows = []
        for fam, c in GLOO_C.items():
            rep = C.run_conformance(family=fam, devices=_cpu(world),
                                    group=dist.group.WORLD,
                                    **dict(SHAPE, c=c))
            rows += [[r["cell"], r["verdict"], r["mode"], r["errors"]]
                     for r in rep["cells"]]
        # one rank's copy of the gathered logs skips a collective
        prob = C.make_cell_problem("d15", "dense", devices=_cpu(world),
                                   group=dist.group.WORLD,
                                   **dict(SHAPE, c=2))
        X = np.ones((SHAPE["m"], SHAPE["r"]), np.float32)
        logs = C.gather_logs(prob.grid,
                             C.run_cell(prob, "fusedmm", "fused", None, X, X))
        drained = C.simulate_rendezvous(
            C.rank_programs_from_logs(logs, world))["ok"]
        logs[1] = logs[1][1:]
        broken = C.simulate_rendezvous(
            C.rank_programs_from_logs(logs, world))
    finally:
        dist.destroy_process_group()
    save(out_dir, rank, {}, {"cells": rows, "drained": drained,
                             "broken": broken})


def test_every_cell_conforms_on_gloo_ranks(tmp_path):
    ranks = spawn(__file__, WORLD, str(tmp_path))
    first = ranks[0][1]["cells"]
    assert len(first) > 30
    for _, rec in ranks:
        assert rec["cells"] == first
        bad = [c for c in rec["cells"] if c[1] != "pass"]
        assert not bad, bad
        assert rec["drained"]
        assert not rec["broken"]["ok"] and "1" in rec["broken"]["stuck"]
    assert {c[2] for c in first} == {"full", "structural"}


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5])
    elif sys.argv[1] == "reference":
        _reference()
