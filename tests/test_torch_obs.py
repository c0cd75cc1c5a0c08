"""The port's observability (after tests/test_obs.py), its kernel router
(after tests/test_api.py's routing case), ``Session.clear`` and
``sparse.pack_coo``, held to the reference on the CPU.

The reference's tracer runs once in a subprocess with 8 forced host
devices (this file run as a script): for every family and cell of the
registry, with and without a Session, it opens a round span
(``measure_wire=False``) and reports the span's events (point, phase,
kind, modeled words) and modeled total.  Here the port traces the same
cells on 8 stacked ranks and must give the same spans, with a drift of
exactly 1.0 on every dense round.  One traced cell also runs on 4 gloo
ranks (this file run as a script, one process a rank).  The registry
cases of tests/test_obs.py are the copied ``obs/metrics.py``'s, held by
tests/test_torch_faults.py, and are not repeated.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_spawn import join, save, spawn  # noqa: E402
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

FAMILIES = ("d15", "s15", "d25", "s25")
M = N = 64
R, C, P = 16, 2, 8
WORLD = 4


def _data():
    from repro_torch.core import sparse
    rows, cols, _ = sparse.erdos_renyi(M, N, 4, seed=0)
    rng = np.random.default_rng(0)
    vals = rng.integers(1, 5, rows.shape[0]).astype(np.float32)
    X = rng.integers(-3, 4, (M, R)).astype(np.float32)
    Y = rng.integers(-3, 4, (N, R)).astype(np.float32)
    return rows, cols, vals, X, Y


def _cells(elisions):
    out = [(op, "none") for op in ("sddmm", "spmm", "spmm_t")]
    out += [("fusedmm", el) for el in elisions]
    return [(op, el, sess) for op, el in out for sess in (False, True)]


def _spans(rounds):
    return [{"op": r.op, "elision": r.elision, "round": r.round,
             "session": r.session, "modeled": r.modeled_words,
             "events": [[e.point, e.phase, e.kind, e.words]
                        for e in r.events]} for r in rounds]


def _reference():
    """Subprocess body: the reference tracer's spans of every cell at
    p = 8 (round hooks opened directly: nothing runs)."""
    import jax
    from repro.core import api as japi
    from repro.obs import tracer as jtracer
    rows, cols, vals, _, _ = _data()
    out = {}
    for fam in FAMILIES:
        prob = japi.make_problem(rows, cols, vals, (M, N), R,
                                 algorithm=fam, c=C,
                                 devices=jax.devices()[:P])
        tr = jtracer.Tracer(measure_wire=False)
        for op, el, sess in _cells(prob.alg.elisions):
            with tr.round(prob, op, elision=el,
                          session=japi.Session() if sess else None):
                pass
        out[fam] = _spans(tr.rounds)
    print(json.dumps(out))


@pytest.fixture(scope="module")
def reference_spans():
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


def _cpu(p=1):
    import torch
    return [torch.device("cpu")] * p


def _problem(fam, p=P, **kw):
    from repro_torch.core import api
    rows, cols, vals, X, Y = _data()
    prob = api.make_problem(rows, cols, vals, (M, N), R, algorithm=fam,
                            c=C if p > 1 else None, devices=_cpu(p), **kw)
    return prob, X, Y


def _call(prob, op, el, session, X, Y):
    if op == "sddmm":
        return prob.sddmm(X, Y, session=session)
    if op == "spmm":
        return prob.spmm(Y, session=session)
    if op == "spmm_t":
        return prob.spmm_t(X, session=session)
    return prob.fusedmm(X, Y, elision=el, session=session)


def _tensors(res):
    from repro_torch.core import api
    if isinstance(res, tuple):
        return [t for r in res for t in _tensors(r)]
    if isinstance(res, api.SparseResult):
        return [res.values_tensor()]
    return [res]


# ---------------------------------------------------------------------------
# Spans and drift at p = 8 against the reference's tracer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_spans_equal_the_reference_and_drift_is_one(reference_spans, fam):
    """Every cell of the family traced on 8 stacked ranks: the spans'
    events, modeled words and round counters equal the reference
    tracer's, each event's modeled words sum to the round's model, the
    measured words (the collective log) give a drift of exactly 1.0, and
    each traced result equals the untraced one bit for bit."""
    import torch
    from repro_torch import obs
    from repro_torch.core import api
    prob, X, Y = _problem(fam)
    cells = _cells(prob.alg.elisions)
    base = [_tensors(_call(prob, op, el, api.Session() if s else None,
                           X, Y)) for op, el, s in cells]
    with obs.trace() as tr:
        got = [_tensors(_call(prob, op, el, api.Session() if s else None,
                              X, Y)) for op, el, s in cells]
    assert _spans(tr.rounds) == reference_spans[fam]
    for r in tr.rounds:
        assert r.modeled_words == sum(e.words for e in r.events)
        assert r.drift == 1.0, (r.op, r.elision, r.session, r.drift)
        assert r.measured_words["total"] == r.modeled_words
        assert r.error is None and r.device_ms is None
    for a, b in zip(base, got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("fam", FAMILIES)
def test_sparse_rounds_have_no_model_and_no_drift(fam):
    from repro_torch import obs
    prob, X, Y = _problem(fam, comm="sparse")
    with obs.trace() as tr:
        prob.sddmm(X, Y)
        prob.fusedmm(X, Y, elision=prob.alg.elisions[0])
    for r in tr.rounds:
        assert r.comm == "sparse" and r.modeled_words is None
        assert r.drift is None and r.measured_words["total"] > 0
        assert all(e.words is None and e.kind is None for e in r.events)
        assert len(r.events) == len(prob.alg.schedule_events(
            prob, r.op, r.elision))
    assert tr.drifts() == []


def test_event_spans_carry_their_moves():
    """Each event span counts the moves tagged with its schedule point;
    compute phases move nothing.  On the CPU no device time is read."""
    from repro_torch import obs
    prob, X, Y = _problem("d25")
    with obs.trace() as tr:
        prob.fusedmm(X, Y, elision="fused")
    (r,) = tr.rounds
    log = prob.last_collectives.log
    assert sum(e.moves for e in r.events) == len(log)
    for e in r.events:
        assert (e.moves > 0) == bool(e.words)
        assert e.device_ms is None


def test_move_timer_spans_every_move(monkeypatch):
    """The per-move timer (obs.moves) on a stacked grid, with CUDA's
    events and streams replaced by host stand-ins: one span a move of the
    log, in order, and by_kind's bytes the log's words.  It refuses a
    grid that is not on a card."""
    import torch
    from repro_torch.obs import moves

    class Ev:
        def __init__(self, **kw):
            self.t = None

        def record(self, stream=None):
            self.t = len(stamps)
            stamps.append(self)

        def elapsed_time(self, other):
            return float(other.t - self.t)

    stamps = []
    monkeypatch.setattr(torch.cuda, "Event", Ev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    prob, X, Y = _problem("d15")
    with pytest.raises(ValueError, match="CUDA events"):
        moves.timed_backend(prob.grid)
    coll = moves.TimedStacked(prob.grid)
    fn, args, kwargs, _ = prob.alg._fusedmm_call(prob, X, Y, "none", None)
    fn(*args, **kwargs, coll=coll)
    assert [s.event for s in coll.spans] == coll.log
    assert all(s.ms == 1.0 for s in coll.spans)
    kinds = coll.by_kind()
    assert sum(k["moves"] for k in kinds.values()) == len(coll.log)
    assert sum(k["bytes"] for k in kinds.values()) == \
        4 * sum(e.words for e in coll.log)


# ---------------------------------------------------------------------------
# The tracer on one rank (tests/test_obs.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_schedule_words_aligns_with_schedule_events(fam):
    prob, _, _ = _problem(fam, p=1)
    for op in ("sddmm", "spmm", "spmm_t"):
        ev = prob.alg.schedule_events(prob, op)
        words = prob.schedule_words(op)
        assert [(p, t) for p, t, _, _ in words] == ev
        for _, _, kind, w in words:
            assert w >= 0.0
            assert kind in (None, "all-gather", "reduce-scatter",
                            "collective-permute")
    for el in prob.alg.elisions:
        ev = prob.alg.schedule_events(prob, "fusedmm", el)
        words = prob.schedule_words("fusedmm", el)
        assert [(p, t) for p, t, _, _ in words] == ev


def test_trace_records_round_and_event_spans():
    from repro_torch import obs
    prob, X, Y = _problem("d15", p=1)
    with obs.collect() as reg, obs.trace(measure_wire=False) as tr:
        prob.sddmm(X, Y)
        prob.fusedmm(X, Y, elision="fused")
    assert [r.op for r in tr.rounds] == ["sddmm", "fusedmm"]
    r0 = tr.rounds[0]
    assert r0.family == "d15" and r0.comm == "dense" and r0.p == 1
    assert len(r0.events) == len(prob.alg.schedule_events(prob, "sddmm"))
    assert r0.dur >= 0 and all(e.dur >= 0 for e in r0.events)
    assert sum(e.dur for e in r0.events) == pytest.approx(r0.dur)
    assert r0.measured_words is None and r0.drift is None
    assert reg.value("executor.rounds", op="sddmm", family="d15") == 1
    assert reg.histogram("executor.round_seconds", op="fusedmm",
                         family="d15")["count"] == 1


def test_injected_clock_times_the_rounds():
    from repro_torch import obs
    ticks = iter(range(100))
    prob, X, Y = _problem("s15", p=1)
    with obs.trace(clock=lambda: float(next(ticks))) as tr:
        prob.spmm(Y)
        prob.spmm(Y)
    assert [(r.t0, r.dur) for r in tr.rounds] == [(1.0, 1.0), (3.0, 1.0)]
    assert [r.round for r in tr.rounds] == [0, 1]


def test_modeled_words_equal_the_reference_tracer_on_one_rank():
    """The reference's tracer in this process (one host device) and the
    port's give the same spans in every family and cell."""
    import jax
    from repro.core import api as japi
    from repro.obs import tracer as jtracer
    from repro_torch import obs
    from repro_torch.core import api
    rows, cols, vals, _, _ = _data()
    for fam in FAMILIES:
        jprob = japi.make_problem(rows, cols, vals, (M, N), R,
                                  algorithm=fam, devices=jax.devices()[:1])
        prob, X, Y = _problem(fam, p=1)
        jtr = jtracer.Tracer(measure_wire=False)
        with obs.trace(measure_wire=False) as tr:
            for op, el, s in _cells(prob.alg.elisions):
                with jtr.round(jprob, op, elision=el,
                               session=japi.Session() if s else None):
                    pass
                _call(prob, op, el, api.Session() if s else None, X, Y)
        assert _spans(tr.rounds) == _spans(jtr.rounds), fam


def test_traced_error_round_is_recorded_and_reraised():
    from repro_torch import obs
    prob, X, Y = _problem("d15")
    with obs.trace(measure_wire=False) as tr:
        with pytest.raises(ValueError):
            prob.fusedmm(X, Y, elision="nonsense")
    # elision validation fails before the round hook: nothing recorded
    assert tr.rounds == []
    with obs.trace() as tr:
        prob.sddmm(X, Y)                 # leaves a log on the problem
        with pytest.raises(TypeError):
            with tr.round(prob, "sddmm"):
                raise TypeError("boom")
    assert tr.rounds[0].drift == 1.0
    dead = tr.rounds[1]
    assert dead.error == "TypeError" and dead.round == 1
    # the previous call's log is not read as the dead round's words
    assert dead.measured_words is None and dead.drift is None


def test_elastic_retry_traces_each_attempt_as_its_own_round(monkeypatch):
    """A fault inside the executor, after its first collective: the dead
    attempt is a round with its error and no measured words, the retry a
    round of its own with drift 1.0."""
    from repro_torch import obs
    from repro_torch.core import api, d15
    from repro_torch.distributed import faults
    prob, X, Y = _problem("d15")
    want = prob.sddmm(X, Y).values_tensor()
    real = d15.sddmm_d15
    fired = []

    def flaky(grid, plan, A, B, *a, coll=None, **kw):
        if not fired:
            fired.append(1)
            coll.all_gather(A, point=("gather", 0))
            raise faults.TransientFault("link down")
        return real(grid, plan, A, B, *a, coll=coll, **kw)

    monkeypatch.setattr(d15, "sddmm_d15", flaky)
    el = api.ElasticProblem(prob, policy=api.RetryPolicy(base_delay=0.0))
    with obs.trace() as tr:
        got = el.sddmm(X, Y).values_tensor()
    assert len(el.recoveries) == 1
    assert [r.error for r in tr.rounds] == ["TransientFault", None]
    assert tr.rounds[0].measured_words is None
    assert tr.rounds[1].drift == 1.0
    assert np.array_equal(got.numpy(), want.numpy())


def test_session_rounds_drift_one_hit_and_miss():
    """A Session's rounds are modeled without the pre-gather, hit or
    miss, and their logs match that model."""
    from repro_torch import obs
    from repro_torch.core import api
    prob, X, Y = _problem("d15")
    sess = api.Session()
    with obs.trace() as tr:
        prob.fusedmm(X, Y, elision="fused", session=sess)
        prob.fusedmm(X, Y, elision="fused", session=sess)
    assert (sess.hits, sess.misses) == (1, 1)
    assert [r.drift for r in tr.rounds] == [1.0, 1.0]
    gathered = sum(w for *_, w in prob.schedule_words("fusedmm", "fused"))
    assert tr.rounds[0].modeled_words < gathered


# ---------------------------------------------------------------------------
# Zero cost when disabled (the faults.guard discipline)
# ---------------------------------------------------------------------------

def test_disabled_tracer_is_never_touched(monkeypatch):
    from repro_torch.obs import tracer as obs_tracer
    prob, X, Y = _problem("d15", p=1)
    base = prob.sddmm(X, Y).values()

    def explode(*a, **kw):
        raise AssertionError("obs hook ran while disabled")

    monkeypatch.setattr(obs_tracer.Tracer, "round", explode)
    monkeypatch.setattr(obs_tracer.Tracer, "_finish", explode)
    assert obs_tracer.active() is None
    got = prob.sddmm(X, Y).values()      # would raise if obs were touched
    assert np.array_equal(base, got)


def test_disabled_metrics_skip_instrumented_sites(monkeypatch):
    from repro_torch import obs
    from repro_torch.distributed.elastic import StepMonitor
    from repro_torch.obs import metrics as obs_metrics
    monkeypatch.setattr(obs.MetricsRegistry, "observe",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            AssertionError("metrics while disabled")))
    assert obs_metrics.active() is None
    mon = StepMonitor()
    assert mon.observe(0, 1.0) is False  # no registry: no metric calls


def test_trace_context_restores_previous():
    from repro_torch import obs
    from repro_torch.obs import tracer as obs_tracer
    assert obs_tracer.active() is None
    with obs.trace(measure_wire=False) as outer:
        assert obs_tracer.active() is outer
        with obs.trace() as inner:
            assert obs_tracer.active() is inner
        assert obs_tracer.active() is outer
    assert obs_tracer.active() is None


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def test_chrome_trace_structure_and_artifacts(tmp_path):
    from repro_torch import obs
    prob, X, Y = _problem("d15")
    with obs.collect() as reg, obs.trace() as tr:
        prob.sddmm(X, Y)
    ct = obs.chrome_trace(tr)
    evs = ct["traceEvents"]
    names = {e["name"] for e in evs}
    assert "d15.sddmm" in names and "rank 7" in str(evs)
    xs = [e for e in evs if e["ph"] == "X"]
    assert len([e for e in xs if e["cat"] == "round"]) == P
    assert xs and all(set(e) >= {"ts", "dur", "pid", "tid"} for e in xs)
    rnd = next(e for e in xs if e["cat"] == "round")
    assert rnd["args"]["drift"] == 1.0
    for e in xs:
        if e["cat"] == "event" and e["tid"] == rnd["tid"]:
            assert e["ts"] >= rnd["ts"] - 1e-6
            assert e["ts"] + e["dur"] <= rnd["ts"] + rnd["dur"] + 1e-6
    paths = obs.write_artifacts(str(tmp_path / "out"), "t", tracer=tr,
                                registry=reg)
    assert json.load(open(paths["trace"]))["traceEvents"]
    metrics_blob = json.load(open(paths["metrics"]))
    assert obs.MetricsRegistry.from_snapshot(
        metrics_blob).snapshot() == reg.snapshot()
    assert paths["trace"] == str(tmp_path / "out" / "TRACE_t.json")
    assert paths["metrics"] == str(tmp_path / "out" / "METRICS_t.json")
    assert sorted(os.listdir(tmp_path)) == ["out"]


def test_round_summary_renders():
    from repro_torch import obs
    prob, X, Y = _problem("s25")
    with obs.trace() as tr:
        prob.fusedmm(X, Y, elision="reuse")
    txt = obs.round_summary(tr)
    assert "s25.fusedmm[reuse]" in txt and "drift" in txt
    assert "1.0000" in txt


# ---------------------------------------------------------------------------
# The kernel router (tests/test_api.py's routing case)
# ---------------------------------------------------------------------------

def _router_data():
    from repro_torch.core import sparse
    rows, cols, vals, X, Y = sparse.random_problem(64, 64, 8, 4, seed=3)
    return rows, cols, vals, X, Y


def test_ops_routing_when_mesh_active():
    """Routed ops equal the reference's routed ops within test_api.py's
    tolerances, and the port's own problem results bit for bit; another
    pack falls through; an explicit backend wins; the hook is restored."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.core import api as japi
    from repro.core import sparse as jsparse
    from repro.kernels import ops as jops
    from repro_torch.core import api, sparse
    from repro_torch.kernels import ops
    rows, cols, vals, X, Y = _router_data()
    Sd = np.zeros((64, 64), np.float32)
    Sd[rows, cols] = vals
    # the reference's routed results
    jS = jsparse.pack_row_tiled(rows, cols, vals, (64, 64), row_tile=32,
                                nz_block=32)
    jprob = japi.make_problem(rows, cols, vals, (64, 64), 8,
                              algorithm="d15", devices=jax.devices()[:1])
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    with japi.activate(jprob, jS):
        jR = np.asarray(jops.sddmm(Xj, Yj, jS).to_dense())
        jout = np.asarray(jops.spmm(jS, Yj, m=64))
        jf, jfR = jops.fusedmm(Xj, Yj, jS, m=64)
        jf, jfR = np.asarray(jf), np.asarray(jfR.to_dense())
    # the port's
    cpu = torch.device("cpu")
    S = sparse.pack_row_tiled(rows, cols, vals, (64, 64), row_tile=32,
                              nz_block=32, device=cpu)
    prob = api.make_problem(rows, cols, vals, (64, 64), 8, algorithm="d15",
                            devices=[cpu])
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    with api.activate(prob, S) as router:
        R_ = ops.sddmm(Xt, Yt, S)
        out = ops.spmm(S, Yt, m=64)
        f, fR = ops.fusedmm(Xt, Yt, S, m=64)
        assert router.routed == 3
        other = sparse.pack_row_tiled(rows, cols, vals, (64, 64),
                                      row_tile=32, nz_block=32, device=cpu)
        local = ops.spmm(other, Yt, m=64)
        ref_out = ops.spmm(S, Yt, m=64, backend="ref")
        assert router.routed == 3
        np.testing.assert_allclose(ref_out.numpy(), Sd @ Y, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_array_equal(local.numpy(), ref_out.numpy())
    assert ops._DIST_ROUTER is None
    # against the reference's routed results, test_api.py's tolerances
    np.testing.assert_allclose(R_.to_dense().numpy(), jR, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(out.numpy(), jout, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f.numpy(), jf, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(fR.to_dense().numpy(), jfR, rtol=2e-3,
                               atol=2e-3)
    # against the port's own problem, bit for bit
    want_R = prob.sddmm(X, Y)
    assert torch.equal(out, prob.spmm(Y))
    want_f, want_fR = prob.fusedmm(X, Y)
    assert torch.equal(f, want_f)
    router = api._Router(prob, S)
    idx, ok = router._slot_index()
    for got, want in ((R_, want_R), (fR, want_fR)):
        v = want.values_tensor()
        assert torch.equal(got.vals.reshape(-1)[ok], v[idx[ok]])
        assert bool((got.vals.reshape(-1)[~ok] == 0).all())
    assert R_.vals.dtype == S.vals.dtype and out.dtype == Yt.dtype


def test_router_never_routes_its_own_executor_calls(monkeypatch):
    """A problem whose executor calls ops on the bound pack itself: the
    call inside the routed round runs the local kernel, once, and the
    router routes once (no recursion)."""
    import torch
    from repro_torch.core import api, sparse
    from repro_torch.kernels import ops
    rows, cols, vals, X, Y = _router_data()
    cpu = torch.device("cpu")
    S = sparse.pack_row_tiled(rows, cols, vals, (64, 64), row_tile=32,
                              nz_block=32, device=cpu)
    prob = api.make_problem(rows, cols, vals, (64, 64), 8, algorithm="d15",
                            devices=[cpu])
    Yt = torch.from_numpy(Y)
    inner = []
    real = ops.spmm

    def own_pack_spmm(Y_, vals=None, session=None, *, backend=None):
        inner.append(1)
        return real(S, Y_, m=64)          # the bound pack, no backend

    monkeypatch.setattr(prob, "spmm", own_pack_spmm)
    with api.activate(prob, S) as router:
        got = ops.spmm(S, Yt, m=64)
    assert router.routed == 1 and inner == [1]
    assert torch.equal(got, real(S, Yt, m=64))


# ---------------------------------------------------------------------------
# Session.clear and pack_coo against the reference's
# ---------------------------------------------------------------------------

def test_session_clear_matches_the_reference():
    import jax
    from repro.core import api as japi
    from repro_torch.core import api
    rows, cols, vals, X, Y = _data()
    jprob = japi.make_problem(rows, cols, vals, (M, N), R, algorithm="d15",
                              devices=jax.devices()[:1])
    prob, _, _ = _problem("d15", p=1)
    stats = []
    for pr, sess in ((jprob, japi.Session()), (prob, api.Session())):
        pr.fusedmm(X, Y, elision="fused", session=sess)
        pr.fusedmm(X, Y, elision="fused", session=sess)
        before = (sess.stats(), len(sess))
        sess.clear()
        assert len(sess) == 0 and not sess._id_memo
        pr.fusedmm(X, Y, elision="fused", session=sess)
        stats.append((before, sess.stats()))
    assert stats[0] == stats[1]


def test_pack_coo_matches_the_reference():
    import torch
    from repro.core import sparse as jsparse
    from repro_torch.core import sparse
    rows, cols, vals, _, _ = _data()
    cpu = torch.device("cpu")
    for kw in ({}, {"capacity": 300}, {"pad_multiple": 64}):
        want = jsparse.pack_coo(rows, cols, vals, (M, N), **kw)
        got = sparse.pack_coo(rows, cols, vals, (M, N), device=cpu, **kw)
        assert got.shape == want.shape and got.capacity == want.capacity
        for a, b in ((got.rows, want.rows), (got.cols, want.cols),
                     (got.vals, want.vals)):
            assert a.device == cpu
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="exceeds capacity"):
        sparse.pack_coo(rows, cols, vals, (M, N), capacity=8, device=cpu)


# ---------------------------------------------------------------------------
# One traced cell on 4 gloo ranks
# ---------------------------------------------------------------------------

def _worker(rank, world, init, out_dir):
    dist = join(rank, world, init)
    from repro_torch import obs
    from repro_torch.core import api
    rows, cols, vals, X, Y = _data()
    try:
        prob = api.make_problem(rows, cols, vals, (M, N), R,
                                algorithm="d15", c=C, devices=_cpu(world),
                                group=dist.group.WORLD)
        with obs.trace() as tr:
            prob.fusedmm(X, Y, elision="fused")
            prob.fusedmm(X, Y, elision="fused", session=api.Session())
        rec = {"drifts": [r.drift for r in tr.rounds],
               "spans": _spans(tr.rounds), "c": prob.c}
    finally:
        dist.destroy_process_group()
    save(out_dir, rank, {}, rec)


def test_traced_cell_on_gloo_ranks(tmp_path):
    from repro_torch import obs
    from repro_torch.core import api
    ranks = spawn(__file__, WORLD, str(tmp_path))
    prob = None
    for _, rec in ranks:
        assert rec["drifts"] == [1.0, 1.0]
        if prob is None:
            prob, X, Y = _problem("d15", p=WORLD)
            assert prob.c == rec["c"]
            with obs.trace() as tr:
                prob.fusedmm(X, Y, elision="fused")
                prob.fusedmm(X, Y, elision="fused", session=api.Session())
        assert rec["spans"] == _spans(tr.rounds)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5])
    elif sys.argv[1] == "reference":
        _reference()
