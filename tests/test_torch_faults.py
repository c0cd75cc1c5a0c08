"""The port's fault-injection harness and elastic recovery, after
tests/test_faults.py and tests/dist_scripts/check_faults.py.

Every test of test_faults.py has a twin here on the port (the trainer
ones in test_torch_checkpoint.py), held to the reference where the
reference runs on one host device in this process: FaultPlan.random's
specs, backoff schedules, controller summaries over the same call
sequence, meta_dict and its digest, and the metrics an ElasticProblem
counts.  check_faults.py's guarantee 1 (a TransientFault mid-schedule in
every family x op x elision x Session cell, recovered bit for bit) and
guarantee 2 (seeded plans replay) run on 8 stacked CPU ranks at its
sizes.  Integer-valued data makes every accumulation exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.distributed import elastic as jelastic
from repro.distributed import faults as jfaults
from repro.obs import metrics as jmetrics
from repro_torch.core import api, grads, sparse
from repro_torch.distributed import elastic, faults
from repro_torch.obs import metrics

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its ops are small, and beside
    the other test workers' default thread pools (one per core each)
    they crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, m=32, n=32, r=8, per_row=3):
    """test_faults.tiny_problem's (and check_faults.py's) integer data."""
    rng = np.random.default_rng(seed)
    rows, cols, _ = sparse.erdos_renyi(m, n, per_row, seed=seed)
    vals = rng.integers(1, 5, rows.shape[0]).astype(np.float32)
    X = rng.integers(-3, 4, (m, r)).astype(np.float32)
    Y = rng.integers(-3, 4, (n, r)).astype(np.float32)
    return rows, cols, vals, X, Y


def tiny_problem(seed=0, m=32, n=32, r=8, p=1, **kw):
    rows, cols, vals, X, Y = _data(seed, m, n, r)
    prob = api.make_problem(rows, cols, vals, (m, n), r,
                            devices=[CPU] * p, **kw)
    return prob, X, Y


def ref_tiny_problem(seed=0, m=32, n=32, r=8):
    rows, cols, vals, X, Y = _data(seed, m, n, r)
    return japi.make_problem(rows, cols, vals, (m, n), r,
                             devices=jax.devices()[:1]), X, Y


# --- plans and controllers --------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        faults.FaultSpec(kind="meteor_strike")
    with pytest.raises(ValueError, match="op"):
        faults.FaultSpec(op="gemm")
    with pytest.raises(ValueError, match="point"):
        faults.FaultSpec(point="handshake")
    assert faults.OPS == jfaults.OPS and faults.POINTS == jfaults.POINTS


@pytest.mark.parametrize("kw", [
    dict(seed=42, n_faults=5, p=8),
    dict(seed=7, n_faults=3, p=8, max_round=2),
    dict(seed=3, n_faults=6, p=4, max_phase=4,
         kinds=("transient", "device_lost"))])
def test_random_plan_replayable_and_the_references(kw):
    a = faults.FaultPlan.random(**kw)
    assert a.specs == faults.FaultPlan.random(**kw).specs
    assert a.specs != faults.FaultPlan.random(**{**kw,
                                                 "seed": kw["seed"] + 1}).specs
    ref = jfaults.FaultPlan.random(**kw)
    assert [dataclasses.asdict(s) for s in a.specs] == \
        [dataclasses.asdict(s) for s in ref.specs]


def test_controller_fires_once_and_logs():
    events = [("gather", 0), ("phase", 0), ("shift", 0),
              ("phase", 1), ("shift", 1)]
    summaries = []
    for mod in (faults, jfaults):
        ctl = mod.FaultController(mod.FaultPlan.scripted(
            mod.FaultSpec(op="sddmm", point="shift", phase=1, round=1)))
        ctl.guard("sddmm", "d15", 4, events)          # round 0: no match
        with pytest.raises(mod.TransientFault) as ei:
            ctl.guard("sddmm", "d15", 4, events)      # round 1: fires
        assert ei.value.coord["point"] == "shift"
        assert ei.value.coord["phase"] == 1
        ctl.guard("sddmm", "d15", 4, events)          # consumed
        s = ctl.summary()
        assert s["rounds"] == {"sddmm": 3} and len(s["fired"]) == 1
        assert not s["pending"]
        summaries.append(s)
    assert summaries[0] == summaries[1]


def test_controller_unreachable_spec_stays_pending():
    ctl = faults.FaultController(faults.FaultPlan.scripted(
        faults.FaultSpec(op="spmm", point="gather", rank=7)))
    ctl.guard("spmm", "s25", 4, [("phase", 0), ("reduce", 0)])  # no gather
    assert len(ctl.summary()["pending"]) == 1


def test_inject_nests_and_restores():
    assert faults.active() is None
    with faults.inject(faults.FaultPlan.scripted()) as outer:
        assert faults.active() is outer
        with faults.inject(faults.FaultPlan.scripted()) as inner:
            assert faults.active() is inner
        assert faults.active() is outer
    assert faults.active() is None


def test_unwrap_recovers_laundered_fault():
    plan = faults.FaultPlan.scripted(
        faults.FaultSpec(kind="device_lost", rank=0))
    with faults.inject(plan) as ctl:
        with pytest.raises(faults.DeviceLost):
            ctl.guard("sddmm", "d15", 1, [("gather", 0)])
        laundered = RuntimeError("wrapped by a framework boundary")
        typed = faults.unwrap(laundered)
        assert isinstance(typed, faults.DeviceLost) and typed.rank == 0
        # reclaimed once: a second unrelated error passes through
        assert faults.unwrap(laundered) is laundered
    assert faults.unwrap(laundered) is laundered  # no armed controller


@pytest.mark.parametrize("op", ["spmm", "spmm_t"])
def test_fault_in_autograd_backward_comes_out_typed(op):
    """A guard in the backward (the dual SpMM / SpMM^T of grads.sddmm)
    reaches the caller as the typed fault, rank and coordinate kept."""
    prob, X, Y = tiny_problem(p=2)
    Xt = torch.from_numpy(X).requires_grad_()
    Yt = torch.from_numpy(Y).requires_grad_()
    plan = faults.FaultPlan.scripted(
        faults.FaultSpec(op=op, rank=1, kind="device_lost"))
    with faults.inject(plan) as ctl:
        loss = grads.sddmm(prob, Xt, Yt).sum()
        assert not ctl.fired                      # the forward passed
        with pytest.raises(faults.DeviceLost) as ei:
            loss.backward()
    assert ei.value.rank == 1 and ei.value.coord["op"] == op
    assert faults.unwrap(ei.value) is ei.value


# --- retry policies ---------------------------------------------------------

def test_backoff_delays_deterministic_and_bounded():
    a = list(elastic.backoff_delays(5, base=0.1, max_delay=0.3, seed=4))
    b = list(elastic.backoff_delays(5, base=0.1, max_delay=0.3, seed=4))
    assert a == b and len(a) == 5
    assert all(d <= 0.3 * 1.25 for d in a)
    assert a[0] < a[1]   # exponential growth until the cap
    assert list(elastic.backoff_delays(3)) == [0.0, 0.0, 0.0]  # no base
    assert a == list(jelastic.backoff_delays(5, base=0.1, max_delay=0.3,
                                             seed=4))


def test_retry_policy_delays_deterministic():
    pol = api.RetryPolicy(max_retries=4, base_delay=0.5, seed=9)
    assert list(pol.delays()) == list(
        api.RetryPolicy(max_retries=4, base_delay=0.5, seed=9).delays())
    assert list(pol.delays()) == list(
        japi.RetryPolicy(max_retries=4, base_delay=0.5, seed=9).delays())


def test_run_step_resilient_backoff_sleeps():
    slept = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise faults.TransientFault("hiccup")
        return "done"

    out = elastic.run_step_resilient(
        flaky, None, None, max_retries=3,
        backoff=iter([0.01, 0.02, 0.04]), sleep=slept.append)
    assert out == "done" and slept == [0.01, 0.02]


def test_a_bare_runtime_error_is_never_retried():
    """A kernel that fails to build or launch raises a RuntimeError: it
    propagates on the first attempt, in the step loop and the facade."""
    assert RuntimeError not in api.RETRYABLE_ERRORS
    assert elastic.RETRYABLE == api.RETRYABLE_ERRORS
    assert issubclass(api.RETRYABLE_ERRORS[0], faults.TransientFault)
    import torch.distributed as dist
    assert set(api.RETRYABLE_ERRORS[1:]) == {dist.DistBackendError,
                                             dist.DistNetworkError}
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal"):
        elastic.run_step_resilient(broken, None, None, max_retries=3)
    assert calls["n"] == 1
    prob, X, Y = tiny_problem()
    ep = api.ElasticProblem(prob)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prob.alg, "sddmm", lambda *a, **k: broken())
        with pytest.raises(RuntimeError, match="illegal"):
            ep.sddmm(X, Y)
    assert calls["n"] == 2 and not ep.recoveries


# --- ElasticProblem recovery on one rank ------------------------------------

def test_elastic_problem_recovers_bitwise():
    prob, X, Y = tiny_problem()
    base = prob.sddmm(X, Y).values()
    plan = faults.FaultPlan.scripted(faults.FaultSpec(op="sddmm"))
    with faults.inject(plan) as ctl:
        ep = api.ElasticProblem(prob, session=api.Session())
        got = ep.sddmm(X, Y).values()
    assert np.array_equal(got, base)
    assert len(ep.recoveries) == 1 and len(ctl.fired) == 1
    assert ep.recoveries[0]["coord"]["op"] == "sddmm"


def test_elastic_problem_exhausts_budget():
    prob, X, Y = tiny_problem()
    plan = faults.FaultPlan.scripted(
        *[faults.FaultSpec(op="spmm", round=i) for i in range(5)])
    with faults.inject(plan):
        ep = api.ElasticProblem(prob,
                                policy=api.RetryPolicy(max_retries=2))
        with pytest.raises(api.FaultRecoveryError) as ei:
            ep.spmm(Y)
    assert len(ei.value.history) == 3   # initial + 2 retries, all faulted


def test_elastic_problem_propagates_caller_bugs():
    prob, X, Y = tiny_problem()
    ep = api.ElasticProblem(prob)
    with pytest.raises((TypeError, ValueError)):
        ep.spmm(None)            # wrong operand, not a device failure
    assert not ep.recoveries


def test_session_invalidate_is_grid_scoped():
    prob, X, Y = tiny_problem(seed=0)
    other, X2, Y2 = tiny_problem(seed=1)
    sess = api.Session()
    prob.fusedmm(X, Y, elision="reuse", session=sess)
    other.fusedmm(X2, Y2, elision="reuse", session=sess)
    n_before = len(sess._cache)
    evicted = sess.invalidate(prob)
    assert evicted >= 1
    assert len(sess._cache) == n_before - evicted
    assert not [k for k in sess._id_memo if k[0] == id(prob.grid)]
    # other problem's entries survive, and the evicted ones refill
    out, _ = prob.fusedmm(X, Y, elision="reuse", session=sess)
    assert torch.equal(out, prob.fusedmm(X, Y, elision="reuse")[0])


def test_controller_summaries_equal_the_references():
    """One scripted plan over one call sequence through ElasticProblem:
    the same rounds, fired coordinates and per-round log in both
    packages (one rank each)."""
    specs = [dict(op="sddmm", round=1), dict(op="fusedmm", point="gather"),
             dict(op="spmm", round=0), dict(op="spmm_t", round=2),
             dict(op="fusedmm", round=3, point="reduce")]
    summaries = []
    for pkg_api, mod, make in ((api, faults, tiny_problem),
                               (japi, jfaults, ref_tiny_problem)):
        prob, X, Y = make()
        plan = mod.FaultPlan.scripted(*[mod.FaultSpec(**s) for s in specs])
        with mod.inject(plan) as ctl:
            ep = pkg_api.ElasticProblem(prob, session=pkg_api.Session())
            for _ in range(2):
                ep.sddmm(X, Y)
                ep.spmm(Y)
                ep.spmm_t(X)
                ep.fusedmm(X, Y, elision="reuse")
        summaries.append((ctl.summary(), [
            {k: rec[k] for k in ("op", "attempt", "family", "p", "coord")}
            for rec in ep.recoveries]))
    assert summaries[0] == summaries[1]
    assert len(summaries[0][0]["fired"]) >= 3


def test_metrics_equal_the_references():
    """The elastic counters an ElasticProblem writes, snapshot for
    snapshot the reference's, for one transient fault per op."""
    snaps = []
    for pkg_api, mod, reg_mod, make in (
            (api, faults, metrics, tiny_problem),
            (japi, jfaults, jmetrics, ref_tiny_problem)):
        prob, X, Y = make()
        plan = mod.FaultPlan.scripted(mod.FaultSpec(op="sddmm"),
                                      mod.FaultSpec(op="spmm"))
        with reg_mod.collect() as reg, mod.inject(plan):
            ep = pkg_api.ElasticProblem(prob)
            ep.sddmm(X, Y)
            ep.spmm(Y)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert metrics.MetricsRegistry.from_snapshot(snaps[0]).snapshot() \
        == snaps[0]


def test_degrade_counts_and_gauges():
    prob, X, Y = tiny_problem(m=64, n=64, r=16, p=8)
    base = prob.sddmm(X, Y).values()
    plan = faults.FaultPlan.scripted(
        faults.FaultSpec(op="sddmm", rank=7, kind="device_lost"))
    with metrics.collect() as reg, faults.inject(plan):
        ep = api.ElasticProblem(prob)
        got = ep.sddmm(X, Y).values()
    assert np.array_equal(got, base)
    assert reg.value("elastic.degrades", op="sddmm") == 1
    assert reg.value("elastic.p") == ep.problem.p == 4
    assert reg.value("elastic.faults", op="sddmm", kind="DeviceLost") == 1


# --- checkpoint metadata ----------------------------------------------------

def test_meta_roundtrip_and_digest_guard():
    prob, X, Y = tiny_problem()
    meta = prob.meta_dict()
    re = api.problem_from_meta(meta, prob.rows, prob.cols, prob.vals,
                               devices=[CPU])
    assert (re.alg.name, re.p, re.c) == (meta["family"], prob.p, prob.c)
    bad = prob.vals.copy()
    bad[0] += 1.0
    with pytest.raises(ValueError, match="wrong matrix"):
        api.problem_from_meta(meta, prob.rows, prob.cols, bad,
                              devices=[CPU])


@pytest.mark.parametrize("kw", [{}, dict(comm="sparse"),
                                dict(comm="sparse", compress="bf16")])
def test_meta_dict_equals_the_references(kw):
    """Key for key, the content digest included (one COO, one digest)."""
    prob, _, _ = tiny_problem(**kw)
    ref, _, _ = ref_tiny_problem()
    want = ref.meta_dict()
    if kw:
        want = japi.make_problem(ref.rows, ref.cols, ref.vals, (32, 32), 8,
                                 devices=jax.devices()[:1],
                                 **kw).meta_dict()
    assert prob.meta_dict() == want
    assert prob.coo_digest() == ref.coo_digest()


def test_replan_same_mesh_bitwise():
    prob, X, Y = tiny_problem(m=64, n=64, r=16, p=8)
    re = prob.replan()
    assert (re.alg.name, re.c, re.p) == (prob.alg.name, prob.c, prob.p)
    assert np.array_equal(re.sddmm(X, Y).values(),
                          prob.sddmm(X, Y).values())


@pytest.mark.parametrize("family", ["d15", "s15", "d25", "s25"])
def test_schedule_events_cover_all_ops(family):
    prob, _, _ = tiny_problem(m=64, n=64, r=16, p=8, algorithm=family, c=2)
    mod = prob.alg._sched_mod
    for op in faults.OPS:
        els = prob.alg.elisions if op == "fusedmm" else ("none",)
        for el in els:
            ev = prob.alg.schedule_events(prob, op, el)
            assert ev, f"{prob.alg.name}.{op}[{el}] has an empty schedule"
            assert all(pt in faults.POINTS for pt, _ in ev)
            assert ev == mod.schedule_events(prob.grid, op, el)


# --- check_faults.py guarantee 1: every family x op x elision x Session -----

def _fault_calls(prob, X, Y, m, r):
    ones = np.ones((m, r), np.float32)
    calls = [("sddmm", None, lambda p: (p.sddmm(X, Y).values(),)),
             ("spmm", None, lambda p: (p.spmm(Y),)),
             ("spmm_t", None, lambda p: (p.spmm_t(ones),))]
    for el in prob.alg.elisions:
        def fused(p, el=el):
            out, R = p.fusedmm(X, Y, elision=el)
            return out, R.values()
        calls.append(("fusedmm", el, fused))
    return calls


def _equal(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor)
               else np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("family", ["d15", "s15", "d25", "s25"])
def test_transient_recovery_parity(family):
    m = n = 64
    r = 16
    rows, cols, vals, X, Y = _data(0, m, n, r, per_row=4)
    prob = api.make_problem(rows, cols, vals, (m, n), r, algorithm=family,
                            c=2, devices=[CPU] * 8)
    for op, el, call in _fault_calls(prob, X, Y, m, r):
        base = call(prob)
        for use_session in (False, True):
            session = api.Session() if use_session else None
            if session is not None:
                call(api.ElasticProblem(prob, session=session))  # warm
            plan = faults.FaultPlan.scripted(
                faults.FaultSpec(op=op, point="*", rank=1, phase=-1,
                                 round=0))
            with faults.inject(plan) as ctl:
                ep = api.ElasticProblem(prob, session=session)
                got = call(ep)
            tag = f"{family} {op}[{el}] session={use_session}"
            assert len(ctl.fired) == 1, f"{tag}: fault did not fire"
            assert len(ep.recoveries) == 1, f"{tag}: no recovery"
            assert _equal(got, base), f"{tag}: parity broken"
            if session is not None:
                assert ep.recoveries[0]["evicted"] >= 0


def test_seeded_plans_replay():
    """check_faults.py's guarantee 2 on the port: two runs of one seeded
    plan against one call sequence fire at the same coordinates, and
    the recovered results equal the fault-free ones."""
    m = n = 64
    r = 16
    rows, cols, vals, X, Y = _data(0, m, n, r, per_row=4)
    prob = api.make_problem(rows, cols, vals, (m, n), r, algorithm="d15",
                            c=2, devices=[CPU] * 8)
    planA = faults.FaultPlan.random(7, n_faults=3, p=8, max_round=2)
    planB = faults.FaultPlan.random(7, n_faults=3, p=8, max_round=2)
    assert planA.specs == planB.specs
    logs = []
    for plan in (planA, planB):
        with faults.inject(plan) as ctl:
            ep = api.ElasticProblem(prob,
                                    policy=api.RetryPolicy(max_retries=4))
            for _ in range(2):
                out = ep.sddmm(X, Y).values()
                ep.spmm(Y)
                ep.fusedmm(X, Y)
        assert np.array_equal(out, prob.sddmm(X, Y).values())
        logs.append(ctl.summary())
    assert logs[0]["fired"] == logs[1]["fired"]
    assert logs[0] == logs[1]


# --- straggler monitor (fake clock) ----------------------------------------

def test_step_monitor_timed_fake_clock():
    t = {"now": 0.0}

    def clock():
        return t["now"]

    flagged = []
    mon = elastic.StepMonitor(straggler_factor=2.0, clock=clock,
                              on_straggler=lambda s, sec, med:
                              flagged.append((s, sec)))

    def work(cost):
        t["now"] += cost
        return (torch.zeros(1), {"x": [torch.ones(2)]})

    for i in range(5):
        mon.timed(i, work, 1.0)
    mon.timed(5, work, 5.0)        # 5x the median: flagged
    mon.timed(6, work, 1.0)
    assert flagged == [(5, 5.0)]
    assert mon.flagged == [5]
    with metrics.collect() as reg:
        mon.timed(7, work, 9.0)
    assert reg.value("train.stragglers") == 1


def test_recovery_frees_the_old_grids_packs():
    """Recovery leaves nothing behind, without the cyclic collector:
    after a transient fault the facade and its Session die with their
    last reference (the controller gives up the fault it kept when
    recovery reclaims it, no frame holds its own exception, the backoff
    generator is not resumed inside the handler: each would keep the
    failed call's frames), and after a DeviceLost the old grid's packs
    are gone (degrade releases the old problem before re-planning)."""
    import gc
    import weakref
    prob, X, Y = tiny_problem(m=64, n=64, r=16, p=8)
    prob.fusedmm(X, Y)
    old = [weakref.ref(prob.plan("normal").rows_local),
           weakref.ref(prob._posplan("normal").rows_local)]
    gc.collect()
    gc.disable()
    try:
        plan = faults.FaultPlan.scripted(faults.FaultSpec(op="fusedmm"))
        with faults.inject(plan) as ctl:
            session = api.Session()
            ep = api.ElasticProblem(prob, session=session)
            out, R = ep.fusedmm(X, Y)
            assert len(ctl.fired) == 1 and ctl.last_raised is None
        gone = [weakref.ref(session), weakref.ref(ep)] + \
            [weakref.ref(v[2]) for v in session._cache.values()]
        del session, ep, out, R
        assert all(r() is None for r in gone)
        plan = faults.FaultPlan.scripted(
            faults.FaultSpec(op="fusedmm", rank=7, kind="device_lost"))
        with faults.inject(plan):
            ep = api.ElasticProblem(prob)
            out, R = ep.fusedmm(X, Y)
        assert ep.problem.p == 4
        del prob, ep, out, R
        assert all(r() is None for r in old)
    finally:
        gc.enable()
