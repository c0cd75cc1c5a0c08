"""The port's serving engine (repro_torch.serving, the served paths of
apps/als.py and apps/gat.py) against the reference's, after the engine
half of tests/test_serving.py.

Every scenario runs twice on the same seeded integer data, through
``repro.serving`` on one host device and through
``repro_torch.serving`` on the CPU: every ticket's answer must be equal
bit for bit (every sum is exact), and the port's coalesced tick must
equal its own per-request execution bit for bit.  Beside the
reference's checks: the pool's content keys are the reference's, a
union-pattern problem inherits no cache of its deployment, a score tick
hashes no deployed operand on the host, and an evicted deployment frees
its packs with the cyclic collector disabled.
"""
import gc
import importlib.util
import pathlib
import types
import weakref

import numpy as np
import pytest
import jax
import torch

from repro import serving as jserving
from repro.apps import als as jals
from repro.apps import gat as jgat
from repro.core import api as japi
from repro.distributed import faults as jfaults
from repro.serving import batcher as jbatcher
from repro.serving import server as jserver
from repro_torch import convert, serving
from repro_torch.apps import als, gat
from repro_torch.core import api
from repro_torch.distributed import faults
from repro_torch.serving import batcher, server
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
REF = types.SimpleNamespace(serving=jserving, batcher=jbatcher,
                            server=jserver, api=japi, als=jals, gat=jgat,
                            faults=jfaults, devices=jax.devices()[:1])
PORT = types.SimpleNamespace(serving=serving, batcher=batcher,
                             server=server, api=api, als=als, gat=gat,
                             faults=faults, devices=[CPU])
FAMILIES = ["d15", "s15", "d25", "s25"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the exact dots of integer-valued operands, as the card's check has them
EXACT_SCORES = _chip_smoke().exact_scores


def _exact(X, Y, rows, cols):
    """``<X_i, Y_j>`` at the pairs, exact for integer-valued operands."""
    return EXACT_SCORES(torch, torch.as_tensor(_np(X)),
                        torch.as_tensor(_np(Y)), rows, cols).numpy()


def _graph(m, n, nnz, seed=0):
    """Integer-exact random COO (no duplicate coordinates)."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, m * n, nnz))
    rows = (key // n).astype(np.int64)
    cols = (key % n).astype(np.int64)
    vals = (rng.integers(1, 4, len(key))
            * rng.choice([-1.0, 1.0], len(key))).astype(np.float32)
    return rows, cols, vals


def _int_mat(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _deploy(pk, pool, m=48, n=40, r=8, seed=0, algorithm="d15",
            comm="dense", operands=None, nnz=260):
    rows, cols, vals = _graph(m, n, nnz, seed)
    return pool.deploy(rows, cols, vals, (m, n), r,
                       operands=operands or {}, algorithm=algorithm,
                       comm=comm, devices=pk.devices)


def _solo(pk, tickets, use_session=False):
    """Each ticket's request run alone (fresh tickets)."""
    outs = []
    for t in tickets:
        ref = pk.serving.Ticket(t.request, seq=-1)
        pk.batcher.execute_solo(ref, use_session=use_session)
        outs.append(_np(ref.result()))
    return outs


def _answers(tickets):
    return [_np(t.result()) for t in tickets]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def _both(scenario):
    """Run ``scenario(pk)`` on both packages; each returns (answers,
    solo answers, extra facts): the port's answers == its solo answers
    == the reference's answers, and the facts agree."""
    want, want_solo, want_facts = scenario(REF)
    got, got_solo, got_facts = scenario(PORT)
    _assert_same(want, want_solo)
    _assert_same(got, got_solo)
    _assert_same(got, want)
    assert got_facts == want_facts
    return got_facts


# -- core parity: coalesced tick == per-request execution, bitwise ---------

def test_score_batching_bitwise_matches_solo_and_reference():
    def scenario(pk):
        rng = np.random.default_rng(0)
        pool = pk.serving.SessionPool(capacity=4)
        m, n, w = 48, 40, 5
        U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
        dep = _deploy(pk, pool, m=m, n=n, operands={"U": U, "V": V})
        eng = pk.serving.ServingEngine(pool, max_batch=32)
        tickets = []
        for seed in range(3):          # same X: merge freely
            r2 = np.random.default_rng(seed)
            tickets.append(eng.submit_score(
                dep, r2.integers(0, m, 7), r2.integers(0, n, 7), "U", "V"))
        for lo in (0, 24):             # private X, disjoint rows: scatter
            Xc = _int_mat(rng, (m, w))
            qr = rng.integers(lo, lo + 24, 6)
            tickets.append(eng.submit_score(dep, qr, rng.integers(0, n, 6),
                                            Xc, "V"))
        report = eng.tick()
        return (_answers(tickets), _solo(pk, tickets),
                (report["requests"], report["rounds"]))

    requests, rounds = _both(scenario)
    assert requests == 5 and rounds <= 2


def test_aggregate_batching_bitwise_matches_solo_and_reference():
    def scenario(pk):
        rng = np.random.default_rng(1)
        pool = pk.serving.SessionPool(capacity=4)
        dep = _deploy(pk, pool, seed=1)
        n, nnz = dep.problem.n, dep.problem.nnz
        eng = pk.serving.ServingEngine(pool, max_batch=32)
        override = _int_mat(rng, nnz)
        tickets = [eng.submit_aggregate(dep, _int_mat(rng, (n, wi)))
                   for wi in (3, 5, 2)]
        tickets += [eng.submit_aggregate(dep, _int_mat(rng, (n, 4)),
                                         vals=override) for _ in range(2)]
        report = eng.tick()
        return _answers(tickets), _solo(pk, tickets), report["rounds"]

    assert _both(scenario) == 2   # deployed values + one override


def test_aggregate_tensor_override_groups_by_identity():
    """A tensor override is keyed by the tensor: requests sharing one
    share a round; an equal copy rides its own round, same answers."""
    rng = np.random.default_rng(12)
    pool = serving.SessionPool(capacity=2)
    dep = _deploy(PORT, pool, seed=12)
    eng = serving.ServingEngine(pool)
    over = torch.from_numpy(_int_mat(rng, dep.problem.nnz))
    Y = _int_mat(rng, (dep.problem.n, 3))
    tickets = [eng.submit_aggregate(dep, Y, vals=over) for _ in range(2)]
    tickets.append(eng.submit_aggregate(dep, Y, vals=over.clone()))
    assert eng.tick()["rounds"] == 2
    got = _answers(tickets)
    _assert_same(got, _solo(PORT, tickets))
    _assert_same(got[1:], got[:2])
    with pytest.raises(ValueError, match="vals override"):
        eng.submit_aggregate(dep, Y, vals=over[:-1])


def test_duplicate_query_pairs_dedup_across_requests():
    """The union round computes each distinct (i, j) once; every request
    still gets its own (duplicated) samples back."""
    def scenario(pk):
        rng = np.random.default_rng(2)
        pool = pk.serving.SessionPool(capacity=2)
        m, n, w = 48, 40, 4
        U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
        dep = _deploy(pk, pool, operands={"U": U, "V": V})
        eng = pk.serving.ServingEngine(pool)
        qr, qc = np.array([3, 3, 7, 3]), np.array([5, 5, 1, 5])
        t1 = eng.submit_score(dep, qr, qc, "U", "V")
        t2 = eng.submit_score(dep, qr[:2], qc[:2], "U", "V")
        rounds = eng.tick()["rounds"]
        exact = _exact(U, V, qr, qc)
        return _answers([t1, t2]), [exact, exact[:2]], rounds

    assert _both(scenario) == 1


@pytest.mark.parametrize("use_session", [False, True])
@pytest.mark.parametrize("comm", ["dense", "sparse"])
@pytest.mark.parametrize("family", FAMILIES)
def test_batching_parity_over_families(family, comm, use_session):
    """Seeded request mixes (shared and private X, deployed and
    overridden values, widths 2..9): the coalesced tick equals solo
    execution and the reference bit for bit, in every (family, wire,
    Session) cell."""
    case = (FAMILIES.index(family) * 4 + ["dense", "sparse"].index(comm) * 2
            + int(use_session))

    def scenario(pk):
        rng = np.random.default_rng(1000 + case)
        w = int(rng.integers(2, 10))
        n_score, n_agg = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        m, n = 48, 40
        pool = pk.serving.SessionPool(capacity=4)
        U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
        dep = _deploy(pk, pool, m=m, n=n, seed=case, algorithm=family,
                      comm=comm, operands={"U": U, "V": V})
        eng = pk.serving.ServingEngine(pool, max_batch=32,
                                       use_session=use_session)
        tickets = []
        for _ in range(n_score):
            k = int(rng.integers(1, 8))
            if rng.integers(2):          # the deployed X
                tickets.append(eng.submit_score(
                    dep, rng.integers(0, m, k), rng.integers(0, n, k),
                    "U", "V"))
            else:                        # a private X, random rows
                tickets.append(eng.submit_score(
                    dep, rng.integers(0, m, k), rng.integers(0, n, k),
                    _int_mat(rng, (m, w)), "V"))
        override = _int_mat(rng, dep.problem.nnz)
        for _ in range(n_agg):
            wi = int(rng.integers(1, 6))
            tickets.append(eng.submit_aggregate(
                dep, _int_mat(rng, (n, wi)),
                vals=override if rng.integers(2) else None))
        rounds = eng.tick()["rounds"]
        return (_answers(tickets), _solo(pk, tickets, use_session),
                (dep.problem.alg.name, rounds))

    assert _both(scenario)[0] == family


# -- api-level entry points ------------------------------------------------

def test_spmm_batched_parity_and_validation():
    rng = np.random.default_rng(3)
    m, n, r = 48, 40, 8
    rows, cols, vals = _graph(m, n, 260, seed=3)
    Ys = [_int_mat(rng, (n, wi)) for wi in (3, 1, 6)]
    jprob = japi.make_problem(rows, cols, vals, (m, n), r, algorithm="d15",
                              devices=REF.devices)
    prob = api.make_problem(rows, cols, vals, (m, n), r, algorithm="d15",
                            devices=[CPU])
    outs = prob.spmm_batched(Ys)
    assert [tuple(o.shape) for o in outs] == [(m, 3), (m, 1), (m, 6)]
    _assert_same(_answers_of(outs), _answers_of(jprob.spmm_batched(Ys)))
    for Y, out in zip(Ys, outs):
        Yp = np.zeros((n, 8), np.float32)
        Yp[:, :Y.shape[1]] = Y
        np.testing.assert_array_equal(
            _np(out), _np(prob.spmm(Yp))[:, :Y.shape[1]])
    # tensors in, and the module-level entry point
    _assert_same(_answers_of(api.spmm_batched(
        prob, [torch.from_numpy(Y) for Y in Ys])), _answers_of(outs))
    assert prob.spmm_batched([]) == []
    with pytest.raises(ValueError, match="every RHS"):
        prob.spmm_batched([np.zeros((n + 1, 2), np.float32)])
    with pytest.raises(ValueError, match="pad_to"):
        prob.spmm_batched(Ys, pad_to=1)
    # pad_to buckets the planned width without changing answers
    _assert_same(_answers_of(prob.spmm_batched(Ys, pad_to=16)),
                 _answers_of(outs))
    ep = api.ElasticProblem(prob, session=api.Session())
    _assert_same(_answers_of(ep.spmm_batched(Ys)), _answers_of(outs))


def _answers_of(outs):
    return [_np(o) for o in outs]


def test_with_pattern_validation():
    rows, cols, vals = _graph(48, 40, 260, seed=4)
    prob = api.make_problem(rows, cols, vals, (48, 40), 8,
                            algorithm="d15", devices=[CPU])
    qp = prob.with_pattern([1, 2], [3, 4])
    assert qp.grid is prob.grid and qp.nnz == 2
    np.testing.assert_array_equal(qp.vals, [1.0, 1.0])
    with pytest.raises(ValueError, match="matching 1-D"):
        prob.with_pattern([1, 2], [3])
    with pytest.raises(ValueError, match="empty"):
        prob.with_pattern([], [])
    with pytest.raises(ValueError, match="outside"):
        prob.with_pattern([0], [40])
    with pytest.raises(ValueError, match="vals length"):
        prob.with_pattern([0], [0], vals=[1.0, 2.0])


@pytest.mark.parametrize("family", FAMILIES)
def test_with_pattern_inherits_no_cache(family):
    """Every lazily built cache of the deployment problem (plans,
    position-coded packs, value indices, device values, the sorted COO,
    derived problems) is absent from its pattern problem, whose SDDMM
    answers for its own pattern: the exact dots."""
    rng = np.random.default_rng(13)
    m, n, r = 48, 40, 8
    rows, cols, vals = _graph(m, n, 260, seed=13)
    prob = api.make_problem(rows, cols, vals, (m, n), r, algorithm=family,
                            devices=[CPU] * 4)
    X, Y = _int_mat(rng, (m, r)), _int_mat(rng, (n, r))
    prob.sddmm(X, Y).values_tensor()
    prob.spmm_t(X)
    prob.with_r(2 * r).spmm(np.ones((n, 2 * r), np.float32))
    prob.coo_sort()
    prob.ones()
    caches = ("_plans", "_derived_r", "_posmaps", "_value_idx")
    assert all(getattr(prob, f) for f in caches)
    assert prob._transposed is not None and prob._vals_dev is not None
    qr, qc = rng.integers(0, m, 9), rng.integers(0, n, 9)
    key = np.unique(qr * n + qc)
    qp = prob.with_pattern(key // n, key % n)
    for f in caches:
        assert not getattr(qp, f), f
    for f in ("_coo_sort", "_transposed", "_origin", "_ones", "_vals_dev",
              "last_collectives"):
        assert getattr(qp, f) is None, f
    got = qp.sddmm(X, Y).values_tensor().numpy()
    np.testing.assert_array_equal(
        got, _exact(X, Y, key // n, key % n))


# -- admission + tickets ---------------------------------------------------

def test_queue_admission_shedding():
    pool = serving.SessionPool(capacity=2)
    dep = _deploy(PORT, pool, operands={"U": np.ones((48, 4), np.float32),
                                        "V": np.ones((40, 4), np.float32)})
    eng = serving.ServingEngine(pool, max_pending=2)
    eng.submit_score(dep, [0], [0], "U", "V")
    eng.submit_score(dep, [1], [1], "U", "V")
    with pytest.raises(serving.AdmissionError):
        eng.submit_score(dep, [2], [2], "U", "V")
    assert eng.queue.stats()["rejected"] == 1
    eng.tick()
    eng.submit_score(dep, [2], [2], "U", "V")     # admission reopens
    assert len(eng.queue) == 1
    with pytest.raises(ValueError, match="max_pending"):
        serving.RequestQueue(0)


def test_ticket_lifecycle():
    pool = serving.SessionPool(capacity=2)
    dep = _deploy(PORT, pool, operands={"U": np.ones((48, 4), np.float32),
                                        "V": np.ones((40, 4), np.float32)})
    eng = serving.ServingEngine(pool)
    t = eng.submit_score(dep, [0], [0], "U", "V", arrival=1.5)
    with pytest.raises(RuntimeError, match="pending"):
        t.result()
    assert t.latency is None
    eng.tick()
    t.completion = 2.0
    assert t.result().shape == (1,) and t.result().dtype == torch.float32
    assert t.latency == pytest.approx(0.5)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit_score(dep, [], [], "U", "V")
    with pytest.raises(ValueError, match="outside"):
        eng.submit_score(dep, [48], [0], "U", "V")
    with pytest.raises(ValueError, match="X must be"):
        eng.submit_score(dep, [0], [0], np.ones((47, 4), np.float32), "V")


# -- the pool: content keys, LRU, pins, Session accounting -----------------

def test_content_key_is_the_references():
    rng = np.random.default_rng(14)
    rows, cols, vals = _graph(48, 40, 260, seed=14)
    ops_np = {"V": _int_mat(rng, (40, 4)), "U": _int_mat(rng, (48, 4))}
    ops_t = {k: torch.from_numpy(v) for k, v in ops_np.items()}
    for kw in (dict(), dict(algorithm="s15", comm="sparse")):
        want = jserving.content_key(rows, cols, vals, (48, 40), 8,
                                    operands=ops_np, **kw)
        assert serving.content_key(rows, cols, vals, (48, 40), 8,
                                   operands=ops_np, **kw) == want
        assert serving.content_key(
            torch.from_numpy(rows), torch.from_numpy(cols),
            torch.from_numpy(vals), (48, 40), 8, operands=ops_t,
            **kw) == want
    assert serving.requests.digest(ops_t["U"]) == \
        jserving.requests.digest(ops_np["U"])


def test_pool_lru_eviction_order_and_stats():
    def scenario(pk):
        pool = pk.serving.SessionPool(capacity=2)
        deps = [_deploy(pk, pool, seed=i) for i in range(4)]
        facts = [pool.stats()["occupancy"], pool.stats()["evictions"],
                 pool.keys == [deps[2].key, deps[3].key]]
        dep2b = _deploy(pk, pool, seed=2)        # a hit refreshes recency
        facts += [dep2b is deps[2], pool.stats()["hits"],
                  pool.keys == [deps[3].key, deps[2].key]]
        _deploy(pk, pool, seed=9)                # evicts 3, not 2
        facts += [deps[2].key in pool.keys, deps[3].key not in pool.keys]
        s = pool.stats()
        s.pop("session")
        return [], [], (facts, s, pool.keys)

    facts, stats, _ = _both(scenario)
    assert facts == [2, 2, True, True, 1, True, True, True]
    assert stats["misses"] == 5 and stats["evictions"] == 3
    assert 0.0 < stats["hit_rate"] < 1.0


def test_pool_redeploy_with_refreshed_operands_is_miss():
    """Same graph, refreshed factors: a new digest and a fresh
    deployment, so stale factors never serve a post-refresh query."""
    pool = serving.SessionPool(capacity=4)
    U1 = np.ones((48, 4), np.float32)
    V = np.ones((40, 4), np.float32)
    d1 = _deploy(PORT, pool, operands={"U": U1, "V": V})
    d2 = _deploy(PORT, pool, operands={"U": 2 * U1, "V": V})
    assert d1 is not d2 and d1.key != d2.key
    assert pool.stats()["misses"] == 2 and pool.stats()["hits"] == 0
    # the deployment owns its operands: the caller's later writes miss it
    U1[:] = 5.0
    assert float(d1.operand("U").max()) == 1.0
    with pytest.raises(ValueError, match="capacity"):
        serving.SessionPool(capacity=0)


def test_pool_pinned_never_evicted_and_inflight_survives():
    rng = np.random.default_rng(5)
    pool = serving.SessionPool(capacity=1)
    m, n, w = 48, 40, 4
    U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
    dep = _deploy(PORT, pool, operands={"U": U, "V": V})
    eng = serving.ServingEngine(pool)
    with pool.pin(dep):
        # churn past capacity while pinned: the pool overshoots
        for i in range(3):
            _deploy(PORT, pool, seed=10 + i)
        assert dep.key in pool.keys and pool.stats()["pinned"] == 1
        t = eng.submit_score(dep, [1, 2], [3, 4], "U", "V")
        eng.tick()
        np.testing.assert_array_equal(
            _np(t.result()), _exact(U, V, [1, 2], [3, 4]))
    _deploy(PORT, pool, seed=20)          # unpinned: evictable
    assert pool.stats()["occupancy"] == 1 and dep.key not in pool.keys


def test_pool_session_accounting_across_ticks():
    """Tick after tick against one deployment: the operands' replication
    comes from the Session (hits grow, misses stay) and the pattern
    cache keeps the one hot pattern; counts equal the reference's."""
    def scenario(pk):
        rng = np.random.default_rng(6)
        pool = pk.serving.SessionPool(capacity=2)
        m, n, w = 48, 40, 4
        U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
        dep = _deploy(pk, pool, operands={"U": U, "V": V})
        eng = pk.serving.ServingEngine(pool)
        qr, qc = rng.integers(0, m, 6), rng.integers(0, n, 6)
        tickets = []
        stats = []
        for _ in range(4):
            tickets.append(eng.submit_score(dep, qr, qc, "U", "V"))
            eng.tick()
            stats.append(dep.session.stats())
        return (_answers(tickets), _answers(tickets[:1]) * 4,
                (stats, len(dep._pattern_cache)))

    stats, patterns = _both(scenario)
    assert stats[-1]["misses"] == stats[0]["misses"]
    assert stats[-1]["hits"] > 0 and patterns == 1


def test_score_tick_hashes_and_uploads_no_deployed_operand(monkeypatch):
    """After deploy, no tick hands the Session a numpy operand (which it
    would sum on the host) and no padded copy is remade: the deployed
    tensors themselves (or one cached padded copy) reach the kernels."""
    rng = np.random.default_rng(15)
    m, n, w = 48, 40, 8
    U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
    pool = serving.SessionPool(capacity=2)
    dep = als.deploy_factors(pool, *_graph(m, n, 260, seed=15), (m, n),
                             U, V, algorithm="s15", devices=[CPU] * 4)
    assert all(isinstance(t, torch.Tensor) for t in dep.operands.values())
    seen = []
    cheap_fp = api.Session._cheap_fp
    monkeypatch.setattr(api.Session, "_cheap_fp", staticmethod(
        lambda arr: seen.append(type(arr)) or cheap_fp(arr)))
    eng = serving.ServingEngine(pool)
    for k in range(3):
        t = als.predict_scores(eng, dep, rng.integers(0, m, 5),
                               rng.integers(0, n, 5))
        eng.tick()
        assert _np(t.result()).shape == (5,)
    assert seen and np.ndarray not in seen
    assert dep.padded(dep.operand("U"), w, key="operand:U") \
        is dep.operand("U")
    stats = dep.session.stats()
    assert stats["misses"] == 2 and stats["hits"] == 4   # s15: X and Y


def _dense_spmm(rows, cols, vals, Y, m):
    """``S @ Y`` in float64, cast: exact for integer-valued data."""
    out = np.zeros((m, Y.shape[1]))
    np.add.at(out, rows, vals[:, None].astype(np.float64) * Y[cols])
    return out.astype(np.float32)


def test_aggregate_widths_bucketed_and_bounded(monkeypatch):
    """A batched aggregation round runs at a power-of-two multiple of the
    family's r-multiple (4 for s15 on 4 ranks): a second combined width
    in the same bucket packs nothing new, and a problem keeps at most
    DERIVED_R_MAX derived widths."""
    rng = np.random.default_rng(18)
    m, n = 48, 40
    rows, cols, vals = _graph(m, n, 260, seed=18)
    pool = serving.SessionPool(capacity=1)
    dep = pool.deploy(rows, cols, vals, (m, n), 8, algorithm="s15",
                      devices=[CPU] * 4)
    assert [batcher._aggregate_width(dep.problem, w)
            for w in (1, 4, 5, 8, 9, 17, 33)] == [4, 4, 8, 8, 16, 32, 64]
    plans = []
    make_plan = type(dep.problem.alg).make_plan
    monkeypatch.setattr(type(dep.problem.alg), "make_plan",
                        lambda self, prob, orient: plans.append(prob.r)
                        or make_plan(self, prob, orient))
    eng = serving.ServingEngine(pool)
    for widths, packed in (((3, 2), [8]), ((4, 3), []), ((9, 2, 1), [16]),
                           ((3, 2, 1), [])):
        Ys = [_int_mat(rng, (n, w)) for w in widths]
        tickets = [eng.submit_aggregate(dep, Y) for Y in Ys]
        assert eng.tick()["rounds"] == 1
        for t, Y in zip(tickets, Ys):
            np.testing.assert_array_equal(
                _np(t.result()), _dense_spmm(rows, cols, vals, Y, m))
        # (3, 2) packs the problem's own width 8 (plans are lazy) and
        # (4, 3) shares it; (9, 2, 1) packs 16 once, (3, 2, 1) reuses 8
        assert plans == packed, widths
        plans.clear()
    for r in (20, 24, 28, 32, 36, 8, 24):
        assert dep.problem.with_r(r).r == r
    assert list(dep.problem._derived_r) == [28, 32, 36, 24]
    assert len(dep.problem._derived_r) == api.DERIVED_R_MAX
    assert dep.problem.with_r(32) is dep.problem.with_r(32)


def test_private_operands_keyed_by_identity_and_not_cached(monkeypatch):
    """A client's own tensor X is keyed by its identity (no copy to the
    host to hash it), groups the requests that share it, and is padded
    per round without a cached copy; the deployed operand's padded copy
    is cached."""
    rng = np.random.default_rng(19)
    m, n, w = 48, 40, 6
    rows, cols, vals = _graph(m, n, 260, seed=19)
    V = _int_mat(rng, (n, w))
    pool = serving.SessionPool(capacity=1)
    dep = pool.deploy(rows, cols, vals, (m, n), 8, operands={"V": V},
                      algorithm="s15", devices=[CPU] * 4)
    hashed = []
    monkeypatch.setattr(serving.requests, "hash_array",
                        lambda h, a: hashed.append(a.shape))
    eng = serving.ServingEngine(pool)
    X = torch.as_tensor(_int_mat(rng, (m, w)))
    qs = [(rng.integers(0, m, 5), rng.integers(0, n, 5)) for _ in range(2)]
    tickets = [eng.submit_score(dep, qr, qc, X, "V") for qr, qc in qs]
    assert hashed == []
    assert {t.request.x_key for t in tickets} == {f"tensor:{id(X)}"}
    assert eng.tick()["rounds"] == 1
    for t, (qr, qc) in zip(tickets, qs):
        np.testing.assert_array_equal(_np(t.result()), _exact(X, V, qr, qc))
    assert list(dep._pad_cache) == [("operand:V", 8, CPU)]


# -- memory: nothing waits for the cyclic collector ------------------------

def _pack_ref(plan):
    """A weak reference to one of a plan's pack tensors (a phase's, for
    d15's per-phase tuples)."""
    t = plan.rows_local
    return weakref.ref(t[0] if isinstance(t, tuple) else t)


def test_transposed_refers_back_weakly():
    rows, cols, vals = _graph(48, 40, 260, seed=16)
    X = _int_mat(np.random.default_rng(16), (48, 8))
    prob = api.make_problem(rows, cols, vals, (48, 40), 8, algorithm="d15",
                            devices=[CPU] * 2)
    tp = prob.transposed()
    assert tp.transposed() is prob and prob.transposed() is tp
    want = _np(prob.spmm_t(X))
    packs = _pack_ref(prob.plan("normal"))
    gc.collect()
    gc.disable()
    try:
        assert packs() is not None
        del prob
        assert packs() is None           # freed with no collection
    finally:
        gc.enable()
    again = tp.transposed()              # S derived anew from S^T
    assert tp.transposed() is again and again.transposed() is tp
    np.testing.assert_array_equal(_np(again.spmm_t(X)), want)


def test_evicted_deployment_frees_its_packs_without_the_collector():
    rng = np.random.default_rng(17)
    m, n, w = 48, 40, 8
    U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
    pool = serving.SessionPool(capacity=1)
    gc.collect()
    gc.disable()
    try:
        dep = als.deploy_factors(pool, *_graph(m, n, 260, seed=17), (m, n),
                                 U, V, algorithm="d15", devices=[CPU] * 2)
        eng = serving.ServingEngine(pool)
        t1 = als.predict_scores(eng, dep, [1, 2, 3], [4, 5, 6])
        t2 = als.lookup_embeddings(eng, dep, _int_mat(rng, (n, 3)))
        eng.tick()
        dep.elastic.spmm_t(U)
        prob = dep.problem
        refs = [_pack_ref(prob.plan("normal")),
                _pack_ref(prob.transposed().plan("transpose")),
                _pack_ref(next(iter(dep._pattern_cache.values()))[1]
                          .plan("normal")),
                weakref.ref(dep.operand("U")), weakref.ref(prob)]
        del prob, dep, eng, t1, t2
        assert all(r() is not None for r in refs)
        _deploy(PORT, pool, seed=18)      # evicts the ALS deployment
        assert pool.stats()["evictions"] == 1
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


# -- elastic serving (transient faults mid-tick) ---------------------------

def test_tick_recovers_from_transient_fault():
    def scenario(pk):
        rng = np.random.default_rng(7)
        pool = pk.serving.SessionPool(capacity=2)
        m, n, w = 48, 40, 4
        U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
        dep = _deploy(pk, pool, operands={"U": U, "V": V})
        eng = pk.serving.ServingEngine(pool)
        qr, qc = rng.integers(0, m, 6), rng.integers(0, n, 6)
        plan = pk.faults.FaultPlan.scripted(
            pk.faults.FaultSpec(op="sddmm", kind="transient", round=0))
        with pk.faults.inject(plan) as ctl:
            t = eng.submit_score(dep, qr, qc, "U", "V")
            eng.tick()
        return ([_np(t.result())], [_exact(U, V, qr, qc)],
                (len(ctl.fired), len(dep.elastic.recoveries)))

    assert _both(scenario) == (1, 1)


def test_tick_fails_tickets_when_retries_exhausted():
    def scenario(pk):
        pool = pk.serving.SessionPool(
            capacity=2, policy=pk.api.RetryPolicy(max_retries=1))
        dep = _deploy(pk, pool,
                      operands={"U": np.ones((48, 4), np.float32),
                                "V": np.ones((40, 4), np.float32)})
        eng = pk.serving.ServingEngine(pool)
        plan = pk.faults.FaultPlan.scripted(
            *[pk.faults.FaultSpec(op="sddmm", kind="transient", round=i)
              for i in range(3)])
        with pk.faults.inject(plan):
            t = eng.submit_score(dep, [0], [0], "U", "V")
            eng.tick()
        with pytest.raises(pk.api.FaultRecoveryError):
            t.result()
        t2 = eng.submit_score(dep, [1], [1], "U", "V")   # server survives
        eng.tick()
        return ([_np(t2.result())], [np.float32([4.0])],
                (t.done, eng.failed, eng.stats()["served"]))

    assert _both(scenario) == (True, 1, 1)


# -- deterministic replay (latency method) ---------------------------------

class _Clock:
    """A perf_counter that advances 1 ms a reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


def test_replay_trace_latency_accounting(monkeypatch):
    """With the engine's clock fixed (1 ms a reading) the replay's
    latencies, percentiles and throughput are the reference's, number
    for number."""
    def scenario(pk):
        monkeypatch.setattr(pk.server, "time", _Clock())
        rng = np.random.default_rng(8)
        pool = pk.serving.SessionPool(capacity=2)
        m, n, w = 48, 40, 4
        U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
        dep = _deploy(pk, pool, operands={"U": U, "V": V})
        eng = pk.serving.ServingEngine(pool, max_batch=4, max_pending=6)

        def make_submit(seed):
            def submit(engine, arrival):
                r2 = np.random.default_rng(seed)
                return engine.submit_score(
                    dep, r2.integers(0, m, 4), r2.integers(0, n, 4),
                    "U", "V", arrival=arrival)
            return submit

        trace = [(0.001 * i, make_submit(i)) for i in range(8)]
        trace += [(0.02, make_submit(100 + i)) for i in range(8)]
        out = pk.serving.replay_trace(eng, trace)
        tickets = out.pop("tickets")
        exact = [_exact(U, V, t.request.rows, t.request.cols)
                 for t in tickets]
        lats = [t.latency for t in tickets]
        return _answers(tickets), exact, (out, lats)

    out, lats = _both(scenario)
    assert out["served"] == 14 and out["shed"] == 2
    assert out["p99"] >= out["p50"] > 0 and out["throughput"] > 0
    assert all(lat > 0 for lat in lats)


# -- served app query modes ------------------------------------------------

def test_als_predict_scores_served():
    def scenario(pk):
        rng = np.random.default_rng(9)
        m, n, r = 48, 40, 8
        rows, cols, vals = _graph(m, n, 260, seed=9)
        U, V = _int_mat(rng, (m, r)), _int_mat(rng, (n, r))
        pool = pk.serving.SessionPool(capacity=2)
        dep = pk.als.deploy_factors(pool, rows, cols, vals, (m, n), U, V,
                                    algorithm="d15", devices=pk.devices)
        eng = pk.serving.ServingEngine(pool)
        users, items = rng.integers(0, m, 6), rng.integers(0, n, 6)
        t1 = pk.als.predict_scores(eng, dep, users, items)
        W = _int_mat(rng, (n, 3))
        t2 = pk.als.lookup_embeddings(eng, dep, W)
        eng.tick()
        dense = np.zeros((m, n), np.float32)
        dense[rows, cols] = vals
        return (_answers([t1, t2]),
                [_exact(U, V, users, items), dense @ W],
                dep.key)

    _both(scenario)
    with pytest.raises(ValueError, match="factor widths"):
        als.deploy_factors(serving.SessionPool(), *_graph(8, 8, 9), (8, 8),
                           np.ones((8, 2), np.float32),
                           np.ones((8, 3), np.float32), devices=[CPU])


def _gat_case(n=64, d=8, seed=10):
    H = _int_mat(np.random.default_rng(seed), (n, d))
    jp = jgat.init_gat_layer(jax.random.PRNGKey(3), d, d)
    p = convert.gat_params_from_numpy(np.asarray(jp.W), np.asarray(jp.a1),
                                      np.asarray(jp.a2), device=CPU)
    rows, cols, vals = gat.graph_coo(n, 6, seed=seed)
    return H, jp, p, rows, cols, vals


@pytest.mark.parametrize("p_ranks", [1, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_gat_layer_served_matches_distributed(family, p_ranks):
    """The served GAT query path == the port's full distributed layer on
    the queried rows, bit for bit (one head), and the reference's served
    rows within the app tests' tolerance (float data)."""
    n, d = 64, 8
    H, jp, p, rows, cols, vals = _gat_case(n, d)
    devs = [CPU] * p_ranks
    pool = serving.SessionPool(capacity=2)
    dep = gat.gat_deploy_layer(pool, rows, cols, n, H, p,
                               algorithm=family, devices=devs)
    eng = serving.ServingEngine(pool)
    node_ids = np.array([50, 3, 17, 3])
    out = gat.gat_layer_served(eng, dep, node_ids)
    graphP = api.make_problem(rows, cols, vals, (n, n), d,
                              algorithm=family, devices=devs)
    want = gat.gat_layer_distributed(graphP, H, p, n_heads=1)
    np.testing.assert_array_equal(_np(out), _np(want)[[3, 17, 50]])
    jpool = jserving.SessionPool(capacity=2)
    jdep = jgat.gat_deploy_layer(jpool, rows, cols, n, H, jp,
                                 algorithm=family, devices=REF.devices)
    ref = jgat.gat_layer_served(jserving.ServingEngine(jpool), jdep,
                                node_ids)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=5e-4,
                               atol=5e-4)


def test_gat_query_edges_and_validation():
    n = 64
    H, jp, p, rows, cols, vals = _gat_case(n)
    pool = serving.SessionPool(capacity=2)
    dep = gat.gat_deploy_layer(pool, rows, cols, n, H, p, devices=[CPU])
    jdep = jgat.gat_deploy_layer(jserving.SessionPool(), rows, cols, n, H,
                                 jp, devices=REF.devices)
    ids = [40, 7, 7, 63]
    er, ec, pos = gat.gat_query_edges(dep, ids)
    jr, jc, mask = jgat.gat_query_edges(jdep, ids)
    np.testing.assert_array_equal(er, jr)
    np.testing.assert_array_equal(ec, jc)
    np.testing.assert_array_equal(pos, np.flatnonzero(mask))
    with pytest.raises(ValueError, match="sorted"):
        gat.gat_deploy_layer(pool, rows[::-1], cols[::-1], n, H, p,
                             devices=[CPU])
    # the activation sees the whole output, as the distributed layer's
    eng = serving.ServingEngine(pool)
    shapes = []
    lin = gat.gat_layer_served(eng, dep, [5, 9], activation=lambda x: (
        shapes.append(tuple(x.shape)) or x))
    graphP = api.make_problem(rows, cols, vals, (n, n), 8, devices=[CPU])
    want = gat.gat_layer_distributed(graphP, H, p, activation=lambda x: x)
    assert shapes == [(n, 8)]
    np.testing.assert_array_equal(_np(lin), _np(want)[[5, 9]])


# -- batcher unit planning -------------------------------------------------

def test_score_unit_planning_rules():
    def scenario(pk):
        rng = np.random.default_rng(11)
        pool = pk.serving.SessionPool(capacity=2)
        m, n, w = 48, 40, 4
        U, V = _int_mat(rng, (m, w)), _int_mat(rng, (n, w))
        dep = _deploy(pk, pool, operands={"U": U, "V": V})
        eng = pk.serving.ServingEngine(pool)
        # same X, overlapping rows: one unit
        ts = [eng.submit_score(dep, [1, 2], [0, 1], "U", "V"),
              eng.submit_score(dep, [2, 3], [1, 2], "U", "V")]
        # another X, rows disjoint from all above: joins by scatter
        ts.append(eng.submit_score(dep, [30, 31], [0, 1],
                                   _int_mat(rng, (m, w)), "V"))
        # another X overlapping the scatter unit: a new unit
        ts.append(eng.submit_score(dep, [31, 40], [2, 3],
                                   _int_mat(rng, (m, w)), "V"))
        units = pk.batcher.plan_score_units(eng.queue.drain())
        for u in units:
            pk.batcher.execute_score_unit(u)
        return (_answers(ts), _solo(pk, ts),
                sorted((len(u.tickets), u.scatter) for u in units))

    assert _both(scenario) == [(1, False), (3, True)]


def test_run_until_drained_and_stats():
    rng = np.random.default_rng(19)
    pool = serving.SessionPool(capacity=2)
    U, V = _int_mat(rng, (48, 4)), _int_mat(rng, (40, 4))
    dep = _deploy(PORT, pool, operands={"U": U, "V": V})
    eng = serving.ServingEngine(pool, max_batch=2)
    for k in range(5):
        eng.submit_score(dep, [k], [k], "U", "V")
    assert eng.run_until_drained() == 3
    s = eng.stats()
    assert s["served"] == 5 and s["rounds"] == 3 and s["failed"] == 0
    assert s["queue"]["admitted"] == 5 and s["pool"]["occupancy"] == 1
    assert eng.tick()["requests"] == 0
