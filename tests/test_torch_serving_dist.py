"""The serving engine across a process group, after
tests/dist_scripts/check_serving.py.

One scenario, written once for three runs on the same integer data (so
every sum is exact): the reference's single controller on 4 host
devices (a subprocess, this file run as a script), the port's engine on
4 stacked CPU ranks (no group), and the port's engine over 4 gloo ranks
(this file run as a script, tests/_torch_spawn.py), where rank 0 is the
front end that submits and ticks and ranks 1-3 follow its tick records.
CF factors serve coalesced score and lookup ticks; a batched tick
equals the solo engine's; a ``DeviceLost`` at rank 3 in a score round
and then one at rank 1 in an aggregation round degrade the deployment
(4 -> 2 -> 1) while the retired ranks keep following; steady state
continues with the Session re-warmed; a GAT deployment serves beside it
under pool churn at capacity 2, and an open-loop trace replays.  The
port's own phases add client tensors (whose identities differ on every
rank), a tick whose retries are exhausted, rejected requests, and the
served primitives (``with_pattern``, ``with_r``, ``spmm_batched``)
under the group.  Every answer must equal the reference's and the
stacked engine's bit for bit, and every rank's tick reports, Session
counts and pool stats the front end's.
"""
import contextlib
import importlib.util
import itertools
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import _torch_spawn  # noqa: E402
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
M, N, R = 128, 96, 16
N_GAT, D_GAT = 96, 8


def _exact_scores():
    """chip_smoke.py's exact dots (the card's check), loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.exact_scores


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _int_graph(m, n, nnz, seed):
    r2 = np.random.default_rng(seed)
    key = np.unique(r2.integers(0, m * n, nnz))
    rows = (key // n).astype(np.int64)
    cols = (key % n).astype(np.int64)
    vals = (r2.integers(1, 4, len(key))
            * r2.choice([-1.0, 1.0], len(key))).astype(np.float32)
    return rows, cols, vals


def _fixed_clock():
    """A clock that advances 1 ms a reading: a replay's latencies then
    depend on the ticks alone."""
    count = itertools.count()
    return lambda: next(count) * 1e-3


def _served(pk, eng, fn, plan=None):
    """The front end's part ``fn`` (its submissions and ticks) on the
    front end or a single controller, ``follow()`` on the other ranks
    until the front end's ``stop()``; ``plan`` armed on every rank.
    Returns (fn's result, or None on a follower; the fault controller)."""
    ctx = pk.faults.inject(plan) if plan is not None \
        else contextlib.nullcontext()
    with ctx as ctl:
        if pk.role == "follower":
            res = None
            pk.out["followed"].append(eng.follow(on_tick=pk.log_tick))
        else:
            res = fn()
            if pk.role == "front":
                eng.stop()
    return res, ctl


def _engine(pk, pool, **kw):
    eng = pk.serving.ServingEngine(pool, **kw, **pk.group_kw)
    if pk.role != "follower":
        orig = eng.tick

        def tick():
            rep = orig()
            pk.log_tick(rep)
            return rep

        eng.tick = tick
    return eng


def scenario(pk):
    """check_serving.py's phases through package ``pk`` in its role
    ("single", "front" or "follower"); returns the answers (front end
    only) and the facts every rank records."""
    import torch
    exact_scores = _exact_scores()
    rng = np.random.default_rng(0)          # traffic: the front end's
    data = np.random.default_rng(100)       # deployed data: every rank's
    front = pk.role != "follower"
    out = pk.out = dict(answers=[], facts=[], ticks=[], followed=[],
                        gat=[])

    def log_tick(rep):
        out["ticks"].append([rep["requests"], rep["rounds"]])

    pk.log_tick = log_tick

    def int_mat(shape, gen=rng):
        return gen.integers(-3, 4, shape).astype(np.float32)

    rows, cols, vals = _int_graph(M, N, 2000, seed=1)
    dense = np.zeros((M, N), np.float32)
    dense[rows, cols] = vals
    U, V = int_mat((M, R), data), int_mat((N, R), data)
    pool = pk.serving.SessionPool(capacity=2)
    dep = pk.als.deploy_factors(pool, rows, cols, vals, (M, N), U, V,
                                **pk.where)
    eng = _engine(pk, pool, max_batch=32)
    out["facts"].append(("deployed", dep.problem.alg.name, dep.problem.p,
                         dep.problem.c))

    def check(tickets):
        for t in tickets:
            req, got = t.request, _np(t.result())
            if req.kind == "score":
                want = exact_scores(
                    torch, torch.as_tensor(_np(req.X)),
                    torch.as_tensor(_np(req.Y)), req.rows,
                    req.cols).numpy()
            else:
                d = dense
                if req.vals is not None:
                    d = np.zeros((M, N), np.float32)
                    d[rows, cols] = _np(req.vals)
                want = d @ _np(req.Y)
            assert np.array_equal(got, want), f"{req.kind} not exact"
            out["answers"].append(got)

    # phase 1: steady state, coalesced ticks
    def steady():
        for _ in range(3):
            tickets = []
            for _ in range(4):
                k = int(rng.integers(2, 9))
                tickets.append(pk.als.predict_scores(
                    eng, dep, rng.integers(0, M, k), rng.integers(0, N, k)))
            for _ in range(3):
                tickets.append(pk.als.lookup_embeddings(
                    eng, dep, int_mat((N, int(rng.integers(1, 5))))))
            eng.tick()
            check(tickets)

    _served(pk, eng, steady)
    sess0 = dep.session.stats()
    assert sess0["hits"] > 0

    # phase 2: a batched tick == the solo engine's, request for request
    solo = _engine(pk, pool, max_batch=32, batching=False,
                   use_session=False)

    def batched():
        tickets = []
        for _ in range(5):
            k = int(rng.integers(2, 9))
            tickets.append(pk.als.predict_scores(
                eng, dep, rng.integers(0, M, k), rng.integers(0, N, k)))
        tickets.append(eng.submit_score(dep, [100, 101], [5, 6],
                                        int_mat((M, R)), "V"))
        tickets.append(pk.als.lookup_embeddings(eng, dep,
                                                int_mat((N, 3))))
        eng.tick()
        check(tickets)
        return tickets

    tickets, _ = _served(pk, eng, batched)

    def solo_tick():
        mine = [solo.queue.submit(t.request) for t in tickets]
        solo.tick()
        for t, s in zip(tickets, mine):
            assert np.array_equal(_np(s.result()), _np(t.result()))

    _served(pk, solo, solo_tick)

    if pk.port:     # on their own draws: the reference's traffic follows
        own = np.random.default_rng(9)
        _port_phases(pk, pool, dep, eng, check,
                     lambda shape: int_mat(shape, own))

    # phases 3 and 4: DeviceLost in a score round, then in an aggregation
    for op, rank, k in (("sddmm", 3, 4), ("spmm", 1, 3)):
        p_before = dep.problem.p
        held = getattr(dep, "retired", None) is None
        plan = pk.faults.FaultPlan.scripted(pk.faults.FaultSpec(
            op=op, kind="device_lost", rank=rank, round=0))

        def lose(op=op, k=k):
            if op == "sddmm":
                tickets = [pk.als.predict_scores(
                    eng, dep, rng.integers(0, M, 6), rng.integers(0, N, 6))
                    for _ in range(k)]
            else:
                tickets = [pk.als.lookup_embeddings(eng, dep,
                                                    int_mat((N, 2)))
                           for _ in range(k)]
            eng.tick()
            check(tickets)

        _, ctl = _served(pk, eng, lose, plan)
        out["facts"].append(("fired", op, [c["op"] for c in ctl.fired]))
        if getattr(dep, "retired", None) is not None:
            e = dep.retired
            if held:
                out["facts"].append(("left", e.rank, e.p, e.lost_rank))
            continue
        assert dep.problem.p < p_before
        rec = dep.elastic.recoveries[-1]
        assert rec["remeshed_to_p"] == dep.problem.p
        out["facts"].append(("recovered", rec["op"], rec["p"],
                             rec["remeshed_to_p"], rec["family_after"],
                             dep.problem.c))

    # phase 5: steady state on the degraded grid, the Session re-warmed
    def degraded():
        for _ in range(2):
            tickets = [pk.als.predict_scores(
                eng, dep, rng.integers(0, M, 5), rng.integers(0, N, 5))
                for _ in range(3)]
            eng.tick()
            check(tickets)

    _served(pk, eng, degraded)
    sess1 = dep.session.stats()
    if front:
        assert sess1["hits"] > sess0["hits"]
    out["facts"].append(("session", sess0))
    if getattr(dep, "retired", None) is None:
        out["facts"].append(("session_after", sess1))
    if pk.port:
        # a grid whose one fiber spans the job, made after ranks 2-3
        # missed the second degrade's group (ranks 0-1 have made one
        # more): the grid's processes agree on its subgroup's name first
        fibers = pk.api.make_problem(rows, cols, vals, (M, N), R,
                                     algorithm="d25", c=4, **pk.where)
        got = fibers.sddmm(U, V).values()
        want = vals * (U[rows].astype(np.float64)
                       * V[cols]).sum(1).astype(np.float32)
        out["facts"].append(("fibers", fibers.c,
                             bool(np.array_equal(got, want))))

    # phase 6: a GAT deployment beside it, then pool churn under traffic
    H = int_mat((N_GAT, D_GAT), data)
    g_rows, g_cols, g_vals = pk.gat.graph_coo(N_GAT, 6, seed=3)
    dep_gat = pk.gat.gat_deploy_layer(pool, g_rows, g_cols, N_GAT, H,
                                      pk.gat_params, **pk.where)
    node_ids = np.array([5, 40, 77])
    served, _ = _served(pk, eng, lambda: _np(pk.gat.gat_layer_served(
        eng, dep_gat, node_ids)))
    graphP = pk.api.make_problem(g_rows, g_cols, g_vals, (N_GAT, N_GAT),
                                 D_GAT, **pk.where)
    full = _np(pk.gat.gat_layer_distributed(graphP, H, pk.gat_params))
    rows3, cols3, vals3 = _int_graph(64, 64, 700, seed=4)
    dep3 = pool.deploy(rows3, cols3, vals3, (64, 64), 8, **pk.where)
    stats = pool.stats()
    assert dep.key not in pool.keys and dep_gat.key in pool.keys
    again, _ = _served(pk, eng, lambda: _np(pk.gat.gat_layer_served(
        eng, dep_gat, node_ids)))
    if front:
        assert np.array_equal(served, full[node_ids])
        assert np.array_equal(again, served)
        out["gat"] = [served, full]
    out["facts"].append(("gat", dep_gat.problem.alg.name, dep_gat.problem.p,
                         graphP.alg.name))
    # the GAT operands' float bits (and so its key) differ by package
    out["facts"].append(("pool", {k: v for k, v in stats.items()
                                  if k != "session"}, dep3.key,
                         pool.keys[-1] == dep3.key))

    # phase 7: an open-loop replay against the GAT deployment
    eng2 = _engine(pk, pool, max_batch=8)
    if pk.port:
        eng2.clock = _fixed_clock()

    def submit_score(seed):
        def submit(engine, arrival):
            r2 = np.random.default_rng(seed)
            return engine.submit_score(
                dep_gat, r2.integers(0, N_GAT, 4), r2.integers(0, N_GAT, 4),
                "A", "B", arrival=arrival)
        return submit

    res, _ = _served(pk, eng2, lambda: pk.serving.replay_trace(
        eng2, [(0.002 * i, submit_score(i)) for i in range(12)]))
    if front:
        assert res["served"] == 12 and res["p99"] >= res["p50"] > 0
        out["gat"].append(np.concatenate([_np(t.result())
                                          for t in res["tickets"]]))
        out["facts"].append(("replay", res["served"], res["shed"]))
        if pk.port:
            out["facts"].append(("latency", [res[k] for k in (
                "p50", "p99", "mean", "max", "throughput")]))
    if pk.port:
        out["facts"].append(("engine", eng2.stats()))
    return out


def _port_phases(pk, pool, dep, eng, check, int_mat):
    """The port's own phases, on 4 ranks before the losses: client
    tensors, a tick whose retries are exhausted, rejected requests."""
    import torch
    from repro_torch.core import api
    front = pk.role != "follower"
    out = pk.out

    # client tensors: one X shared by two requests, a copy of it (another
    # identity, so another key), one W in two lookups; a follower's
    # tensors are its own, keyed as on the front end
    def tensors():
        X = torch.from_numpy(int_mat((M, R)))
        W = torch.from_numpy(int_mat((N, 2)))
        tickets = [eng.submit_score(dep, [1, 2, 3], [4, 5, 6], X, "V"),
                   eng.submit_score(dep, [7, 8], [9, 10], X, "V"),
                   eng.submit_score(dep, [1, 11], [12, 13], X.clone(), "V"),
                   eng.submit_aggregate(dep, W),
                   eng.submit_aggregate(dep, W)]
        eng.tick()
        check(tickets)

    keys = []

    def log_keys(rep):
        pk.log_tick(rep)
        keys.append([(t.request.x_key, t.request.y_key)
                     if t.request.kind == "score" else t.request.vals_key
                     for t in rep["tickets"]])
        out["facts"].append(("record", rep.get("record_bytes")))

    if front:
        orig = eng.tick

        def tick():
            rep = orig()
            keys.append([(t.request.x_key, t.request.y_key)
                         if t.request.kind == "score"
                         else t.request.vals_key for t in rep["tickets"]])
            out["facts"].append(("record", rep.get("record_bytes")))
            return rep

        eng.tick = tick
        tensors()
        eng.tick = orig
        if pk.role == "front":
            eng.stop()
    else:
        out["followed"].append(eng.follow(on_tick=log_keys))
    out["keys"] = keys

    # a tick whose retries are all used fails its tickets; the next serves
    plan = pk.faults.FaultPlan.scripted(*(
        pk.faults.FaultSpec(op="sddmm", round=k) for k in range(4)))

    def exhausted():
        doomed = [pk.als.predict_scores(eng, dep, [1, 2], [3, 4]),
                  pk.als.lookup_embeddings(eng, dep, int_mat((N, 1)))]
        eng.tick()
        for t in doomed:
            with pytest.raises(api.FaultRecoveryError):
                t.result()
        fine = [pk.als.predict_scores(eng, dep, [1, 2], [3, 4])]
        eng.tick()
        check(fine)

    _, ctl = _served(pk, eng, exhausted, plan)
    out["facts"].append(("exhausted", len(ctl.fired),
                         dep.elastic.recoveries[-1]["attempt"]))

    # requests the front end rejects never reach a follower
    other = pk.serving.SessionPool(capacity=1)

    def rejected():
        with pytest.raises(ValueError):
            eng.submit_score(dep, [1], [2], int_mat((M + 1, R)), "V")
        good = [pk.als.predict_scores(eng, dep, [5], [6])]
        eng.tick()
        check(good)

    _served(pk, eng, rejected)
    if pk.role == "single":
        return
    # a deployment that is not the pool's fails on the front end alone
    # and stays out of the record (its tick is left out of the reports)
    if front:
        alien = other.deploy(*_int_graph(M, N, 300, seed=5), (M, N), R,
                             devices=[torch.device("cpu")])
        bad = eng.submit_score(alien, [1], [2], int_mat((M, R)),
                               int_mat((N, R)))
        rep = type(eng).tick(eng)
        with pytest.raises(RuntimeError, match="not resident"):
            bad.result()
        out["facts"].append(("alien", rep["requests"], rep["rounds"]))
        eng.stop()
    else:
        eng.follow(on_tick=lambda rep: out["facts"].append(
            ("alien", rep["requests"], rep["rounds"])))
        try:
            pk.als.predict_scores(eng, dep, [1], [2])
        except RuntimeError as e:
            out["facts"].append(("submit_raises", "front end" in str(e)))


def _jsonable(out):
    return json.loads(json.dumps(dict(
        answers=[np.asarray(a).tolist() for a in out["answers"]],
        gat=[np.asarray(a).tolist() for a in out["gat"]],
        facts=out["facts"], ticks=out["ticks"],
        followed=out["followed"], keys=out.get("keys"))))


def _reference():
    import jax
    from repro import serving
    from repro.apps import als, gat
    from repro.core import api
    from repro.distributed import faults
    assert len(jax.devices()) == WORLD
    pk = types.SimpleNamespace(
        serving=serving, api=api, als=als, gat=gat, faults=faults,
        where={}, group_kw={}, role="single", port=False,
        gat_params=gat.init_gat_layer(jax.random.PRNGKey(2), D_GAT, D_GAT))
    return _jsonable(scenario(pk))


def _port(role, params, group=None):
    import torch
    from repro_torch import convert, serving
    from repro_torch.apps import als, gat
    from repro_torch.core import api
    from repro_torch.distributed import faults
    cpu = torch.device("cpu")
    pk = types.SimpleNamespace(
        serving=serving, api=api, als=als, gat=gat, faults=faults,
        where=dict(devices=[cpu] * WORLD, group=group),
        group_kw=dict(group=group), role=role, port=True,
        gat_params=convert.gat_params_from_numpy(*params, device=cpu))
    return _jsonable(scenario(pk))


@contextlib.contextmanager
def _contiguous_operands():
    """The kernels' contract on the card, held on the CPU: every tensor a
    kernel wrapper is handed is contiguous (``_build.validate``)."""
    import torch
    from repro_torch.kernels import ops
    names = ("sddmm_cuda", "spmm_cuda", "fusedmm_cuda")
    orig = {k: getattr(ops, k) for k in names}

    def checked(fn):
        def call(*a, **k):
            if not all(t.is_contiguous() for t in a
                       if isinstance(t, torch.Tensor)):
                raise ValueError(f"{fn.__name__}: operands must be "
                                 "contiguous")
            return fn(*a, **k)
        return call

    for k in names:
        setattr(ops, k, checked(orig[k]))
    try:
        yield
    finally:
        for k in names:
            setattr(ops, k, orig[k])


def _primitives(params, group=None):
    """with_pattern, with_r (past its DERIVED_R_MAX widths) and
    spmm_batched, plain and elastic, on 4 ranks, and the GAT layer on s15
    at c = 2 (its score operands one column a slab: gathered, two), each
    kernel's operands contiguous: the gathered results."""
    import torch
    from repro_torch import convert
    from repro_torch.apps import gat
    from repro_torch.core import api
    with _contiguous_operands():
        return _served_primitives(params, group, convert, gat, api)


def _served_primitives(params, group, convert, gat, api):
    import torch
    cpu = torch.device("cpu")
    rows, cols, vals = _int_graph(M, N, 2000, seed=1)
    rng = np.random.default_rng(7)
    prob = api.make_problem(rows, cols, vals, (M, N), R,
                            devices=[cpu] * WORLD, group=group)
    mult = prob.alg.min_r_multiple(prob.grid)
    X = rng.integers(-3, 4, (M, 2 * mult)).astype(np.float32)
    Y = rng.integers(-3, 4, (N, 2 * mult)).astype(np.float32)
    qr, qc = rng.integers(0, M, 40), rng.integers(0, N, 40)
    qp = prob.with_pattern(qr, qc).with_r(2 * mult)
    res = qp.sddmm(X, Y)
    out = {"pattern": res.values_tensor().numpy(),
           "pattern_host": res.values()}
    Ws = [rng.integers(-3, 4, (N, w)).astype(np.float32) for w in (3, 5)]
    for i, W in enumerate(prob.spmm_batched(Ws, pad_to=16 * mult)):
        out[f"batched{i}"] = W.numpy()
    ep = api.ElasticProblem(prob, session=api.Session())
    for i, W in enumerate(ep.spmm_batched(Ws)):
        out[f"elastic{i}"] = W.numpy()
    for k in range(1, 6):
        pk = prob.with_r(k * mult)
        out[f"r{k}"] = api.gathered(pk.spmm(
            rng.integers(-3, 4, (N, k * mult)).astype(np.float32))).numpy()
    g_rows, g_cols, g_vals = gat.graph_coo(N_GAT, 6, seed=3)
    gp = api.make_problem(g_rows, g_cols, g_vals, (N_GAT, N_GAT), D_GAT,
                          algorithm="s15", c=2, devices=[cpu] * WORLD,
                          group=group)
    H = rng.integers(-3, 4, (N_GAT, D_GAT)).astype(np.float32)
    out["gat_s15"] = gat.gat_layer_distributed(
        gp, H, convert.gat_params_from_numpy(*params, device=cpu)).numpy()
    facts = dict(shared_grid=qp.grid is prob.grid,
                 derived=sorted(prob._derived_r), family=prob.alg.name)
    return out, facts


def worker(rank, world, init, out_dir, params):
    dist = _torch_spawn.join(rank, world, init)
    p = np.load(params)
    p = [p[k] for k in ("W", "a1", "a2")]
    arrays, facts = _primitives(p, dist.group.WORLD)
    record = _port("front" if rank == 0 else "follower", p,
                   dist.group.WORLD)
    record["primitives"] = facts
    dist.barrier()
    _torch_spawn.save(out_dir, rank, arrays, record)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's run, the stacked port's, every gloo rank's
    (arrays, record)), the reference and the ranks running beside the
    stacked run."""
    import jax
    import torch
    from repro.apps import gat as jgat
    out_dir = tmp_path_factory.mktemp("serving_dist")
    jp = jgat.init_gat_layer(jax.random.PRNGKey(2), D_GAT, D_GAT)
    params = [np.asarray(jp.W), np.asarray(jp.a1), np.asarray(jp.a2)]
    np.savez(out_dir / "params.npz", W=params[0], a1=params[1],
             a2=params[2])
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, __file__, "reference"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            stacked = _port("single", params)
            prims = _primitives(params)
        finally:
            torch.set_num_threads(threads)
        ranks = _torch_spawn.spawn(__file__, WORLD, str(out_dir / "w4"),
                                   str(out_dir / "params.npz"))
        so, se = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, so[-3000:] + se[-3000:]
    reference = json.loads(so.strip().splitlines()[-1])
    return reference, stacked, prims, ranks


def _facts(out, kind):
    return [f for f in out["facts"] if f[0] == kind]


def _front(runs):
    return runs[3][0][1]


def test_answers_equal_the_reference_and_the_stacked_engine(runs):
    reference, stacked, _, ranks = runs
    front = _front(runs)
    assert len(reference["answers"]) == 41
    # the port's own phases add 5 + 1 + 1 answers before the losses
    assert len(front["answers"]) == len(stacked["answers"]) == 48
    shared = front["answers"][:28] + front["answers"][35:]
    for got, want in zip(shared, reference["answers"]):
        assert np.array_equal(np.float32(got), np.float32(want))
    for got, want in zip(front["answers"], stacked["answers"]):
        assert np.array_equal(np.float32(got), np.float32(want))
    for _, rec in ranks[1:]:
        assert rec["answers"] == []


@pytest.mark.parametrize("kind", ["deployed", "session", "recovered",
                                  "gat", "pool", "replay"])
def test_facts_equal_the_references(runs, kind):
    reference, stacked, _, _ = runs
    front = _front(runs)
    assert _facts(front, kind) == _facts(reference, kind) == \
        _facts(stacked, kind)


def test_tick_reports_equal_on_every_rank(runs):
    reference, stacked, _, ranks = runs
    front = _front(runs)
    assert front["ticks"] == stacked["ticks"]
    # the reference's ticks, without the port's phases (4 ticks) and the
    # replay (whose ticks follow the clock: the port's is a fixed one)
    assert front["ticks"][:5] + front["ticks"][9:17] == \
        reference["ticks"][:13]
    assert all(t == [7, 2] for t in front["ticks"][:3])
    for _, rec in ranks[1:]:
        assert rec["ticks"] == front["ticks"]
        # one follow() a served segment, each ended by stop()
        assert len(rec["followed"]) == 12
        assert sum(rec["followed"]) == len(front["ticks"])


def test_every_rank_keys_and_counts_as_the_front_end(runs):
    _, stacked, _, ranks = runs
    front = _front(runs)
    assert [len(k) for k in front["keys"]] == [5]
    x_keys = [k[0] for k in front["keys"][0][:3]]
    assert x_keys[0] == x_keys[1] != x_keys[2]
    assert x_keys[0].startswith("tensor:")
    for _, rec in ranks:
        assert rec["keys"] == front["keys"]
        assert _facts(rec, "record") == _facts(front, "record")
        for kind in ("deployed", "session", "pool", "gat"):
            assert _facts(rec, kind) == _facts(front, kind), kind
    # the record sends X, its copy and W once each: (2 * 128 + 96) * 16
    # * 4 bytes of tensors, plus the header
    sent = _facts(front, "record")[0][1]
    assert (128 * 16 * 2 + 96 * 2) * 4 < sent < (128 * 16 * 2 + 96 * 2) \
        * 4 + 8192
    assert _facts(front, "engine") == _facts(stacked, "engine")
    for _, rec in ranks:    # the queue is the front end's alone
        got, want = _facts(rec, "engine")[0][1], _facts(front, "engine")[0][1]
        assert {**got, "queue": None} == {**want, "queue": None}
        assert _facts(rec, "alien") == [["alien", 1, 0]]


def test_device_lost_retires_ranks_that_keep_following(runs):
    reference, _, _, ranks = runs
    recs = [rec for _, rec in ranks]
    got = _facts(recs[0], "recovered")
    assert [f[1] for f in got] == ["serve.score", "spmm_batched"]
    assert [(f[2], f[3]) for f in got] == [(4, 2), (2, 1)]
    # ranks 2 and 3 leave at the first loss, rank 1 at the second
    assert [_facts(r, "left") for r in recs] == [
        [], [["left", 1, 1, 1]], [["left", 2, 2, 3]], [["left", 3, 2, 3]]]
    assert _facts(recs[1], "recovered") == got[:1]
    assert [_facts(r, "fired") for r in recs] == \
        [[["fired", "sddmm", ["sddmm"]], ["fired", "spmm", ["spmm"]]]] * 2 \
        + [[["fired", "sddmm", ["sddmm"]], ["fired", "spmm", []]]] * 2
    # the front end's Session re-warmed on the degraded grid
    after = _facts(recs[0], "session_after")[0][1]
    assert after["hits"] > _facts(recs[0], "session")[0][1]["hits"]
    assert _facts(reference, "session")[0][1:] == \
        _facts(recs[0], "session")[0][1:]
    # every rank made the next grid's fiber subgroups in step
    assert [_facts(r, "fibers") for r in recs] == [[["fibers", 4, True]]] * 4


def test_exhausted_retries_and_rejections_leave_followers_serving(runs):
    _, stacked, _, ranks = runs
    for _, rec in ranks:
        assert _facts(rec, "exhausted") == [["exhausted", 4, 4]]
    assert _facts(stacked, "exhausted") == [["exhausted", 4, 4]]
    assert [_facts(rec, "submit_raises") for _, rec in ranks[1:]] == \
        [[["submit_raises", True]]] * 3


def test_replay_latency_equals_the_stacked_engines(runs):
    _, stacked, _, _ = runs
    front = _front(runs)
    assert _facts(front, "latency") == _facts(stacked, "latency")
    for got, want in zip(front["gat"], stacked["gat"]):
        assert np.array_equal(np.float32(got), np.float32(want))


def test_gat_rows_within_the_references_tolerance(runs):
    reference = runs[0]
    for got, want in zip(_front(runs)["gat"], reference["gat"]):
        np.testing.assert_allclose(np.float32(got), np.float32(want),
                                   rtol=5e-4, atol=5e-4)


def test_primitives_under_a_group_equal_stacked(runs):
    _, _, (want, facts), ranks = runs
    for arrays, rec in ranks:
        assert rec["primitives"] == dict(facts, shared_grid=True)
        assert len(rec["primitives"]["derived"]) == 4
        assert sorted(arrays) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(arrays[k], v), k


def test_records_travel_on_the_deployments_device():
    """Under NCCL a rank's tick records travel on the card its
    deployments live on, not on whichever card is current."""
    import torch
    from repro_torch import serving
    cpu = torch.device("cpu")
    pool = serving.SessionPool(capacity=1)
    rows, cols, vals = _int_graph(M, N, 300, 0)
    dep = pool.deploy(rows, cols, vals, (M, N), R, devices=[cpu] * WORLD)
    eng = serving.ServingEngine(pool)
    eng._backend = "nccl"
    assert eng._wire_device == dep.problem.grid.device


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
               sys.argv[6])
    else:
        print(json.dumps(_reference()))
