"""The serving engine on 8 stacked ranks across mid-stream device loss,
after tests/dist_scripts/check_serving.py.

One scenario, written once for both packages: CF factors deployed on 8
ranks serve seeded score and lookup traffic in coalesced ticks (integer
data, so every sum is exact); a batched tick equals solo execution; a
``DeviceLost`` at rank 3 in a score round and then one at rank 1 in an
aggregation round re-plan the deployment onto smaller grids while the
answers stay exact; steady state continues on the degraded grid with
the Session re-warmed; a GAT deployment serves beside it, the pool
evicts the idle CF deployment, and an open-loop trace replays.  The
reference runs the scenario in a subprocess with 8 forced host devices
(this file run as a script); the port runs it on 8 stacked CPU ranks.
Every answer must equal the reference's bit for bit (the GAT layer's
float rows within the app tests' tolerance, and the port's own
distributed layer bit for bit), as must each recovery's grid.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
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


def scenario(pk):
    """check_serving.py's phases through package ``pk``; returns the
    answers (exact), the GAT rows (float) and the facts to compare."""
    import torch
    exact_scores = _exact_scores()
    rng = np.random.default_rng(0)

    def int_mat(shape):
        return rng.integers(-3, 4, shape).astype(np.float32)

    rows, cols, vals = _int_graph(M, N, 2000, seed=1)
    dense = np.zeros((M, N), np.float32)
    dense[rows, cols] = vals
    U, V = int_mat((M, R)), int_mat((N, R))
    pool = pk.serving.SessionPool(capacity=2)
    dep = pk.als.deploy_factors(pool, rows, cols, vals, (M, N), U, V,
                                devices=pk.devices)
    eng = pk.serving.ServingEngine(pool, max_batch=32)
    out = dict(answers=[], facts=[("deployed", dep.problem.alg.name,
                                   dep.problem.p, dep.problem.c)])

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
    for _ in range(3):
        tickets = []
        for _ in range(4):
            k = int(rng.integers(2, 9))
            tickets.append(pk.als.predict_scores(
                eng, dep, rng.integers(0, M, k), rng.integers(0, N, k)))
        for _ in range(3):
            tickets.append(pk.als.lookup_embeddings(
                eng, dep, int_mat((N, int(rng.integers(1, 5))))))
        rep = eng.tick()
        out["facts"].append(("tick", rep["requests"], rep["rounds"]))
        check(tickets)
    sess0 = dep.session.stats()
    assert sess0["hits"] > 0

    # phase 2: a batched tick == solo per-request execution
    tickets = []
    for _ in range(5):
        k = int(rng.integers(2, 9))
        tickets.append(pk.als.predict_scores(
            eng, dep, rng.integers(0, M, k), rng.integers(0, N, k)))
    tickets.append(eng.submit_score(dep, [100, 101], [5, 6],
                                    int_mat((M, R)), "V"))
    tickets.append(pk.als.lookup_embeddings(eng, dep, int_mat((N, 3))))
    eng.tick()
    check(tickets)
    for t in tickets:
        solo = pk.serving.Ticket(t.request, seq=-1)
        pk.batcher.execute_solo(solo, use_session=False)
        assert np.array_equal(_np(solo.result()), _np(t.result()))

    # phases 3 and 4: DeviceLost in a score round, then in an aggregation
    for op, rank, submit in (
            ("sddmm", 3, lambda: pk.als.predict_scores(
                eng, dep, rng.integers(0, M, 6), rng.integers(0, N, 6))),
            ("spmm", 1, lambda: pk.als.lookup_embeddings(
                eng, dep, int_mat((N, 2))))):
        p_before = dep.problem.p
        plan = pk.faults.FaultPlan.scripted(pk.faults.FaultSpec(
            op=op, kind="device_lost", rank=rank, round=0))
        with pk.faults.inject(plan) as ctl:
            tickets = [submit() for _ in range(4 if op == "sddmm" else 3)]
            eng.tick()
        assert len(ctl.fired) == 1 and ctl.fired[0]["op"] == op
        assert dep.problem.p < p_before
        rec = dep.elastic.recoveries[-1]
        assert rec["remeshed_to_p"] == dep.problem.p
        out["facts"].append(("recovered", rec["op"], rec["p"],
                             rec["remeshed_to_p"], rec["family_after"],
                             dep.problem.c))
        check(tickets)

    # phase 5: steady state on the degraded grid, the Session re-warmed
    for _ in range(2):
        tickets = [pk.als.predict_scores(eng, dep, rng.integers(0, M, 5),
                                         rng.integers(0, N, 5))
                   for _ in range(3)]
        eng.tick()
        check(tickets)
    sess1 = dep.session.stats()
    assert sess1["hits"] > sess0["hits"]
    out["facts"].append(("session", sess0, sess1))

    # phase 6: a GAT deployment beside it, then pool churn under traffic
    H = int_mat((N_GAT, D_GAT))
    g_rows, g_cols, g_vals = pk.gat.graph_coo(N_GAT, 6, seed=3)
    dep_gat = pk.gat.gat_deploy_layer(pool, g_rows, g_cols, N_GAT, H,
                                      pk.gat_params, devices=pk.devices)
    node_ids = np.array([5, 40, 77])
    served = _np(pk.gat.gat_layer_served(eng, dep_gat, node_ids))
    graphP = pk.api.make_problem(g_rows, g_cols, g_vals, (N_GAT, N_GAT),
                                 D_GAT, devices=pk.devices)
    full = _np(pk.gat.gat_layer_distributed(graphP, H, pk.gat_params))
    assert np.array_equal(served, full[node_ids])
    rows3, cols3, vals3 = _int_graph(64, 64, 700, seed=4)
    dep3 = pool.deploy(rows3, cols3, vals3, (64, 64), 8,
                       devices=pk.devices)
    stats = pool.stats()
    assert dep.key not in pool.keys and dep_gat.key in pool.keys
    again = _np(pk.gat.gat_layer_served(eng, dep_gat, node_ids))
    assert np.array_equal(again, served)
    out["gat"] = [served, full]
    out["facts"].append(("gat", dep_gat.problem.alg.name, dep_gat.problem.p,
                         graphP.alg.name))
    # the GAT operands' float bits (and so its key) differ by package
    out["facts"].append(("pool", {k: v for k, v in stats.items()
                                  if k != "session"}, dep3.key,
                         pool.keys[-1] == dep3.key))

    # phase 7: an open-loop replay against the GAT deployment
    eng2 = pk.serving.ServingEngine(pool, max_batch=8)

    def submit_score(seed):
        def submit(engine, arrival):
            r2 = np.random.default_rng(seed)
            return engine.submit_score(
                dep_gat, r2.integers(0, N_GAT, 4), r2.integers(0, N_GAT, 4),
                "A", "B", arrival=arrival)
        return submit

    res = pk.serving.replay_trace(
        eng2, [(0.002 * i, submit_score(i)) for i in range(12)])
    assert res["served"] == 12 and res["p99"] >= res["p50"] > 0
    out["gat"].append(np.concatenate([_np(t.result())
                                      for t in res["tickets"]]))
    out["facts"].append(("replay", res["served"], res["shed"]))
    return out


def _jsonable(out):
    """The scenario's output as JSON reads it back (so both sides compare
    as lists)."""
    return json.loads(json.dumps(dict(
        answers=[a.tolist() for a in out["answers"]],
        gat=[a.tolist() for a in out["gat"]], facts=out["facts"])))


def _reference():
    import jax
    from repro import serving
    from repro.apps import als, gat
    from repro.core import api
    from repro.distributed import faults
    from repro.serving import batcher
    assert len(jax.devices()) == 8
    pk = types.SimpleNamespace(
        serving=serving, batcher=batcher, api=api, als=als, gat=gat,
        faults=faults, devices=None,
        gat_params=gat.init_gat_layer(jax.random.PRNGKey(2), D_GAT, D_GAT))
    return _jsonable(scenario(pk))


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    import jax
    import torch
    from repro.apps import gat as jgat
    from repro_torch import convert, serving
    from repro_torch.apps import als, gat
    from repro_torch.core import api
    from repro_torch.distributed import faults
    from repro_torch.serving import batcher
    jp = jgat.init_gat_layer(jax.random.PRNGKey(2), D_GAT, D_GAT)
    cpu = torch.device("cpu")
    pk = types.SimpleNamespace(
        serving=serving, batcher=batcher, api=api, als=als, gat=gat,
        faults=faults, devices=[cpu] * 8,
        gat_params=convert.gat_params_from_numpy(
            np.asarray(jp.W), np.asarray(jp.a1), np.asarray(jp.a2),
            device=cpu))
    return _jsonable(scenario(pk))


def _facts(out, kind):
    return [f for f in out["facts"] if f[0] == kind]


def test_answers_equal_the_references_bit_for_bit(reference, port):
    assert len(port["answers"]) == len(reference["answers"]) == 41
    for got, want in zip(port["answers"], reference["answers"]):
        assert np.array_equal(np.float32(got), np.float32(want))


@pytest.mark.parametrize("kind", ["deployed", "tick", "session"])
def test_deployment_and_steady_state_as_the_references(reference, port,
                                                       kind):
    assert _facts(port, kind) == _facts(reference, kind)
    if kind == "tick":
        assert all(f[1:] == [7, 2] for f in _facts(port, kind))


def test_device_lost_mid_stream_replans_as_the_reference(reference, port):
    got = _facts(port, "recovered")
    assert got == _facts(reference, "recovered")
    assert [f[1] for f in got] == ["serve.score", "spmm_batched"]
    assert got[0][2] == 8 and got[0][3] < 8 and got[1][3] < got[0][3]


def test_gat_pool_churn_and_replay(reference, port):
    for kind in ("gat", "pool", "replay"):
        assert _facts(port, kind) == _facts(reference, kind), kind
    for got, want in zip(port["gat"], reference["gat"]):
        np.testing.assert_allclose(np.float32(got), np.float32(want),
                                   rtol=5e-4, atol=5e-4)


if __name__ == "__main__":
    print(json.dumps(_reference()))
