"""The port's torch.distributed collective backend against its stacked one.

Each world of ranks is spawned once: this file run as a script, one
process per rank, gloo on the CPU (NCCL on the cards for the ``cuda``
test), rendezvous through a file under ``tmp_path``.  Every rank builds
each case of its world through ``make_problem(..., group=WORLD)`` and
runs every op and every elision cell its family honours, the d15 and d25
executors with overlap on and off, and a Session-cached call; it saves
its blocks, the gathered global results and its collective log.  Here
the same problem runs stacked (``devices=[cpu] * p``), and each rank's
blocks must equal the stacked run's block of that rank bit for bit, the
gathered results the stacked results, and each rank's log the stacked
log and ``schedule_words``.  The c = 4 cases are the ones a
reduce-scatter summed out of fiber order would fail.  One d15 "fused"
case per grid is held to the reference's output (the reference
subprocess of tests/test_torch_d15.py) within tests/test_kernels.py's
tolerances, and "auto" to the reference's cost model.

Nothing here imports jax at collection: the reference runs only inside
the tests that need it.
"""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_spawn import spawn  # noqa: E402
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

# tests/test_torch_d15.py's problem, so its reference output applies
M, N, R, NNZ_ROW, SEED = 256, 320, 64, 5, 0
TILE = dict(row_tile=32, nz_block=32)
CELLS = {"d15": ("none", "reuse", "fused"), "s15": ("none", "reuse", "fused"),
         "d25": ("none", "reuse", "fused"), "s25": ("none", "reuse")}
#: (world size, family, c): p = 4 with c = 1, 2, 4 on 1.5D and c = 1 on
#: 2.5D; p = 8, c = 2 on every family
CASES = ([(4, f, c) for f in ("d15", "s15") for c in (1, 2, 4)]
         + [(4, f, 1) for f in ("d25", "s25")]
         + [(8, f, 2) for f in ("d15", "s15", "d25", "s25")])
WORLDS = sorted({w for w, _, _ in CASES})


def _ops(family):
    return ["sddmm", "spmm", "spmm_t"] + [f"fusedmm/{el}"
                                          for el in CELLS[family]]


def _leaves(res):
    """The tensors of an executor's result, depth first."""
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _leaves(r)]
    return [res]


def _problem(family, c, **kw):
    from repro_torch.core import api, sparse
    rows, cols, vals, X, Y = sparse.random_problem(M, N, R, NNZ_ROW,
                                                   seed=SEED)
    prob = api.make_problem(rows, cols, vals, (M, N), R, algorithm=family,
                            c=c, **TILE, **kw)
    return prob, X, Y


def _call(prob, op, X, Y, session=None):
    """The api's (executor, args, kwargs, post) of one op or cell."""
    alg = prob.alg
    if op == "sddmm":
        return alg._sddmm_call(prob, X, Y, session)
    if op == "spmm":
        return alg._spmm_call(prob, Y, None, session)
    if op == "spmm_t":
        return alg._spmm_t_call(prob, X, None, session)
    return alg._fusedmm_call(prob, X, Y, op.split("/")[1], session)


def _run_op(prob, op, X, Y, session=None):
    """What a user of the api gets: (dense result or None, SparseResult
    or None)."""
    if op == "sddmm":
        return None, prob.sddmm(X, Y, session=session)
    if op == "spmm":
        return prob.spmm(Y, session=session), None
    if op == "spmm_t":
        return prob.spmm_t(X, session=session), None
    return prob.fusedmm(X, Y, elision=op.split("/")[1], session=session)


def _executor_runs(prob, X, Y):
    """(name, run(overlap, coll)) for every d15/d25 executor and cell."""
    import torch
    from repro_torch.core import d15, d25
    g, alg = prob.grid, prob.alg
    Xd, Yd = (torch.from_numpy(a).to(g.device) for a in (X, Y))
    plan, plant = prob.plan("normal"), prob.plan("transpose")
    planb = prob.transposed().plan("transpose")
    if alg.name == "d15":
        A, B = g.stack(Xd), g.stack(Yd)
        return [
            ("sddmm", lambda **k: d15.sddmm_d15(g, plan, A, B, **k)),
            ("spmma", lambda **k: d15.spmma_d15(g, plan, B, **k)),
            ("spmmb", lambda **k: d15.spmmb_d15(g, planb, A, **k))] + [
            (el, lambda el=el, pl=pl, a=a, b=b, **k: d15.fusedmm_d15(
                g, pl, a, b, elision=el, **k))
            for el, pl, a, b in (("none", plan, A, B), ("reuse", plant, B, A),
                                 ("fused", plan, A, B))]
    assert alg.name == "d25"
    A, B = alg.shard_x(prob, Xd), d25.skew_b(g, Yd)
    Ay, Bx = alg.shard_x(prob, Yd), d25.skew_b(g, Xd)
    return [
        ("sddmm", lambda **k: d25.sddmm_d25(g, plan, A, B, **k)),
        ("spmm", lambda **k: d25.spmma_d25(g, plan, B, **k)),
        ("spmm_t", lambda **k: d25.spmmb_d25(g, planb, A, **k))] + [
        (el, lambda el=el, pl=pl, a=a, b=b, **k: d25.fusedmm_d25(
            g, pl, a, b, elision=el, **k))
        for el, pl, a, b in (("none", plan, A, B), ("reuse", plant, Ay, Bx),
                             ("fused", plan, A, B))]


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

def _worker(rank, world, init, out_dir, device):
    """One rank: every case of its world over the process group; saves
    its blocks, the gathered results and its collective logs."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.core import api
    from repro_torch.core.collectives import Dist
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank)
    made = []       # every subgroup the port makes, to count them
    new_group = dist.new_group
    dist.new_group = lambda *a, **k: made.append(a) or new_group(*a, **k)
    devices = [torch.device(device, i) if device == "cuda"
               else torch.device("cpu") for i in range(world)]
    res, words = {}, {}

    def np_(t):
        return t.detach().cpu().numpy()

    try:
        for w, family, c in CASES:
            if w != world:
                continue
            prob, X, Y = _problem(family, c, devices=devices,
                                  group=dist.group.WORLD)
            assert (prob.p, prob.c) == (world, c)
            tag = f"{family}/{c}"
            for op in _ops(family):
                dense, sparse_r = _run_op(prob, op, X, Y)
                words[f"{tag}/{op}"] = prob.last_collectives.words()
                leaves = ([dense.local] if dense is not None else []) + (
                    _leaves(sparse_r.raw) if sparse_r is not None else [])
                for i, t in enumerate(leaves):
                    res[f"{tag}/{op}/leaf/{i}"] = np_(t)
                if dense is not None:
                    res[f"{tag}/{op}/gathered"] = np_(dense.gather())
                if sparse_r is not None:
                    res[f"{tag}/{op}/values"] = sparse_r.values()
            # Session-cached calls (the second hits) against uncached ones
            sess = api.Session()
            for el in CELLS[family]:
                for _ in range(2):
                    out, Rr = prob.fusedmm(X, Y, el, session=sess)
                res[f"{tag}/session/{el}/out"] = np_(out.local)
                for i, t in enumerate(_leaves(Rr.raw)):
                    res[f"{tag}/session/{el}/R/{i}"] = np_(t)
            words[f"{tag}/session"] = sess.stats()
            if family in ("d15", "d25"):
                for name, run in _executor_runs(prob, X, Y):
                    for ov in (True, False):
                        coll = Dist(prob.grid)
                        for i, t in enumerate(_leaves(
                                run(overlap=ov, coll=coll))):
                            res[f"{tag}/exec/{name}/{ov}/{i}"] = np_(t)
                        words[f"{tag}/exec/{name}/{ov}"] = coll.words()
            # a whole plan carried across keeps this rank's share only
            whole, _, _ = _problem(family, c,
                                   devices=[torch.device("cpu")] * world)
            conv = getattr(convert, f"plan_{family}_from_numpy")(
                whole.plan("normal"), prob.grid)
            own = prob.plan("normal")
            words[f"{tag}/convert"] = [
                bool(torch.equal(a.cpu(), b.cpu()))
                for f in ("rows_local", "cols", "vals", "tile_base")
                for a, b in zip(_leaves(getattr(conv, f)),
                                _leaves(getattr(own, f)))] + [
                conv.tiling == own.tiling]
        auto = api.make_problem(*_problem_data(), devices=devices,
                                group=dist.group.WORLD, **TILE)
        words["auto"] = [auto.alg.name, auto.c, auto.resolve_elision()]
        words["new_groups"] = len(made)
        # no fallback: a process group of the other kind is refused
        other = [torch.device("cpu" if device == "cuda" else "meta")] * world
        try:
            api.make_problem(*_problem_data(), devices=other,
                             group=dist.group.WORLD, **TILE)
            words["refused"] = None
        except ValueError as e:
            words["refused"] = str(e)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(words, f)


def _problem_data():
    from repro_torch.core import sparse
    rows, cols, vals, _, _ = sparse.random_problem(M, N, R, NNZ_ROW,
                                                   seed=SEED)
    return rows, cols, vals, (M, N), R


def _spawn(world, out_dir, device="cpu"):
    """Run ``world`` ranks to their end (``_torch_spawn.spawn``); returns
    each rank's saved arrays and logs."""
    return spawn(__file__, world, out_dir, device)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every world's ranks, spawned once for the module (the worlds run
    side by side)."""
    import concurrent.futures
    base = tmp_path_factory.mktemp("dist")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {w: ex.submit(_spawn, w, str(base / f"world{w}"))
                for w in WORLDS}
        return {w: f.result() for w, f in futs.items()}


_STACKED = {}


def _stacked(family, c, p):
    """The stacked problem of a case (cached across tests)."""
    import torch
    key = (family, c, p)
    if key not in _STACKED:
        _STACKED[key] = _problem(family, c,
                                 devices=[torch.device("cpu")] * p)
    return _STACKED[key]


def _coords(rank, grid):
    return tuple(int(i) for i in np.unravel_index(rank, grid.shape))


def _model(prob, op):
    el = op.split("/")[1] if "/" in op else "none"
    return [(k, float(w)) for (_, _, k, w) in prob.schedule_words(
        op.split("/")[0], el) if k and w]


def _nonzero(words):
    return [(k, float(w)) for k, w in words if w]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

OP_CASES = [(w, f, c, op) for w, f, c in CASES for op in _ops(f)]


@pytest.mark.parametrize("world,family,c,op", OP_CASES)
def test_rank_blocks_equal_stacked_bitwise(ranks, world, family, c, op):
    """Each rank's blocks == the stacked run's blocks of that rank, the
    gathered results == the stacked results, bit for bit; each rank's
    log == the stacked log == schedule_words."""
    from repro_torch.core.collectives import Stacked
    prob, X, Y = _stacked(family, c, world)
    fn, args, kwargs, post = _call(prob, op, X, Y)
    coll = Stacked(prob.grid)
    res = fn(*args, **kwargs, coll=coll)
    want = [t.contiguous().numpy() for t in _leaves(res)]
    dense, sparse_r = post(res) if op.startswith("fusedmm") else (
        (None, post(res)) if op == "sddmm" else (post(res), None))
    tag = f"{family}/{c}/{op}"
    for rank, (got, words) in enumerate(ranks[world]):
        at = _coords(rank, prob.grid)
        for i, w in enumerate(want):
            g = got[f"{tag}/leaf/{i}"]
            assert g.shape == (1,) * prob.grid.ndim + w.shape[prob.grid.ndim:]
            np.testing.assert_array_equal(
                g[(0,) * prob.grid.ndim], w[at],
                err_msg=f"{tag} rank {rank} leaf {i}")
        if dense is not None:
            np.testing.assert_array_equal(got[f"{tag}/gathered"],
                                          dense.numpy())
        if sparse_r is not None:
            np.testing.assert_array_equal(got[f"{tag}/values"],
                                          sparse_r.values())
        assert [tuple(e) for e in words[tag]] == coll.words(), rank
        assert _nonzero(words[tag]) == _model(prob, op), rank
    assert len(want) == len([k for k in ranks[world][0][0]
                             if k.startswith(f"{tag}/leaf/")])


@pytest.mark.parametrize("world,family,c",
                         [k for k in CASES if k[1] in ("d15", "d25")])
def test_overlap_equals_serial_bitwise(ranks, world, family, c):
    """The d15 and d25 executors with overlap on and off give each rank
    the same bits and the same log, the stacked run's."""
    prob, X, Y = _stacked(family, c, world)
    tag = f"{family}/{c}/exec"
    for name, run in _executor_runs(prob, X, Y):
        want = [t.contiguous().numpy() for t in _leaves(run(overlap=False))]
        for rank, (got, words) in enumerate(ranks[world]):
            at = _coords(rank, prob.grid)
            for i, w in enumerate(want):
                serial = got[f"{tag}/{name}/False/{i}"]
                np.testing.assert_array_equal(
                    got[f"{tag}/{name}/True/{i}"], serial,
                    err_msg=f"{name} rank {rank}")
                np.testing.assert_array_equal(
                    serial[(0,) * prob.grid.ndim], w[at],
                    err_msg=f"{name} rank {rank} vs stacked")
            assert words[f"{tag}/{name}/True"] == \
                words[f"{tag}/{name}/False"], name


@pytest.mark.parametrize("world,family,c", CASES)
def test_session_cached_equals_uncached(ranks, world, family, c):
    """Every cell's Session-cached call (on a cache hit) gives each rank
    the bits of the uncached call."""
    tag = f"{family}/{c}"
    for got, words in ranks[world]:
        # s25 replicates nothing dense: its Session is never consulted
        assert (words[f"{tag}/session"]["hits"] > 0) == (family != "s25")
        for el in CELLS[family]:
            unc = f"{tag}/fusedmm/{el}/leaf/"
            n = sum(k.startswith(unc) for k in got)
            assert n > 1
            np.testing.assert_array_equal(got[f"{tag}/session/{el}/out"],
                                          got[unc + "0"])
            for i in range(1, n):
                np.testing.assert_array_equal(
                    got[f"{tag}/session/{el}/R/{i - 1}"], got[unc + str(i)])


@pytest.mark.parametrize("world,family,c", CASES)
def test_converted_plan_keeps_each_rank_share(ranks, world, family, c):
    """convert.plan_*_from_numpy on a process group's grid keeps each
    rank's share of a whole plan: the rank's own plan, array for array,
    with the same tiling."""
    for _, words in ranks[world]:
        same = words[f"{family}/{c}/convert"]
        assert len(same) > 4 and all(same), same


@pytest.mark.parametrize("world", WORLDS)
def test_auto_chooses_what_the_reference_chooses(ranks, world):
    """"auto" over a process group ranks the families at the group's p:
    the reference's cost model's choice, and the stacked choice."""
    import torch
    from repro.core import costmodel as ref_costmodel
    from repro_torch.core import api
    rows, cols, vals, shape, r = _problem_data()
    want = ref_costmodel.choose_algorithm(m=M, n=N, nnz=len(vals), r=R,
                                          p=world)
    stacked = api.make_problem(rows, cols, vals, shape, r, **TILE,
                               devices=[torch.device("cpu")] * world)
    for _, words in ranks[world]:
        fam, c, el = words["auto"]
        assert (fam, c) == (want.family, want.c)
        assert (fam, c, el) == (stacked.alg.name, stacked.c,
                                stacked.resolve_elision())


@pytest.mark.parametrize("world", WORLDS)
def test_fiber_subgroups_made_once_per_layout(ranks, world):
    """Every problem of a world builds its grids (and transposed twins)
    on one process group: each fiber's subgroup is made once per grid
    layout, p/c of them, and reused by every later grid of that layout."""
    layouts = {(world // c, c) if f in ("d15", "s15")
               else (int(np.sqrt(world // c)),) * 2 + (c,)
               for w, f, c in CASES if w == world and c > 1}
    want = sum(int(np.prod(shape[:-1])) for shape in layouts)
    for _, words in ranks[world]:
        assert words["new_groups"] == want, (words["new_groups"], layouts)


@pytest.mark.parametrize("world", WORLDS)
def test_no_fallback_to_another_backend(ranks, world):
    for _, words in ranks[world]:
        assert words["refused"] and "no fallback" in words["refused"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """tests/test_torch_d15.py's reference (8 forced host devices), its
    subprocess run once a test session."""
    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_d15
    return test_torch_d15.shared_reference(tmp_path_factory)


@pytest.mark.parametrize("world,c", [(w, c) for w, f, c in CASES
                                     if f == "d15"])
def test_d15_fused_matches_reference(ranks, reference, world, c):
    """The gathered d15 "fused" output of every rank within
    tests/test_kernels.py's FusedMM tolerance of the reference's."""
    want = reference[f"{world}_{c}/fusedmm/fused"]
    for got, _ in ranks[world]:
        np.testing.assert_allclose(got[f"d15/{c}/fusedmm/fused/gathered"],
                                   want, rtol=2e-3, atol=2e-3)


@pytest.fixture
def cards():
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two or more NVIDIA GPUs for NCCL ({n} here)")
    return n


@pytest.mark.cuda
def test_nccl_rank_blocks_equal_stacked_bitwise(cards, tmp_path):
    """NCCL at world size = the cards' count: the d15 cells' rank blocks,
    gathered results and logs against the stacked run on card 0."""
    import torch
    from repro_torch.core.collectives import Stacked
    if cards not in WORLDS:
        pytest.skip(f"no case has world size {cards}")
    got = _spawn(cards, str(tmp_path), device="cuda")
    for w, family, c in CASES:
        if w != cards:
            continue
        prob, X, Y = _problem(family, c,
                              devices=[torch.device("cuda", 0)] * cards)
        for op in _ops(family):
            fn, args, kwargs, post = _call(prob, op, X, Y)
            coll = Stacked(prob.grid)
            want = [t.contiguous().cpu().numpy()
                    for t in _leaves(fn(*args, **kwargs, coll=coll))]
            tag = f"{family}/{c}/{op}"
            for rank, (res, words) in enumerate(got):
                at = _coords(rank, prob.grid)
                for i, wl in enumerate(want):
                    np.testing.assert_array_equal(
                        res[f"{tag}/leaf/{i}"][(0,) * prob.grid.ndim],
                        wl[at], err_msg=f"{tag} rank {rank}")
                assert [tuple(e) for e in words[tag]] == coll.words()


# ---------------------------------------------------------------------------
# the kernels' tiling check, once per pack
# ---------------------------------------------------------------------------

def test_planned_launches_read_nothing_back(monkeypatch):
    """Plans with blocks_per_step > 1 launch with no window check read
    back from the device: the planner proved it on the host."""
    import torch
    from repro_torch.core import api, sparse
    from repro_torch.kernels import ops
    calls = []
    real = ops._groups_share_window
    monkeypatch.setattr(ops, "_groups_share_window",
                        lambda S, g: calls.append(g) or real(S, g))
    # 4 distinct columns in every row: every window of 32 rows holds 4
    # blocks of 32 in the row-block packs, so s15's plan groups them
    m, k, r = 512, 4, 32
    rows = np.repeat(np.arange(m), k).astype(np.int32)
    cols = ((rows * 7 + np.tile(np.arange(k), m) * 131) % m).astype(np.int32)
    rng = np.random.default_rng(4)
    vals = rng.standard_normal(m * k).astype(np.float32)
    X, Y = (rng.standard_normal((m, r)).astype(np.float32) for _ in "XY")
    del sparse
    bps = {}
    for family in ("d15", "s15", "d25", "s25"):
        prob = api.make_problem(rows, cols, vals, (m, m), r,
                                algorithm=family, c=1, row_tile=32,
                                nz_block=32,
                                devices=[torch.device("cpu")] * 4)
        prob.fusedmm(X, Y)
        bps[family] = prob.plan("normal").tiling.blocks_per_step
    assert bps["s15"] > 1 and max(bps.values()) > 1, bps
    assert calls == []


def test_infeasible_blocks_per_step_still_refused(monkeypatch):
    import torch
    from repro_torch.core import sparse
    from repro_torch.kernels import ops
    import dataclasses
    # one block in the first window, three in the second: aligned pairs
    # straddle the windows
    rows = np.array([0, 40, 41, 42, 43, 44], np.int32)
    cols = np.arange(6, dtype=np.int32)
    vals = np.arange(1, 7, dtype=np.float32)
    S = sparse.pack_row_tiled(rows, cols, vals, (64, 8), row_tile=32,
                              nz_block=2, device="cpu")
    assert S.nblocks == 4
    B = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    for pack in (S, S.with_vals(S.vals),
                 dataclasses.replace(S, window_groups=3)):
        with pytest.raises(ValueError, match="infeasible"):
            ops.spmm(pack, B, blocks_per_step=2)
    # a pack packed for groups of 2, with the proof, is not checked again
    G = sparse.pack_row_tiled(rows, cols, vals, (64, 8), row_tile=32,
                              nz_block=2, group=2, device="cpu")
    want = ops.spmm(G, B, blocks_per_step=2)
    monkeypatch.setattr(ops, "_groups_share_window",
                        lambda S, g: pytest.fail("checked again"))
    got = ops.spmm(dataclasses.replace(G, window_groups=2), B,
                   blocks_per_step=2)
    assert torch.equal(got, want)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5], sys.argv[6])
