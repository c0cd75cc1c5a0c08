"""Re-planning onto a degraded grid, after
tests/dist_scripts/check_remesh.py and check_faults.py's guarantee 3.

On 8 stacked CPU ranks: api.degrade(lost_rank=7) picks the reference's
p, family and c (the reference runs once in a subprocess with 8 forced
host devices, this file run as a script), the 8 -> 4 re-plan gives every
op bit for bit (integer data: every accumulation is exact) and equal to
the reference's results, meta_dict round-trips onto the degraded grid,
p = 7 and a bad lost_rank are refused; a DeviceLost mid-training ends
bit for bit where a checkpoint-resume on the degraded grid does.  On 4
gloo ranks (this file run as a script, tests/_torch_spawn.py): a
DeviceLost at rank 3 makes every process take part in the degraded
group, the survivors equal the stacked run of the new p bit for bit, and
the others leave with api.RankRetired; no rank hangs.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.apps import als
from repro_torch.core import api, sparse
from repro_torch.distributed import faults
from repro_torch.training import checkpoint

sys.path.insert(0, os.path.dirname(__file__))
import _torch_spawn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
M = N = 64
R = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its ops are small, and beside
    the other test workers' default thread pools (one per core each)
    they crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    """check_remesh.py's integer data."""
    rng = np.random.default_rng(1)
    rows, cols, _ = sparse.erdos_renyi(M, N, 4, seed=1)
    vals = rng.integers(1, 5, rows.shape[0]).astype(np.float32)
    X = rng.integers(-3, 4, (M, R)).astype(np.float32)
    Y = rng.integers(-3, 4, (N, R)).astype(np.float32)
    return rows, cols, vals, X, Y


def _ops(prob, X, Y):
    """check_remesh.py's four results, as numpy."""
    def np_(t):
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return dict(sddmm=np_(prob.sddmm(X, Y).values()), spmm=np_(prob.spmm(Y)),
                spmm_t=np_(prob.spmm_t(np.ones((M, R), np.float32))),
                fusedmm=np_(prob.fusedmm(X, Y)[0]))


def _reference():
    """The reference's side of check_remesh.py on 8 host devices."""
    import jax
    from repro.core import api as japi
    assert len(jax.devices()) == 8
    rows, cols, vals, X, Y = _data()
    prob8 = japi.make_problem(rows, cols, vals, (M, N), R, algorithm="auto")
    base = {k: v.tolist() for k, v in _ops(prob8, X, Y).items()}
    prob4 = japi.degrade(prob8, lost_rank=7)
    out = {"p8": prob8.meta_dict(), "degraded": prob4.meta_dict(),
           "base": base}
    try:
        prob8.replan(devices=jax.devices()[:7])
    except ValueError as e:
        out["p7_error"] = str(e)
    try:
        japi.degrade(prob8, lost_rank=99)
    except ValueError as e:
        out["bad_rank_error"] = str(e)
    return out


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "reference"],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def prob8():
    rows, cols, vals, X, Y = _data()
    prob = api.make_problem(rows, cols, vals, (M, N), R, algorithm="auto",
                            devices=[CPU] * 8)
    return prob, X, Y, _ops(prob, X, Y)


def test_baseline_and_meta_equal_the_references(reference, prob8):
    prob, X, Y, base = prob8
    assert prob.p == 8
    assert prob.meta_dict() == reference["p8"]
    for k, v in base.items():
        assert np.array_equal(v, np.asarray(reference["base"][k],
                                            np.float32)), k


@pytest.mark.parametrize("how", ["replan", "degrade"])
def test_remesh_8_to_4_bitwise(reference, prob8, how):
    prob, X, Y, base = prob8
    prob4 = prob.replan(devices=[CPU] * 4) if how == "replan" \
        else api.degrade(prob, lost_rank=7)
    assert prob4.p == 4
    if how == "degrade":
        assert prob4.meta_dict() == reference["degraded"]
    for k, v in _ops(prob4, X, Y).items():
        assert np.array_equal(v, base[k]), f"{how}: {k} parity"


def test_degrade_releases_the_old_problem(prob8):
    prob, X, Y, base = prob8
    prob.plan("normal")
    prob.transposed()
    api.degrade(prob, lost_rank=7)
    assert not prob._plans and not prob._posmaps
    assert prob._transposed is None and prob._vals_dev is None
    # still usable: rebuilt lazily
    assert np.array_equal(prob.sddmm(X, Y).values(), base["sddmm"])


def test_meta_round_trip_onto_the_degraded_grid(prob8):
    prob, X, Y, base = prob8
    meta = api.degrade(prob, lost_rank=7).meta_dict()
    re = api.problem_from_meta(meta, prob.rows, prob.cols, prob.vals,
                               devices=[CPU] * 4)
    assert (re.alg.name, re.p, re.c) == (meta["family"], 4, meta["c"])
    assert np.array_equal(re.sddmm(X, Y).values(), base["sddmm"])


def test_p7_and_a_bad_lost_rank_are_refused(reference, prob8):
    prob = prob8[0]
    with pytest.raises(ValueError) as ei:
        prob.replan(devices=[CPU] * 7)
    assert "7" in str(ei.value) and "p7_error" in reference
    with pytest.raises(ValueError, match="lost_rank 99"):
        api.degrade(prob, lost_rank=99)
    assert "bad_rank_error" in reference


def test_device_lost_training_equals_checkpoint_resume(tmp_path):
    """check_faults.py's guarantee 3: 8 ranks lose rank 7 at the step-3
    SDDMM, the trainer degrades mid-run and finishes bit for bit where a
    fault-free run checkpointed at step 3 and resumed on the degraded
    grid finishes."""
    common = dict(m=M, n=N, nnz_per_row=4, r=8, lr=0.05, seed=3, reg=0.0,
                  verbose=False)
    dir_a, dir_b, dir_c = (str(tmp_path / d) for d in "ABC")
    als.train_embedding_distributed(steps=3, ckpt_dir=dir_a, ckpt_every=3,
                                    devices=[CPU] * 8, **common)
    shutil.copytree(dir_a, dir_b)
    X_ref, Y_ref, h_ref = als.train_embedding_distributed(
        steps=6, ckpt_dir=dir_b, ckpt_every=3, devices=[CPU] * 4, **common)
    plan = faults.FaultPlan.scripted(faults.FaultSpec(
        op="sddmm", point="*", rank=7, phase=-1, round=3,
        kind="device_lost"))
    with faults.inject(plan) as ctl:
        X_rec, Y_rec, h_rec = als.train_embedding_distributed(
            steps=6, ckpt_dir=dir_c, ckpt_every=3, devices=[CPU] * 8,
            **common)
    assert len(ctl.fired) == 1 and ctl.fired[0]["rank"] == 7
    assert torch.equal(X_rec, X_ref) and torch.equal(Y_rec, Y_ref)
    assert h_rec[3:] == h_ref
    meta = checkpoint.load_manifest(dir_c, 6)["meta"]
    assert meta["p"] == 4 and meta == checkpoint.load_manifest(dir_b,
                                                               6)["meta"]


# --- one rank per process: the degraded group ------------------------------

LOST = 3


def worker(rank, world, init, out_dir):
    """One gloo rank: a TransientFault retried on the group, then a
    DeviceLost at rank LOST through ElasticProblem (algorithm="auto"
    re-dispatch), then api.degrade onto an s25 grid whose fiber
    subgroup the processes outside it help make."""
    dist = _torch_spawn.join(rank, world, init)
    rows, cols, vals, X, Y = _data()
    prob = api.make_problem(rows, cols, vals, (M, N), R, algorithm="d15",
                            group=dist.group.WORLD, devices=[CPU] * world)
    base = prob.fusedmm(X, Y, elision="fused")[0].gather()
    arrays, record = {"base": base.numpy()}, {}
    plan = faults.FaultPlan.scripted(faults.FaultSpec(op="fusedmm",
                                                      rank=1))
    with faults.inject(plan):
        ep = api.ElasticProblem(prob)
        got = ep.fusedmm(X, Y, elision="fused")[0].gather()
    record["transient_bitwise"] = bool(torch.equal(got, base))
    plan = faults.FaultPlan.scripted(faults.FaultSpec(
        op="fusedmm", rank=LOST, kind="device_lost"))
    try:
        with faults.inject(plan):
            ep = api.ElasticProblem(prob)
            out = ep.fusedmm(X, Y, elision="fused")[0].gather()
        record.update(outcome="recovered", p=ep.problem.p,
                      family=ep.problem.alg.name, c=ep.problem.c)
        arrays["degraded"] = out.numpy()
    except api.RankRetired as e:
        record.update(outcome="retired", p=e.p, lost=e.lost_rank)
    try:
        s25 = api.degrade(prob, lost_rank=0, algorithm="s25")
        record.update(s25=[s25.p, s25.c])
        arrays["s25"] = s25.sddmm(X, Y).values()
    except api.RankRetired as e:
        record.update(s25="retired")
    dist.barrier()
    _torch_spawn.save(out_dir, rank, arrays, record)
    dist.destroy_process_group()


def test_device_lost_on_gloo_ranks(tmp_path):
    outs = _torch_spawn.spawn(__file__, 4, str(tmp_path / "w4"))
    rows, cols, vals, X, Y = _data()
    records = [rec for _, rec in outs]
    assert all(r["transient_bitwise"] for r in records)
    p_new = records[0]["p"]
    assert [r["outcome"] for r in records] == \
        ["recovered"] * p_new + ["retired"] * (4 - p_new)
    assert records[LOST]["outcome"] == "retired" and p_new == 2
    fam, c = records[0]["family"], records[0]["c"]
    stacked = api.make_problem(rows, cols, vals, (M, N), R, algorithm=fam,
                               c=c, devices=[CPU] * p_new)
    want = stacked.fusedmm(X, Y, elision="fused")[0].numpy()
    for arrays, rec in outs[:p_new]:
        assert np.array_equal(arrays["degraded"], want)
        assert np.array_equal(arrays["degraded"], arrays["base"])
    # s25 after losing rank 0: ranks 1, 2 hold the (1, 1, 2) grid, whose
    # fiber subgroup ranks 0 and 3 entered too
    assert [r["s25"] for r in records] == \
        ["retired", [2, 2], [2, 2], "retired"]
    s25 = api.make_problem(rows, cols, vals, (M, N), R, algorithm="s25",
                           c=2, devices=[CPU] * 2)
    want = s25.sddmm(X, Y).values()
    for arrays, _ in outs[1:3]:
        assert np.array_equal(arrays["s25"], want)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        print(json.dumps(_reference()))
