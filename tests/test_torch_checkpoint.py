"""The port's checkpoints (after repro.training.checkpoint) and the
trainers' resilient wiring (after tests/test_faults.py's trainer tests).

The on-disk layout is the reference's, so a checkpoint written by either
package restores in the other; the typed errors fire on the same
triggers.  The two distributed trainers time their steps, recover from
an injected fault, checkpoint with the problem's metadata and resume,
and their loss histories follow the reference's on the same inputs (one
rank, the reference's in this process), a resume from the reference's
own checkpoint included.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.apps import als as jals
from repro.apps import gat as jgat
from repro.core import api as japi
from repro.distributed import elastic as jelastic
from repro.distributed import faults as jfaults
from repro.training import checkpoint as jckpt
from repro_torch import convert
from repro_torch.apps import als, gat
from repro_torch.core import api, sparse
from repro_torch.distributed import elastic, faults
from repro_torch.training import checkpoint

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


def _tree(rng):
    """A nested tree of numpy leaves of several dtypes and shapes."""
    return {"params": {"W": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": np.arange(3, dtype=np.int32)},
            "opt": [rng.standard_normal(5), (np.float32(2.5),
                                             np.zeros((2, 2), np.float16))],
            "step": np.int64(7)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for _, x in checkpoint._flatten(tree)]


def test_layout_matches_the_references(tmp_path):
    tree = _tree(np.random.default_rng(0))
    mine = checkpoint.save(str(tmp_path / "a"), 3, _as_torch(tree),
                           meta={"family": "d15"})
    ref = jckpt.save(str(tmp_path / "b"), 3, tree, meta={"family": "d15"})
    assert os.path.basename(mine) == os.path.basename(ref) == "step_00000003"
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref)) == \
        ["_COMMITTED", "manifest.json", "shard_h000.npz"]
    with open(os.path.join(mine, "manifest.json")) as f:
        a = json.load(f)
    with open(os.path.join(ref, "manifest.json")) as f:
        b = json.load(f)
    assert a == b                          # paths, shapes, dtypes, meta
    with np.load(os.path.join(mine, "shard_h000.npz")) as za, \
            np.load(os.path.join(ref, "shard_h000.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            assert np.array_equal(za[k], zb[k])
    assert not [d for d in os.listdir(tmp_path / "a") if d.endswith(".tmp")]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restores_across_packages(tmp_path, writer):
    tree = _tree(np.random.default_rng(1))
    d = str(tmp_path)
    if writer == "port":
        checkpoint.save(d, 5, _as_torch(tree))
        got = jckpt.restore(d, 5, tree)
        assert all(np.array_equal(np.asarray(x), y) for x, y in
                   zip(jax.tree_util.tree_leaves(got), _leaves(tree)))
    else:
        jckpt.save(d, 5, tree)
        like = _as_torch(tree)
        got = checkpoint.restore(d, 5, like)
        for x, ref, want in zip(_leaves(got), _leaves(like), _leaves(tree)):
            assert x.dtype == ref.dtype and np.array_equal(x, want)
        assert isinstance(got["opt"][1], tuple)


def test_restore_takes_the_targets_dtype_and_structure(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"X": torch.ones(2, 3), "Y": [torch.zeros(4)]})
    got = checkpoint.restore(d, 1, {"X": torch.zeros(2, 3,
                                                     dtype=torch.float64),
                                    "Y": [np.zeros(4, np.float16)]})
    assert got["X"].dtype == torch.float64 and torch.equal(
        got["X"], torch.ones(2, 3, dtype=torch.float64))
    assert got["Y"][0].dtype == np.float16


def test_keep_k_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert checkpoint.latest_step(d + "/none") is None
    for s in range(1, 6):
        checkpoint.save(d, s, {"x": torch.full((2,), float(s))}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert checkpoint.latest_step(d) == 5
    # a crash mid-save: an uncommitted step is not the latest
    os.makedirs(os.path.join(d, "step_00000009"))
    os.makedirs(os.path.join(d, "step_00000010.tmp"))
    assert checkpoint.latest_step(d) == 5 == jckpt.latest_step(d)
    with pytest.raises(checkpoint.CheckpointMissing):
        checkpoint.load_manifest(d, 9)
    with pytest.raises(checkpoint.CheckpointMissing):
        checkpoint.restore(d, 3, {"x": torch.zeros(2)})


def _corrupt(d, how):
    path = os.path.join(d, "step_00000001")
    if how == "no manifest":
        os.remove(os.path.join(path, "manifest.json"))
    elif how == "bad json":
        with open(os.path.join(path, "manifest.json"), "w") as f:
            f.write("{not json")
    elif how == "no shard":
        os.remove(os.path.join(path, "shard_h000.npz"))
    elif how == "leaf count":
        np.savez(os.path.join(path, "shard_h000.npz"), leaf_0=np.zeros(2))
    elif how == "shape vs manifest":
        np.savez(os.path.join(path, "shard_h000.npz"), leaf_0=np.zeros(3),
                 leaf_1=np.zeros(4))


@pytest.mark.parametrize("how", ["no manifest", "bad json", "no shard",
                                 "leaf count", "shape vs manifest",
                                 "target shape", "target leaves"])
def test_typed_errors_on_the_references_triggers(tmp_path, how):
    tree = {"a": np.zeros(2, np.float32), "b": np.ones(4, np.float32)}
    like = {"a": np.zeros(2, np.float32), "b": np.ones(4, np.float32)}
    if how == "target shape":
        like["b"] = np.ones(5, np.float32)
    if how == "target leaves":
        like["c"] = np.ones(1, np.float32)
    for mod, sub in ((checkpoint, "port"), (jckpt, "ref")):
        d = str(tmp_path / sub)
        mod.save(d, 1, tree)
        _corrupt(d, how)
        with pytest.raises(mod.CheckpointError) as ei:
            mod.restore(d, 1, like)
        assert not isinstance(ei.value, mod.CheckpointMissing)


# --- the trainers -----------------------------------------------------------

EMBED = dict(m=32, n=32, nnz_per_row=3, r=4, verbose=False)


def test_trainer_monitor_checkpoint_and_fault(tmp_path):
    """train_embedding_distributed drives the whole stack on one rank:
    StepMonitor observes every step, checkpoints carry meta_dict, an
    injected transient fault is recovered, the run resumes from the
    committed step, and the history follows the reference's."""
    mon = elastic.StepMonitor()
    d = str(tmp_path / "ck")
    plan = faults.FaultPlan.scripted(faults.FaultSpec(op="sddmm", round=1))
    with faults.inject(plan) as ctl:
        X, Y, hist = als.train_embedding_distributed(
            steps=4, monitor=mon, ckpt_dir=d, ckpt_every=2, devices=[CPU],
            **EMBED)
    assert len(ctl.fired) == 1 and len(hist) == 4
    assert len(mon._times) >= 4          # every step (incl. retry) timed
    meta = checkpoint.load_manifest(d, 4)["meta"]
    assert meta["p"] == 1 and "coo_digest" in meta
    # resume: nothing left to do, factors restored bitwise
    X2, Y2, h2 = als.train_embedding_distributed(
        steps=4, ckpt_dir=d, devices=[CPU], **EMBED)
    assert h2 == [] and torch.equal(X, X2) and torch.equal(Y, Y2)
    # the reference, the same fault, the same history
    jmon = jelastic.StepMonitor()
    jd = str(tmp_path / "ref")
    plan = jfaults.FaultPlan.scripted(jfaults.FaultSpec(op="sddmm",
                                                        round=1))
    with jfaults.inject(plan):
        jX, _, jhist = jals.train_embedding_distributed(
            steps=4, monitor=jmon, ckpt_dir=jd, ckpt_every=2,
            devices=jax.devices()[:1], **EMBED)
    np.testing.assert_allclose(hist, jhist, rtol=1e-3)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-3,
                               atol=1e-5)
    assert jckpt.load_manifest(jd, 4)["meta"] == meta


def test_resumes_from_the_references_checkpoint(tmp_path):
    """The reference trains two steps and checkpoints; the port resumes
    from that checkpoint (its meta rebuilds the same family and c, its
    factors restore onto tensors) and finishes the history the
    reference's uninterrupted run takes."""
    d = str(tmp_path / "ck")
    jals.train_embedding_distributed(steps=2, ckpt_dir=d, ckpt_every=2,
                                     devices=jax.devices()[:1], **EMBED)
    _, _, jfull = jals.train_embedding_distributed(
        steps=5, devices=jax.devices()[:1], **EMBED)
    X, Y, hist = als.train_embedding_distributed(
        steps=5, ckpt_dir=d, ckpt_every=2, devices=[CPU], **EMBED)
    assert len(hist) == 3 and isinstance(X, torch.Tensor)
    np.testing.assert_allclose(hist, jfull[2:], rtol=1e-3)
    assert checkpoint.latest_step(d) == 4


def _gat_case():
    rng = np.random.default_rng(0)
    rows, cols, _ = sparse.erdos_renyi(32, 32, 3, seed=0)
    vals = rng.integers(1, 5, rows.shape[0]).astype(np.float32)
    rng = np.random.default_rng(2)
    H = rng.standard_normal((32, 6)).astype(np.float32)
    target = rng.standard_normal((32, 4)).astype(np.float32)
    return rows, cols, vals, H, target


def test_gat_trainer_checkpoint_and_fault(tmp_path, monkeypatch):
    """train_gat_distributed with a fault and checkpoints, from the
    reference's initial parameters: the history follows the
    reference's, and a resume restores the parameters bit for bit."""
    rows, cols, vals, H, target = _gat_case()
    p0 = jgat.init_gat_layer(jax.random.PRNGKey(0), 6, 4)
    monkeypatch.setattr(gat, "init_gat_layer", lambda gen, d_in, d_out,
                        device=None: convert.gat_params_from_numpy(
                            np.asarray(p0.W), np.asarray(p0.a1),
                            np.asarray(p0.a2), device=device))
    prob = api.make_problem(rows, cols, vals, (32, 32), 4, devices=[CPU])
    d = str(tmp_path / "ck")
    plan = faults.FaultPlan.scripted(faults.FaultSpec(op="spmm", round=0))
    mon = elastic.StepMonitor()
    with faults.inject(plan) as ctl:
        params, hist = gat.train_gat_distributed(
            prob, H, target, steps=4, ckpt_dir=d, ckpt_every=2,
            monitor=mon, verbose=False)
    assert len(ctl.fired) == 1 and len(hist) == 4 and len(mon._times) >= 4
    assert checkpoint.load_manifest(d, 4)["meta"]["family"] == \
        prob.alg.name
    params2, h2 = gat.train_gat_distributed(prob, H, target, steps=4,
                                            ckpt_dir=d, verbose=False)
    assert h2 == []
    for a, b in zip(params, params2):
        assert torch.equal(a, b)
    jprob = japi.make_problem(rows, cols, vals, (32, 32), 4,
                              devices=jax.devices()[:1])
    plan = jfaults.FaultPlan.scripted(jfaults.FaultSpec(op="spmm", round=0))
    with jfaults.inject(plan):
        _, jhist = jgat.train_gat_distributed(
            jprob, H, target, steps=4, ckpt_dir=str(tmp_path / "ref"),
            ckpt_every=2, verbose=False)
    np.testing.assert_allclose(hist, jhist, rtol=5e-4)
