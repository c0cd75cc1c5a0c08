"""The LM train step data-parallel over gloo ranks against one process.

This file run as a script is the worker (tests/_torch_spawn.py spawns 2
and 4 ranks; each rank's mesh is ``make_local_mesh(device="cpu")``, one
``data`` row of the world).  Each rank takes its rows of one global
batch and runs STEPS train steps of two reduced configs from the same
seeded weights: llama3.2-1b, and DeepSeek-V2-Lite with
``capacity_factor=1.0`` so that expert queues overflow and assignments
drop (the capacity and each token's queue position are the global
batch's, and so is the load-balancing loss).  Held to the same steps in
one process on the whole batch (no mesh): every step's metrics within
DP_TOL, and the gradients the optimizer is given (the ranks' shares
summed in rank order) within DP_TOL of each leaf's largest magnitude;
every rank's parameters and gradients equal bit for bit.  (The
parameters themselves are not held to the one-process run: AdamW's
first steps move a parameter by about lr * sign(g), so a gradient within
float noise of 0 may move it by up to 2 lr either way.)  World 4 also
resumes on ``remesh(2, 1)`` from the checkpoint (``step == 6``, the
losses those of 6 steps in one process, the two retired ranks raising
``api.RankRetired``), runs the train step on a ``model = 2`` mesh,
and world 2 runs the driver (``launch.train.main``) over both ranks.
The single-process DeepSeek run with ``capacity_factor=1.0`` drops
assignments, and its ``lm_loss`` is the reference's with the same
override.
"""
import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import _torch_spawn  # noqa: E402

STEPS = 2
SEQ, GLOBAL_BATCH = 32, 8
DP_TOL = 1e-5
CONFIGS = {"llama": ("llama32_1b", None),
           "moe": ("deepseek_v2_lite_16b", 1.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its ops are small, and beside
    the other test workers' default thread pools (one per core each)
    they crawl."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, key):
    import importlib
    mod, cf = CONFIGS[key]
    cfg = importlib.import_module(f"{pkg}.configs.{mod}").reduced()
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def _setup(key):
    import torch
    from repro_torch import config
    from repro_torch.models import model as M
    from repro_torch.training import data, optimizer as opt
    cfg = _cfg("repro_torch", key)
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    tcfg = config.TrainConfig(seq_len=SEQ, global_batch=GLOBAL_BATCH,
                              lr=1e-3, steps=10, warmup=2)
    pipe = data.SyntheticLM(cfg.vocab, SEQ, GLOBAL_BATCH, seed=1)
    return cfg, model, opt.init_opt_state(model), tcfg, pipe


PCFG_KW = dict(compute_dtype="float32")


@contextlib.contextmanager
def _grads_seen(out):
    """Record the gradients ``adamw_update`` is given, step by step."""
    from repro_torch.training import optimizer as opt
    orig = opt.adamw_update

    def spy(cfg, params, grads, state, **kw):
        out.append({k: v.detach().clone() for k, v in grads.items()})
        return orig(cfg, params, grads, state, **kw)
    opt.adamw_update = spy
    try:
        yield out
    finally:
        opt.adamw_update = orig


def run_steps(key, mesh, steps=range(STEPS), state=None):
    """(model, opt_state, metrics per step, gradients per step)."""
    import torch
    from repro_torch import config
    from repro_torch.training import train_step as ts
    cfg, model, opt_state, tcfg, pipe = state or _setup(key)
    step, _, _ = ts.make_train_step(cfg, config.ParallelConfig(**PCFG_KW),
                                    tcfg, mesh)
    lo, hi = ts.data_rows(mesh, GLOBAL_BATCH)
    mets, grads = [], []
    with _grads_seen(grads):
        for i in steps:
            b = {k: torch.as_tensor(v)
                 for k, v in pipe.batch(i, lo, hi).items()}
            m = step(model, opt_state, b)
            mets.append({k: float(v) for k, v in m.items()})
    return model, opt_state, mets, grads


def _flat(model, grads):
    out = {f"param/{n}": p.detach().numpy()
           for n, p in model.named_parameters()}
    for i, g in enumerate(grads):
        out.update({f"grad{i}/{n}": v.numpy() for n, v in g.items()})
    return out


def worker(rank, world, init, out_dir):
    import torch
    from repro_torch import config
    from repro_torch.core.api import RankRetired
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.elastic import remesh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    _torch_spawn.join(rank, world, init)
    mesh = lmesh.make_local_mesh(device="cpu")
    assert mesh.axis_sizes == {"data": world, "model": 1}
    assert mesh.coords == (rank, 0)
    arrays, record = {}, {"rank": rank}
    for key in CONFIGS:
        model, state, mets, grads = run_steps(key, mesh)
        arrays.update({f"{key}/{k}": v
                       for k, v in _flat(model, grads).items()})
        record[key] = mets
    if world == 4:
        # the checkpoint of the llama run, then resume on 2 ranks
        cfg, model, state, tcfg, pipe = _setup("llama")
        run_steps("llama", mesh, range(3), (cfg, model, state, tcfg, pipe))
        ck = os.path.join(out_dir, "ck")
        if rank == 0:
            ckpt.save(ck, 3, ltrain.train_tree(model, state))
        torch.distributed.barrier()
        try:
            mesh2 = remesh(2, 1, device="cpu")
        except RankRetired as e:
            record["retired"] = [e.rank, e.p]
        else:
            cfg, model2, state2, tcfg, pipe = _setup("llama")
            ltrain.load_tree(model2, state2, ckpt.restore(
                ck, 3, ltrain.train_tree(model2, state2)))
            record["remesh_rows"] = list(ts.data_rows(mesh2, GLOBAL_BATCH))
            _, state2, mets, _ = run_steps(
                "llama", mesh2, range(3, 6),
                (cfg, model2, state2, tcfg, pipe))
            record["remesh"] = mets
            record["remesh_step"] = int(state2["step"])
            arrays.update({f"remesh/param/{n}": p.detach().numpy()
                           for n, p in model2.named_parameters()})
        torch.distributed.barrier()
        # a model axis of 2: the mesh and its groups, then the llama
        # steps on each rank's shards
        tp = lmesh.make_local_mesh(model=2, device="cpu")
        record["tp_mesh"] = [tp.axis_sizes["data"], tp.axis_sizes["model"],
                             torch.distributed.get_world_size(tp.data_group),
                             torch.distributed.get_world_size(
                                 tp.model_group)]
        cfg, model, state, tcfg, pipe = _setup("llama")
        tensor_parallel.shard_model(cfg, config.ParallelConfig(**PCFG_KW),
                                    model, tp)
        _, _, mets, _ = run_steps("llama", tp, state=(
            cfg, model, opt.init_opt_state(model), tcfg, pipe))
        record["tp_steps"] = mets
        grid = lmesh.sparse_grid_from_production(mesh, 2)
        record["sparse_grid"] = list(grid.shape)
    else:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ltrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--seq", str(SEQ), "--batch",
                              str(GLOBAL_BATCH), "--log-every", "1",
                              "--ckpt-dir", os.path.join(out_dir, "drv")])
        record["driver"] = [rc, buf.getvalue().splitlines()]
    _torch_spawn.save(out_dir, rank, arrays, record)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single():
    """key -> (params, metrics, grads) of the one-process run."""
    out = {}
    for key in CONFIGS:
        model, _, mets, grads = run_steps(key, None)
        out[key] = (_flat(model, grads), mets)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            out = str(tmp_path_factory.mktemp(f"train_dist{world}"))
            cache[world] = _torch_spawn.spawn(__file__, world, out)
        return cache[world]
    return get


def _close_leaves(got, want, prefix, tol):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for k in keys:
        w = want[k]
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * scale, (k, err, scale)


def _close_metrics(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            assert g[k] == pytest.approx(w[k], rel=tol, abs=tol), (k, g, w)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_data_parallel_matches_single_process(world, key, worlds, single):
    want, want_mets = single[key]
    arrays, record = worlds(world)[0]
    got = {k[len(key) + 1:]: v for k, v in arrays.items()
           if k.startswith(key + "/")}
    _close_metrics(record[key], want_mets, DP_TOL)
    for i in range(STEPS):
        _close_leaves(got, want, f"grad{i}/", DP_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_equal_bit_for_bit(world, worlds):
    ranks = worlds(world)
    a0, r0 = ranks[0]
    for arrays, record in ranks[1:]:
        for key in CONFIGS:
            assert record[key] == r0[key]
        shared = [k for k in a0 if not k.startswith("remesh/")]
        for k in shared:
            np.testing.assert_array_equal(arrays[k], a0[k], err_msg=k)


def test_remesh_4_to_2_through_checkpoint(worlds, single):
    ranks = worlds(4)
    _, _, mets6, _ = run_steps("llama", None, range(6))
    for r, (arrays, record) in enumerate(ranks):
        if r < 2:
            assert "retired" not in record
            assert record["remesh_step"] == 6
            assert record["remesh_rows"] == [r * 4, r * 4 + 4]
            _close_metrics(record["remesh"], mets6[3:], DP_TOL)
        else:
            assert record["retired"] == [r, 2]
    a0, a1 = ranks[0][0], ranks[1][0]
    for k in a0:
        if k.startswith("remesh/"):
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)


def test_model_axis_refused_and_meshes(worlds, single):
    """A (2, 2) mesh's groups; the train step runs on it (tensor
    parallel over the model axis) and its first step's metrics match the
    one-process run (tests/test_torch_tp.py holds the rest)."""
    for _, record in worlds(4):
        assert record["tp_mesh"] == [2, 2, 2, 2]
        _close_metrics(record["tp_steps"][:1], single["llama"][1][:1],
                       DP_TOL)
        assert record["sparse_grid"] == [2, 2]


def test_driver_over_two_ranks(worlds):
    lines = []
    for _, record in worlds(2):
        rc, out = record["driver"]
        assert rc == 0 and out[-1] == "TRAINING DONE"
        lines.append([json.loads(ln) for ln in out[:-1]])
    assert [r["step"] for r in lines[0]] == [0, 1]
    for a, b in zip(lines[0], lines[1]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]


def test_moe_capacity_one_matches_reference_and_drops(monkeypatch):
    """The one-process DeepSeek run with capacity_factor=1.0 drops
    assignments, and its lm_loss is the reference's (with the same
    override) within 1e-5 (tests/test_torch_moe_grad.py holds the SpMM
    dispatch's gradients with drops to the reference's)."""
    import jax
    import torch
    from repro import config as jconfig
    from repro.models import model as JM
    from repro.training import train_step as jts
    from repro_torch import config, convert
    from repro_torch.models import moe
    from repro_torch.training import train_step as ts
    cfg, jcfg = _cfg("repro_torch", "moe"), _cfg("repro", "moe")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    b = _setup("moe")[4].batch(0)
    keeps = []
    route = moe.route

    def spy(cfg_, p, xf, group=None):
        out = route(cfg_, p, xf, group)
        keeps.append(out[4])
        return out
    monkeypatch.setattr(moe, "route", spy)
    with torch.no_grad():
        loss, _ = ts.lm_loss(cfg, config.ParallelConfig(**PCFG_KW), model,
                             {k: torch.as_tensor(v) for k, v in b.items()})
    assert not all(bool(k.all()) for k in keeps)
    jb = {k: jax.numpy.asarray(v) for k, v in b.items()}

    def f(p):
        return jts.lm_loss(jcfg, jconfig.ParallelConfig(**PCFG_KW), p, jb)[0]
    # compiled without LLVM's backend optimizations: the same program,
    # a third less compile time
    jloss = jax.jit(f).lower(params).compile(
        {"xla_backend_optimization_level": 0})(params)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


if __name__ == "__main__":
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
