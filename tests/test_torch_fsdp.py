"""FSDP over the data axis, the sharded init and per-block remat.

The port's ``sharding.fsdp_dims``, ``models.model.init_sharded``,
``distributed/fsdp.py`` and ``ParallelConfig.remat`` held to the
reference and to the port's runs without them:

* (a) the placement: ``fsdp_dims`` equals the reference's
  ``fsdp_extend_tree`` then ``sanitize_tree`` on the stacked leaves
  (``launch/dryrun.py``), scan entry dropped, for every registered
  full-size config on the meta device, at (data 4, model 1) and (2, 2);
* (b) the sharded init equals ``init_params``' leaves sliced to each
  rank's shards, bit for bit, for the reduced configs, under FSDP at
  (4, 1) and (2, 2) and without it at (1, 2) and (1, 4); the shards of
  every rank tile the whole leaf; when a leaf is drawn, every earlier
  draw's storage is freed or is all of a parameter's own;
* (c) remat equals no remat bit for bit (loss and every gradient leaf)
  in one process, and on the 4 gloo ranks below with and without FSDP;
  the remat step is held to ``jax.grad`` of the reference's ``lm_loss``
  under ``remat="full"``, the reference's weights carried across, within
  LOSS_TOL and GRAD_TOL (``tests/test_torch_training.py``'s);
* (d) this file run as a script is the worker: one world of 4 gloo
  ranks (tests/_torch_spawn.py) runs each mesh in turn, (4, 1) then
  (2, 2).  For two reduced configs the FSDP step (remat "full") against
  the step without FSDP from the same seed: step 0's loss equal bit for
  bit, each rank's gradient shard equal bit for bit to its slice of the
  ``ordered_sum`` of the run without FSDP, 3 steps' leaves within
  STEP_TOL; the whole-leaf checkpoint (``full_tree``) of both runs,
  ``remesh`` to (2, 1) resp. (1, 2) and 3 more steps on the restored
  shards, within STEP_TOL; DeepSeek's MoE layer with its leaves split
  under ``dispatch="spmm"`` against "einsum"; and ``launch.train.main
  --fsdp --remat full --smoke`` with a checkpoint and a resume against
  the driver without the flags.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import _torch_spawn  # noqa: E402
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

ARCH_MODULES = [
    "jamba_v01_52b", "stablelm_1_6b", "llama32_1b", "qwen3_1_7b",
    "qwen3_4b", "qwen2_vl_72b", "mamba2_1_3b", "deepseek_v2_lite_16b",
    "phi35_moe_42b", "hubert_xlarge",
]
#: the meshes, (data, model); the worker runs them in this order
SHAPES = {"4x1": (4, 1), "2x2": (2, 2)}
#: each mesh's remesh(n, model_parallel=m) after its checkpoint
REMESH = {"4x1": (2, 1), "2x2": (2, 2)}
TRAINED = ["llama32_1b", "deepseek_v2_lite_16b"]
SEQ, BATCH, STEPS, LR = 32, 8, 3, 1e-3
LOSS_TOL = 1e-5     # tests/test_torch_training.py's
GRAD_TOL = 1e-4     # of each leaf's largest magnitude, the same file's
STEP_TOL = 1e-5     # FSDP against no FSDP after 3 steps, absolute
MOE_TOL = 1e-3      # spmm against einsum, of each leaf's largest


def _cfg(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg}.configs.{name}").reduced()


def _pcfg(**kw):
    from repro_torch import config
    return config.ParallelConfig(compute_dtype="float32", **kw)


def _fake_mesh(data, model, coords):
    """A mesh's placement without process groups (an init cuts shards
    and makes no collective)."""
    import types
    import torch
    return types.SimpleNamespace(
        axis_names=("data", "model"),
        axis_sizes={"data": data, "model": model}, coords=coords,
        ranks=np.arange(data * model).reshape(data, model),
        device=torch.device("cpu"), group=None, data_group=None,
        model_group=None)


def _batch(cfg, step, lo, hi):
    import torch
    from repro_torch.training import data
    b = data.SyntheticLM(cfg.vocab, SEQ, BATCH, seed=1).batch(step, lo, hi)
    if not cfg.embed_inputs:
        eb = data.embeds_batch(step, BATCH, SEQ, cfg.d_model,
                               pos3=(cfg.pos_dims == 3))
        b = dict({k: v[lo:hi] for k, v in eb.items()}, labels=b["labels"])
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def fresh(name, mesh, fsdp, pcfg):
    """(model, optimizer state) of the reduced config from seed 0,
    sharded for ``mesh`` (the sharded init under ``fsdp``)."""
    import torch
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    cfg = _cfg("repro_torch", name)
    g = torch.Generator().manual_seed(0)
    if fsdp:
        model = M.init_sharded(cfg, pcfg, g, mesh, device="cpu")
    else:
        model = tpm.shard_model(cfg, pcfg, M.init_params(cfg, g,
                                                         device="cpu"), mesh)
    return model, opt.init_opt_state(model)


def train(name, mesh, steps, pcfg, model, state):
    """Train steps ``steps`` on ``mesh``: (metrics a step, the gradients
    the optimizer was given a step, as this rank holds them)."""
    from repro_torch import config
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    cfg = _cfg("repro_torch", name)
    tcfg = config.TrainConfig(seq_len=SEQ, global_batch=BATCH, lr=LR,
                              steps=10, warmup=2)
    step, _, _ = ts.make_train_step(cfg, pcfg, tcfg, mesh)
    lo, hi = ts.data_rows(mesh, BATCH)
    grads, mets = [], []
    orig = opt.adamw_update

    def spy(c, params, g, st, **kw):
        grads.append({n: v.detach().clone() for n, v in g.items()})
        return orig(c, params, g, st, **kw)
    opt.adamw_update = spy
    try:
        for i in steps:
            m = step(model, state, _batch(cfg, i, lo, hi))
            mets.append({k: float(v) for k, v in m.items()})
    finally:
        opt.adamw_update = orig
    return mets, grads


def _slice(model, name, whole):
    """This rank's FSDP shard of ``whole`` (a leaf as the run without
    FSDP holds it: its model-axis shard) for ``model``'s leaf ``name``."""
    from repro_torch.distributed import tensor_parallel as tpm
    p = dict(model.named_parameters())[name]
    size, rank = getattr(model, "fsdp_shards", None) or (1, 0)
    return tpm.local_part(whole, tpm.fsdp_dim(p), rank, size)


def _max_err(model_f, tree_f, tree_p):
    """The largest absolute difference of the FSDP run's shards from the
    plain run's leaves sliced alike."""
    return max(float((a - _slice(model_f, n, tree_p[n])).abs().max())
               for n, a in tree_f.items())


def _equal(model_f, tree_f, tree_p):
    import torch
    return all(torch.equal(a, _slice(model_f, n, tree_p[n]))
               for n, a in tree_f.items())


def _tree_err(a, b):
    """The largest absolute difference of two whole-leaf trees' params
    and moments."""
    pairs = [(a["params"], b["params"])] + [(a["opt"][k], b["opt"][k])
                                            for k in ("mu", "nu")]
    return max(float((x[n] - y[n]).abs().max())
               for x, y in pairs for n in y)


def fsdp_case(name, mesh, shape, rank, out_dir):
    """One config on ``mesh``: the plain run (no FSDP, no remat) and the
    FSDP run (remat "full") for STEPS, step 0 again with FSDP alone and
    with remat alone, the checkpoint, remesh and STEPS more."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.api import RankRetired
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.distributed.elastic import remesh
    from repro_torch.launch import train as ltrain
    from repro_torch.training import checkpoint as ckpt
    plain_p, full_p = _pcfg(), _pcfg(remat="full")
    rec = {}
    runs = {}
    for key, fsdp, pcfg, steps in (("plain", False, plain_p, STEPS),
                                   ("fsdp", True, full_p, STEPS),
                                   ("fsdp_no_remat", True, plain_p, 1),
                                   ("remat", False, full_p, 1)):
        model, state = fresh(name, mesh, fsdp, pcfg)
        mets, grads = train(name, mesh, range(steps), pcfg, model, state)
        runs[key] = (model, state, mets, grads)
        rec[f"mets/{key}"] = mets
    fm, fstate, fmets, fgrads = runs["fsdp"]
    pm, pstate, pmets, pgrads = runs["plain"]
    rec["split_leaves"] = sum(tpm.fsdp_dim(p) is not None
                              for p in fm.parameters())
    rec["loss0_equal"] = fmets[0]["loss"] == pmets[0]["loss"]
    rec["grad0_shards_equal"] = _equal(fm, fgrads[0], pgrads[0])
    rec["grad_shards_err"] = [_max_err(fm, f, p)
                              for f, p in zip(fgrads, pgrads)]
    params = {n: p.detach() for n, p in fm.named_parameters()}
    rec["param_err"] = _max_err(fm, params, {
        n: p.detach() for n, p in pm.named_parameters()})
    for key, other in (("fsdp_no_remat", "fsdp"), ("remat", "plain")):
        _, _, m1, g1 = runs[key]
        _, _, m0, g0 = runs[other]
        rec[f"remat_equal/{key}"] = m1[0] == m0[0] and all(
            torch.equal(g1[0][n], g0[0][n]) for n in g0[0])
    # the whole-leaf checkpoints, remesh and STEPS more steps
    lead = rank == 0
    trees = {}
    for key in ("plain", "fsdp"):
        model, state = runs[key][:2]
        tree = tpm.full_tree(model, state, mesh, keep=lead)
        d = os.path.join(out_dir, f"ck_{shape}_{name}_{key}")
        if lead:
            ckpt.save(d, STEPS, tree)
            trees[key] = tree
        dist.barrier()
    if lead:
        rec["tree_err"] = _tree_err(trees["fsdp"], trees["plain"])
        rec["tree_whole"] = all(
            tuple(trees["fsdp"]["params"][n].shape)
            == tuple(trees["plain"]["params"][n].shape)
            for n in trees["plain"]["params"])
    del runs, trees
    n2, m2 = REMESH[shape]
    try:
        mesh2 = remesh(n2, model_parallel=m2, device="cpu")
    except RankRetired as e:
        rec["remesh"] = ["retired", e.rank, e.p]
        return rec
    after = {}
    for key, fsdp, pcfg in (("plain", False, plain_p),
                            ("fsdp", True, full_p)):
        model, state = fresh(name, mesh2, fsdp, pcfg)
        ltrain.load_tree(model, state, ckpt.restore(
            os.path.join(out_dir, f"ck_{shape}_{name}_{key}"), STEPS,
            tpm.full_shapes(model, state)))
        mets, _ = train(name, mesh2, range(STEPS, 2 * STEPS), pcfg, model,
                        state)
        after[key] = (mets, int(state["step"]))
    rec["remesh"] = ["recovered", list(mesh2.ranks.shape), after]
    return rec


def moe_case(mesh):
    """DeepSeek's MoE layer on ``mesh``'s data group, its leaves split as
    the config's placement splits them (this rank's row of the batch):
    the gradient shards under dispatch "spmm" against "einsum", and
    "einsum" against the unsplit layer's gradients sliced."""
    import torch
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.training import train_step as ts
    cfg = _cfg("repro_torch", "deepseek_v2_lite_16b")
    pcfg = _pcfg()
    prefix = "segments.1.0.blk0.moe."
    dims = sharding.fsdp_dims(cfg, pcfg, M.empty_model(cfg), mesh)
    fs = fsdp.of_mesh(mesh, pcfg)
    g = torch.Generator().manual_seed(7)
    whole = MOE.MoE(M.Init(g, torch.float32, "cpu"), cfg)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(
        (fs.size, 16, cfg.d_model)).astype(np.float32))
    proj = torch.as_tensor(rng.standard_normal(x.shape).astype(np.float32))
    rows = slice(fs.rank, fs.rank + 1)
    split = MOE.MoE(M.Init(torch.Generator().manual_seed(7), torch.float32,
                           "cpu"), cfg)
    for n, p in list(split.named_parameters()):
        d = dims[prefix + n]
        if d is None:
            continue
        owner, leaf = tpm._owner(split, n)
        part = torch.nn.Parameter(tpm.local_part(p.data, d, fs.rank,
                                                 fs.size).clone())
        part.fsdp_dim = d
        owner._parameters[leaf] = part

    def grads(layer, dispatch, xs, group):
        layer.zero_grad(set_to_none=True)
        view = fsdp.gathered(layer, group)
        out, aux = MOE.moe(cfg, pcfg, view, xs, dispatch=dispatch,
                           group=None if group is None else group.group)
        loss = (out * proj[rows if group else slice(None)]).sum() \
            + 0.01 * aux["lb_loss"]
        loss.backward()
        out = {n: p.grad.clone() for n, p in layer.named_parameters()}
        if group is not None:   # the replicated leaves' shares, summed
            ts.ordered_sum([g for n, g in out.items() if tpm.fsdp_dim(
                dict(layer.named_parameters())[n]) is None], group.group)
        return out
    spmm = grads(split, "spmm", x[rows], fs)
    einsum = grads(split, "einsum", x[rows], fs)
    one = grads(whole, "einsum", x, None)
    err = {}
    for n, w in einsum.items():
        scale = max(float(w.abs().max()), 1e-6)
        err[n] = float((spmm[n] - w).abs().max()) / scale
    one_err = {}
    for n, p in split.named_parameters():
        w = tpm.local_part(one[n], tpm.fsdp_dim(p), fs.rank, fs.size)
        scale = max(float(w.abs().max()), 1e-6)
        one_err[n] = float((einsum[n] - w).abs().max()) / scale
    return {"spmm_vs_einsum": err, "fsdp_vs_one": one_err,
            "split": sorted(n for n, p in split.named_parameters()
                            if tpm.fsdp_dim(p) is not None)}


def driver(out_dir, m):
    """``launch.train.main --fsdp --remat full --smoke`` over the world
    (2 steps with a checkpoint, then a run to 3 that resumes from it)
    and the same without the flags, to 3."""
    import contextlib
    import io
    from repro_torch.launch import train as ltrain
    args = ["--smoke", "--device", "cpu", "--seq", str(SEQ), "--batch",
            str(BATCH), "--model-parallel", str(m), "--log-every", "1"]
    ck = ["--ckpt-dir", os.path.join(out_dir, f"drv{m}")]
    out = {}
    for key, argv in (
            ("fsdp2", ["--steps", "2", "--fsdp", "--remat", "full"] + ck),
            ("fsdp3", ["--steps", "3", "--fsdp", "--remat", "full"] + ck),
            ("plain", ["--steps", "3"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ltrain.main(argv + args)
        out[key] = [rc, buf.getvalue().splitlines()]
    return out


def nccl_refused(mesh):
    """``fsdp.of_mesh`` on a card's mesh whose data group is gloo's
    raises."""
    import dataclasses
    import torch
    from repro_torch.distributed import fsdp
    card = dataclasses.replace(mesh, device=torch.device("cuda", 0))
    try:
        fsdp.of_mesh(card, _pcfg())
    except ValueError as e:
        return "NCCL" in str(e)
    return False


def worker(rank, world, init, out_dir):
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    _torch_spawn.join(rank, world, init)
    record = {"rank": rank}
    for shape, (d, m) in SHAPES.items():
        mesh = lmesh.make_local_mesh(d, m, device="cpu")
        record[f"nccl_refused/{shape}"] = nccl_refused(mesh)
        for name in TRAINED:
            record[f"case/{shape}/{name}"] = fsdp_case(name, mesh, shape,
                                                       rank, out_dir)
            dist.barrier()
        if m == 1:
            record["moe"] = moe_case(mesh)
        record[f"driver/{shape}"] = driver(out_dir, m)
        dist.barrier()
    _torch_spawn.save(out_dir, rank, {}, record)


# ---------------------------------------------------------------------------
# (a) the placement
# ---------------------------------------------------------------------------

def _config_names():
    from repro_torch import config
    return config.list_configs()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", _config_names())
def test_fsdp_dims_match_the_references_stacked_placement(arch, shape):
    import jax
    from repro import config as jconfig
    from repro.distributed import sharding as jsh
    from repro.models import model as JM
    from repro_torch import config
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    import repro.configs  # noqa: F401
    d, m = SHAPES[shape]
    sizes = {"data": d, "model": m}
    jcfg, cfg = jconfig.get_config(arch), config.get_config(arch)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    spec = JM.param_specs(jcfg, jconfig.ParallelConfig(), shapes)
    spec = jsh.sanitize_tree(jsh.fsdp_extend_tree(spec, shapes, sizes,
                                                  "data"), shapes, sizes)
    leaves = jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {}
    for path, s in leaves:
        names = [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]
        entries = list(s)
        if names[0] != "segments":
            want[".".join(names)] = entries
            continue
        cnt = cfg.segments[int(names[1])][1]
        if cnt > 1:
            assert not entries or entries[0] != "data", names  # scan axis
            entries = entries[1:]
        for ri in range(cnt):
            want[".".join(["segments", names[1], str(ri)] + names[2:])] = \
                entries
    mesh = _fake_mesh(d, m, (0, 0))
    got = sharding.fsdp_dims(cfg, config.ParallelConfig(),
                             M.empty_model(cfg), mesh)
    assert set(got) == set(want)
    for n, entries in want.items():
        ref = next((i for i, e in enumerate(entries) if e == "data"), None)
        assert got[n] == ref, n
    assert any(v is not None for v in got.values())
    specs = sharding.fsdp_specs(cfg, config.ParallelConfig(),
                                M.empty_model(cfg), mesh)
    for n, entries in want.items():
        padded = list(entries) + [None] * (len(specs[n]) - len(entries))
        assert [e[0] if isinstance(e, tuple) and len(e) == 1 else e
                for e in specs[n]] == padded, n


def test_qwen3_4b_stacked_norm_is_split_where_one_layers_would_not_be():
    from repro_torch import config
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    cfg = config.get_config("qwen3-4b")
    dims = sharding.fsdp_dims(cfg, config.ParallelConfig(),
                              M.empty_model(cfg), _fake_mesh(4, 1, (0, 0)))
    assert dims["segments.0.0.blk0.norm1"] == 0      # stacked (36, 2560)
    assert dims["final_norm"] is None                # (2560,) alone
    assert dims["head"] == 0 and dims["embed"] == 1  # "model" on the rest


# ---------------------------------------------------------------------------
# (b) the sharded init
# ---------------------------------------------------------------------------

#: the sharded init's meshes: (data, model, fsdp)
INIT_MESHES = {"4x1": (4, 1, True), "2x2": (2, 2, True),
               "1x2": (1, 2, False), "1x4": (1, 4, False)}


@pytest.mark.parametrize("shape", list(INIT_MESHES))
@pytest.mark.parametrize("name", ARCH_MODULES)
def test_sharded_init_equals_slices_of_the_whole_init(name, shape,
                                                      monkeypatch):
    import weakref
    import torch
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import model as M
    d, m, fsdp = INIT_MESHES[shape]
    cfg, pcfg = _cfg("repro_torch", name), _pcfg()
    whole = dict(M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu").named_parameters())
    drawn, live = [], []

    def watch(make):
        def watched(*a, **k):
            x = make(*a, **k)
            if x.device.type != "meta":
                # the storages of the earlier draws still alive now
                live.append([r for r in drawn if r() is not None])
                drawn.append(weakref.ref(x.untyped_storage()))
            return x
        return watched
    tiles = {n: {} for n in whole}
    for coords in np.ndindex(d, m):
        mesh = _fake_mesh(d, m, coords)
        for fn in ("randn", "full"):
            monkeypatch.setattr(torch, fn, watch(getattr(torch, fn)))
        g = torch.Generator().manual_seed(0)
        got = M.init_sharded(cfg, pcfg, g, mesh, fsdp=fsdp, device="cpu")
        monkeypatch.undo()
        # a storage alive at a draw is a parameter's, and no more than it
        own = {id(p.untyped_storage()) for p in got.parameters()
               if p.untyped_storage().nbytes() == p.numel() * p.element_size()}
        assert len(drawn) == len(whole)
        stale = [r for earlier in live for r in earlier
                 if r() is None or id(r()) not in own]
        assert not stale, f"{len(stale)} times two whole leaves"
        drawn.clear()
        live.clear()
        want = tpm.shard_model(cfg, pcfg, M.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), mesh,
            fsdp=fsdp)
        assert got.fsdp_shards == want.fsdp_shards == (
            (d, coords[0]) if fsdp else None)
        assert got.tp_shards == want.tp_shards
        for (n, p), (n2, q) in zip(got.named_parameters(),
                                   want.named_parameters()):
            assert n == n2 and torch.equal(p, q), n
            assert tpm.shard_dim(p) == tpm.shard_dim(q)
            assert tpm.fsdp_dim(p) == tpm.fsdp_dim(q)
            tiles[n][coords] = p.detach()
    for n, w in whole.items():
        p = dict(got.named_parameters())[n]
        td, fd = tpm.shard_dim(p), tpm.fsdp_dim(p)
        rows = []
        for i in range(d):
            cols = [tiles[n][(i, j)] for j in range(m)]
            rows.append(torch.cat(cols, td) if td is not None else cols[0])
        full = torch.cat(rows, fd) if fd is not None else rows[0]
        assert torch.equal(full, w.detach()), n
    split = tpm.fsdp_dim if fsdp else tpm.shard_dim
    assert any(split(p) is not None for p in got.parameters())


# ---------------------------------------------------------------------------
# (c) remat
# ---------------------------------------------------------------------------

def _step_grads(cfg, pcfg, model, batch):
    from repro_torch.training import train_step as ts
    loss, met = ts.lm_loss(cfg, pcfg, model, batch)
    loss.backward()
    return loss.detach(), met, {n: p.grad for n, p in
                                model.named_parameters()}


@pytest.mark.parametrize("name", ARCH_MODULES)
def test_remat_equals_no_remat_bit_for_bit(name):
    import torch
    from repro_torch.models import model as M
    cfg = _cfg("repro_torch", name)
    b = _batch(cfg, 0, 0, 2)
    runs = {}
    for remat in ("none", "full", "dots"):
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        runs[remat] = _step_grads(cfg, _pcfg(remat=remat), model, b)
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0])
        for n, g in runs["none"][2].items():
            assert torch.equal(runs[remat][2][n], g), (remat, n)


def test_remat_is_checked():
    import torch
    from repro_torch.models import model as M
    cfg = _cfg("repro_torch", "llama32_1b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with pytest.raises(ValueError, match="remat"):
        _step_grads(cfg, _pcfg(remat="some"), model, _batch(cfg, 0, 0, 2))


@pytest.mark.parametrize("name", ARCH_MODULES)
def test_remat_step_matches_the_references_remat(name):
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.models import model as JM
    from repro.training import train_step as jts
    from repro_torch import convert
    cfg, jcfg = _cfg("repro_torch", name), _cfg("repro", name)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    b = _batch(cfg, 0, 0, 2)
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    jpcfg = jconfig.ParallelConfig(compute_dtype="float32", remat="full")
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jts.lm_loss(jcfg, jpcfg, p, jb), has_aux=True)).lower(
        params).compile({"xla_backend_optimization_level": 0})(params)
    jg = convert._lm_flat(cfg, jax.tree.map(np.asarray, jg))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    loss, _, grads = _step_grads(cfg, _pcfg(remat="full"), model, b)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_TOL,
                                        abs=LOSS_TOL)
    assert set(grads) == set(jg)
    for n, w in jg.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(grads[n].numpy() - w).max())
        assert err <= GRAD_TOL * scale, (n, err, scale)


# ---------------------------------------------------------------------------
# one process: what needs no world
# ---------------------------------------------------------------------------

def test_fsdp_on_a_data_axis_of_one_changes_nothing():
    import torch
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import model as M
    cfg = _cfg("repro_torch", "llama32_1b")
    mesh = _fake_mesh(1, 1, (0, 0))
    assert fsdp.of_mesh(mesh, _pcfg()) is None
    model = M.init_sharded(cfg, _pcfg(), torch.Generator().manual_seed(0),
                           mesh, device="cpu")
    assert model.fsdp_shards is None and model.tp_shards is None
    whole = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert all(torch.equal(p, q) and tpm.fsdp_dim(p) is None for p, q in
               zip(model.parameters(), whole.parameters()))
    w = torch.nn.Parameter(torch.ones(4))
    w.fsdp_dim = 0
    assert fsdp.gather(w, None) is w and fsdp.gathered(model, None) is model


def test_driver_fsdp_flag_alone_changes_nothing():
    import contextlib
    import io
    from repro_torch.launch import train as ltrain
    out = []
    for flags in ([], ["--fsdp"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ltrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--seq", str(SEQ), "--batch", "2",
                              "--log-every", "1"] + flags)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if not ln.startswith("{") or '"loss"' in ln]
        out.append((rc, [ln.split('"elapsed"')[0] for ln in lines]))
    assert out[0] == out[1] and out[0][0] == 0
    assert out[0][1][-1] == "TRAINING DONE"


def test_serving_refuses_fsdp_split_leaves_and_specs_follow_fsdp():
    import torch
    from repro_torch import config
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    from repro_torch.serving import decode
    from repro_torch.training import train_step as ts
    cfg = _cfg("repro_torch", "llama32_1b")
    mesh = _fake_mesh(4, 1, (1, 0))
    model = M.init_sharded(cfg, _pcfg(), torch.Generator().manual_seed(0),
                           mesh, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    sharding.set_mesh(mesh)
    try:
        with pytest.raises(NotImplementedError, match="FSDP"):
            decode.prefill(cfg, _pcfg(), model, {"tokens": tok})
    finally:
        sharding.set_mesh(None)
    with pytest.raises(ValueError, match="FSDP-split"):
        # no mesh installed: the shards match no data group
        ts.lm_loss(cfg, _pcfg(), model, {"tokens": tok, "labels": tok})
    _, shardings_for, _ = ts.make_train_step(cfg, _pcfg(),
                                             config.TrainConfig(), mesh)
    psh, osh = shardings_for(model)
    want = sharding.fsdp_specs(cfg, _pcfg(), M.empty_model(cfg), mesh)
    assert psh == want and osh["mu"] == want and osh["nu"] == want
    assert any("data" in s for s in psh.values())


def test_global_norm_adds_the_data_shards_squares_once():
    import torch
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.training import optimizer as opt
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(8, 3, generator=g), torch.randn(5, generator=g)
    pa, pb = torch.nn.Parameter(a.clone()), torch.nn.Parameter(b.clone())
    pa.fsdp_dim = 0
    # a group of one rank: its sum is the rank's own
    got = opt.global_norm({"a": a, "b": b}, {"a": pa, "b": pb},
                          data_group=tpm.ONE)
    want = torch.sqrt(b.square().sum() + a.square().sum())
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (d) the world of 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fsdp"))
    return [r for _, r in _torch_spawn.spawn(__file__, 4, out)]


CASES = [(s, n) for s in SHAPES for n in TRAINED]


@pytest.mark.parametrize("shape,name", CASES)
def test_fsdp_step_zero_equals_the_unsplit_step_bit_for_bit(shape, name,
                                                           world):
    for rec in world:
        case = rec[f"case/{shape}/{name}"]
        assert case["split_leaves"] > 0
        assert case["loss0_equal"]
        for k in ("loss", "nll", "aux", "lr"):
            assert case["mets/fsdp"][0][k] == case["mets/plain"][0][k], k


@pytest.mark.parametrize("shape,name", CASES)
def test_fsdp_gradient_shards_are_the_ordered_sums_slices(shape, name,
                                                         world):
    for rec in world:
        case = rec[f"case/{shape}/{name}"]
        assert case["grad0_shards_equal"]
        assert case["grad_shards_err"][0] == 0.0


@pytest.mark.parametrize("shape,name", CASES)
def test_fsdp_three_steps_within_tol_of_the_unsplit_run(shape, name, world):
    for rec in world:
        case = rec[f"case/{shape}/{name}"]
        assert case["param_err"] <= STEP_TOL
        for a, b in zip(case["mets/fsdp"], case["mets/plain"]):
            assert a["loss"] == pytest.approx(b["loss"], abs=STEP_TOL)
            assert a["grad_norm"] == pytest.approx(b["grad_norm"],
                                                   rel=STEP_TOL)


@pytest.mark.parametrize("key", ["fsdp_no_remat", "remat"])
@pytest.mark.parametrize("shape,name", CASES)
def test_remat_equals_no_remat_on_the_world(shape, name, key, world):
    for rec in world:
        assert rec[f"case/{shape}/{name}"][f"remat_equal/{key}"]


@pytest.mark.parametrize("shape,name", CASES)
def test_fsdp_checkpoint_remesh_and_restore(shape, name, world):
    n2, m2 = REMESH[shape]
    case0 = world[0][f"case/{shape}/{name}"]
    assert case0["tree_whole"] and case0["tree_err"] <= STEP_TOL
    for r, rec in enumerate(world):
        case = rec[f"case/{shape}/{name}"]
        if r >= n2:
            assert case["remesh"] == ["retired", r, n2]
            continue
        outcome, mesh2, after = case["remesh"]
        assert outcome == "recovered" and mesh2 == [n2 // m2, m2]
        (mp, sp), (mf, sf) = after["plain"], after["fsdp"]
        assert sp == sf == 2 * STEPS
        for a, b in zip(mf, mp):
            assert a["loss"] == pytest.approx(b["loss"], abs=STEP_TOL)


def test_fsdp_moe_layer_spmm_matches_einsum(world):
    for rec in world:
        moe = rec["moe"]
        assert {"w1", "w3", "w2"} <= set(moe["split"])
        assert max(moe["spmm_vs_einsum"].values()) <= MOE_TOL
        assert max(moe["fsdp_vs_one"].values()) <= ONE_RANK_MOE_TOL


#: the data group's gathered layer against the unsplit layer on the whole
#: batch in one process (the gradients' sums in another order)
ONE_RANK_MOE_TOL = 1e-5


@pytest.mark.parametrize("shape", list(SHAPES))
def test_driver_fsdp_remat_resumes_with_the_same_losses(shape, world):
    import json
    runs = [rec[f"driver/{shape}"] for rec in world]
    for run in runs:
        for key in ("fsdp2", "fsdp3", "plain"):
            assert run[key][0] == 0 and run[key][1][-1] == "TRAINING DONE"
        assert run["fsdp3"][1][0] == "resumed from step 2"

    def losses(lines):
        return [json.loads(ln)["loss"] for ln in lines if ln.startswith("{")]
    for run in runs:
        fsdp = losses(run["fsdp2"][1]) + losses(run["fsdp3"][1])
        plain = losses(run["plain"][1])
        assert len(fsdp) == len(plain) == 3
        assert fsdp[0] == plain[0]
        assert fsdp == pytest.approx(plain, abs=STEP_TOL)
    assert all(run == runs[0] or [losses(run[k][1]) for k in run] == [
        losses(runs[0][k][1]) for k in run] for run in runs)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fsdp_on_a_card_needs_nccl(shape, world):
    for rec in world:
        assert rec[f"nccl_refused/{shape}"]


if __name__ == "__main__":
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
