"""Tensor parallelism over the mesh's ``model`` axis on gloo ranks.

This file run as a script is the worker (tests/_torch_spawn.py spawns
one world a mesh shape, once a module: (data 1, model 2), (1, 4) and
(2, 2), the last also resuming on (1, 2) from a checkpoint).  Each rank
builds the reduced configs' models from one torch seed, keeps its
shards (``tensor_parallel.shard_model``) and records what the tests
below read:

* each layer under TP (the MLP; GQA, with a KV split inside a head at
  m = 4; GQA with qk_norm; MLA; Mamba2; MoE under the einsum and the
  SpMM dispatch, the SpMM on its plain version here; the vocab-parallel
  embedding and cross-entropy), forward and backward, whole gradients
  gathered, held to the reference (``jax.vjp`` on the same numpy
  inputs and the same weights) within REF_TOL and to the port's
  one-rank layer within ONE_TOL of each leaf's largest magnitude;
* one train step of every reduced config at (1, 2), and of llama and
  DeepSeek at (1, 4) and (2, 2), against the port's one-rank step
  (loss, grad norm, every gathered gradient leaf within ONE_TOL; the
  one-rank step is held to the reference by test_torch_training.py);
* bit for bit: ``seq_parallel`` == TP, two runs, the replicated leaves
  on every model rank, ``dp_over_model`` at (2, 2) == the (4, 1)
  data-parallel run, ``TP.sum`` and ``TP.sum_chunk``'s chunks gathered
  == the ranks' parts added in rank order;
* ``full_tree``: whole leaves of the parameters and moments on the
  writing rank, nothing on the others;
* check_elastic.py's flow: the reduced llama 3 steps at (2, 2), a
  checkpoint of whole leaves, ``remesh(2, model_parallel=2)``, 3 more
  steps at (1, 2) (``step == 6``, the two ranks left out raising
  ``api.RankRetired``), each loss within REF_TOL of the reference's 6
  steps on one device from the same weights.
"""
import importlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import _torch_spawn  # noqa: E402

ARCH_MODULES = [
    "jamba_v01_52b", "stablelm_1_6b", "llama32_1b", "qwen3_1_7b",
    "qwen3_4b", "qwen2_vl_72b", "mamba2_1_3b", "deepseek_v2_lite_16b",
    "phi35_moe_42b", "hubert_xlarge",
]
#: the train steps' global batch and sequence
SEQ, BATCH = 32, 4
REF_TOL = 1e-4
ONE_TOL = 1e-5
#: layer -> (config, the module's path in the model)
LAYERS = {
    "mlp": ("llama32_1b", "segments.0.0.blk0.mlp"),
    "gqa": ("llama32_1b", "segments.0.0.blk0.attn"),
    "gqa_qk_norm": ("qwen3_4b", "segments.0.0.blk0.attn"),
    "gqa_two_heads": ("llama_two_heads", "segments.0.0.blk0.attn"),
    "mla": ("deepseek_v2_lite_16b", "segments.1.0.blk0.attn"),
    "mamba2": ("mamba2_1_3b", "segments.0.0.blk0.mamba"),
    "moe_einsum": ("deepseek_v2_lite_16b", "segments.1.0.blk0.moe"),
    "moe_spmm": ("deepseek_v2_lite_16b", "segments.1.0.blk0.moe"),
    "moe_unstacked_shared": ("deepseek_one_moe", "segments.1.0.blk0.moe"),
    "embed_ce": ("llama32_1b", ""),
}
LAYER_B, LAYER_S, CE_CHUNK = 2, 32, 16
MOE_AUX = 0.1
#: the worlds: shape -> (data, model)
SHAPES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
#: the configs each world trains (all ten at (1, 2))
TRAINED = {"1x2": ARCH_MODULES + ["deepseek_one_moe"],
           "1x4": ["llama32_1b", "deepseek_v2_lite_16b"],
           "2x2": ["llama32_1b", "deepseek_v2_lite_16b"]}
#: those also run under seq_parallel (bit for bit == TP)
SEQ_PARALLEL = {"1x2": ARCH_MODULES, "1x4": ["llama32_1b"],
                "2x2": ["llama32_1b"]}
#: check_elastic.py's run
ELASTIC_SEQ, ELASTIC_BATCH, ELASTIC_LR = 64, 8, 1e-3


#: reduced configs changed where the stock ones split nothing oddly:
#: two query heads and one KV head (a query split inside a head at m =
#: 4, a KV split inside one at m = 2), and DeepSeek with its MoE layer
#: unrepeated (the shared experts' unstacked spec splits their d)
VARIANTS = {
    "llama_two_heads": ("llama32_1b",
                        lambda c: dict(n_heads=2, n_kv_heads=1)),
    "deepseek_one_moe": ("deepseek_v2_lite_16b", lambda c: dict(
        segments=(c.segments[0], (c.segments[1][0], 1)))),
}


def _cfg(pkg, name):
    import dataclasses
    base, change = VARIANTS.get(name, (name, None))
    cfg = importlib.import_module(f"{pkg}.configs.{base}").reduced()
    return cfg if change is None else dataclasses.replace(cfg, **change(cfg))


def _pcfg(**kw):
    from repro_torch import config
    return config.ParallelConfig(compute_dtype="float32", **kw)


def _model(name):
    import torch
    from repro_torch.models import model as M
    return M.init_params(_cfg("repro_torch", name),
                         torch.Generator().manual_seed(0), device="cpu")


def _batch(cfg, step, lo, hi, seq=SEQ, batch=BATCH, seed=1):
    import torch
    from repro_torch.training import data
    b = data.SyntheticLM(cfg.vocab, seq, batch, seed=seed).batch(step, lo,
                                                                  hi)
    if not cfg.embed_inputs:
        eb = data.embeds_batch(step, batch, seq, cfg.d_model,
                               pos3=(cfg.pos_dims == 3))
        b = dict({k: v[lo:hi] for k, v in eb.items()}, labels=b["labels"])
    return {k: torch.as_tensor(v) for k, v in b.items()}


def layer_inputs(name):
    """(x (B, S, d) or tokens, the output's cotangent or targets)."""
    cfg = _cfg("repro_torch", LAYERS[name][0])
    rng = np.random.default_rng(sorted(LAYERS).index(name))
    if name == "embed_ce":
        tok = rng.integers(0, cfg.vocab, (LAYER_B, LAYER_S))
        tgt = rng.integers(0, cfg.vocab, (LAYER_B, LAYER_S))
        return tok.astype(np.int64), tgt.astype(np.int64)
    x = rng.standard_normal((LAYER_B, LAYER_S, cfg.d_model))
    dout = rng.standard_normal((LAYER_B, LAYER_S, cfg.d_model))
    return x.astype(np.float32), dout.astype(np.float32)


def _dispatch(name):
    return "spmm" if name == "moe_spmm" else "einsum"


def _ce_mask():
    mask = np.ones((LAYER_B, LAYER_S), np.float32)
    mask[:, -1] = 0.0
    return mask


def run_layer(name, model, tp):
    """Forward and backward of one layer of ``model`` (its shards under
    ``tp``, whole otherwise): ``{"out", "dx", "g/<leaf>"}`` whole."""
    import torch
    import torch.nn.functional as F
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm, swiglu, swiglu_tp
    from repro_torch.training import train_step as ts
    cfg = _cfg("repro_torch", LAYERS[name][0])
    pcfg = _pcfg()
    a, b = layer_inputs(name)
    if name == "embed_ce":
        tok, tgt = torch.as_tensor(a), torch.as_tensor(b)
        mask = torch.as_tensor(_ce_mask())
        if tp is None:
            x = F.embedding(tok, model.embed)
            hid = rms_norm(x, model.final_norm, cfg.norm_eps)
            out = ts.chunked_ce(hid, model.embed.T, tgt, mask, CE_CHUNK)
        else:
            x = M.embed_tp(cfg, model, {"tokens": tok}, torch.float32, tp)
            hid = tpm.rms_norm(x, model.final_norm, cfg.norm_eps, tp)
            head, lo = M.vocab_head(cfg, model)
            out = ts.chunked_ce(hid, head, tgt, mask, CE_CHUNK, tp=tp,
                                vocab_lo=lo)
        out.backward()
        mod, rec = model, {"out": out.detach()}
        leaves = {"embed": model.embed, "final_norm": model.final_norm}
    else:
        mod = model.get_submodule(LAYERS[name][1])
        x = torch.as_tensor(a).requires_grad_(True)
        aux = 0.0
        if tp is None:
            if name == "mlp":
                out = swiglu(x, mod.w1, mod.w3, mod.w2)
            elif name.startswith("gqa"):
                out = A.gqa(cfg, pcfg, mod, x, {})[0]
            elif name == "mla":
                out = A.mla(cfg, pcfg, mod, x, {})[0]
            elif name == "mamba2":
                out = ssm.mamba2(cfg, pcfg, mod, x, {})[0]
            else:
                out, aux = MOE.moe(cfg, pcfg, mod, x,
                                   dispatch=_dispatch(name))
                aux = aux["lb_loss"]
        else:
            h = tp.enter(x)
            if name == "mlp":
                part, rep = swiglu_tp(h, mod.w1, mod.w3, mod.w2)
            elif name.startswith("gqa"):
                part, rep = A.gqa_tp(cfg, pcfg, mod, h, {}, tp)
            elif name == "mla":
                part, rep = A.mla_tp(cfg, pcfg, mod, h, {}, tp)
            elif name == "mamba2":
                part, rep = ssm.mamba2_tp(cfg, pcfg, mod, h, tp)
            else:
                (part, rep), aux = MOE.moe_tp(cfg, pcfg, mod, h, tp,
                                              dispatch=_dispatch(name))
                aux = aux["lb_loss"]
            out = tp.exit(part, rep)
        loss = (out * torch.as_tensor(b)).sum() + MOE_AUX * aux
        loss.backward()
        rec = {"out": out.detach(), "dx": x.grad}
        leaves = dict(mod.named_parameters())
    for n, p in leaves.items():
        rec[f"g/{n}"] = tpm.full_leaf(p.grad, tpm.shard_dim(p), tp)
    model.zero_grad(set_to_none=True)
    return {k: v.detach().numpy() for k, v in rec.items()}


def train(name, mesh, steps, pcfg=None, model=None, state=None, seq=SEQ,
          batch=BATCH, lr=1e-3, seed=1):
    """``steps`` train steps of a reduced config on ``mesh`` (this rank's
    shards and rows): (model, state, metrics a step, the whole
    gradients the optimizer was given at each step)."""
    from repro_torch import config
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    cfg = _cfg("repro_torch", name)
    pcfg = pcfg or _pcfg()
    if model is None:
        model = tpm.shard_model(cfg, pcfg, _model(name), mesh)
        state = opt.init_opt_state(model)
    tcfg = config.TrainConfig(seq_len=seq, global_batch=batch, lr=lr,
                              steps=10, warmup=2)
    step, _, _ = ts.make_train_step(cfg, pcfg, tcfg, mesh)
    lo, hi = ts.data_rows(mesh, batch, pcfg.dp_over_model)
    tp = tpm.of_mesh(mesh, pcfg)
    dims = {n: tpm.shard_dim(p) for n, p in model.named_parameters()}
    grads, mets = [], []
    orig = opt.adamw_update

    def spy(c, params, g, st, **kw):
        grads.append({n: tpm.full_leaf(v.detach().clone(), dims[n], tp)
                      for n, v in g.items()})
        return orig(c, params, g, st, **kw)
    opt.adamw_update = spy
    try:
        for i in steps:
            m = step(model, state, _batch(cfg, i, lo, hi, seq, batch, seed))
            mets.append({k: float(v) for k, v in m.items()})
    finally:
        opt.adamw_update = orig
    return model, state, mets, grads


def _arrays(prefix, tree):
    return {f"{prefix}/{k}": (v.detach().numpy() if hasattr(v, "detach")
                              else np.asarray(v)) for k, v in tree.items()}


def worker(rank, world, init, out_dir, shape):
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.launch import mesh as lmesh
    _torch_spawn.join(rank, world, init)
    data, m = SHAPES[shape]
    mesh = lmesh.make_local_mesh(model=m, device="cpu")
    tp = tpm.of_mesh(mesh, _pcfg())
    lead = rank == 0
    arrays, record = {}, {"rank": rank, "coords": list(mesh.coords)}
    if data == 1:
        sharding.set_mesh(mesh)
        for name, (cfg_name, _) in LAYERS.items():
            model = tpm.shard_model(_cfg("repro_torch", cfg_name), _pcfg(),
                                    _model(cfg_name), mesh)
            rec = run_layer(name, model, tp)
            if lead:
                arrays.update(_arrays(f"layer/{name}/tp", rec))
        sharding.set_mesh(None)
    for name in TRAINED[shape]:
        model, _, mets, grads = train(name, mesh, range(1))
        record[f"train/{name}"] = mets
        for i, g in enumerate(grads):
            arrays.update(_arrays(f"train/{name}/grad{i}", g))
        arrays.update(_arrays(f"train/{name}/param", {
            n: p for n, p in model.named_parameters()
            if tpm.shard_dim(p) is None}))
        if name in SEQ_PARALLEL[shape]:
            sp, _, mets_sp, _ = train(name, mesh, range(1),
                                      _pcfg(seq_parallel=True))
            record[f"sp/{name}"] = mets_sp
            record[f"sp_equal/{name}"] = all(
                torch.equal(p, q) for p, q in zip(model.parameters(),
                                                  sp.parameters()))
    record["sum_forms"] = sum_forms(rank, mesh)
    record["full_tree"] = full_tree_matches(mesh, lead)
    again, _, _, _ = train(TRAINED[shape][0], mesh, range(2))
    first, _, _, _ = train(TRAINED[shape][0], mesh, range(2))
    record["two_runs_equal"] = all(
        torch.equal(p, q) for p, q in zip(again.parameters(),
                                          first.parameters()))
    if shape == "1x2":
        record["driver"] = driver(out_dir)
    if shape == "2x2":
        # dp_over_model at (2, 2) against the (4, 1) data-parallel run
        dpm, _, mets_a, _ = train("llama32_1b", mesh, range(2),
                                  _pcfg(dp_over_model=True))
        dp = lmesh.make_local_mesh(model=1, device="cpu")
        plain, _, mets_b, _ = train("llama32_1b", dp, range(2))
        record["dp_over_model"] = [mets_a, mets_b, all(
            torch.equal(p, q) for p, q in zip(dpm.parameters(),
                                              plain.parameters()))]
        record["elastic"] = elastic(rank, mesh, out_dir)
    # the one-rank runs, after every collective, shared out over the ranks
    layers = list(LAYERS) if data == 1 else []
    for i, item in enumerate(layers + TRAINED[shape]):
        if i % world != rank:
            continue
        if i < len(layers):
            arrays.update(_arrays(f"layer/{item}/one", run_layer(
                item, _model(LAYERS[item][0]), None)))
        else:
            _, _, mets1, grads1 = train(item, None, range(1))
            record[f"one/{item}"] = mets1
            for j, g in enumerate(grads1):
                arrays.update(_arrays(f"one/{item}/grad{j}", g))
    _torch_spawn.save(out_dir, rank, arrays, record)


#: the model group's sums' operands: split into chunks along dimension 0,
#: along dimension 1, along none
SUM_SHAPES = {"chunked": (4, 6), "chunked_inner": (3, 8),
              "whole": (3, 5), "scalar": ()}


def sum_forms(rank, mesh):
    """{case: TP.sum over the model group, and where a dimension splits
    the chunks of TP.sum_chunk gathered, == the all-gathered parts added
    in rank order, bit for bit}."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import tensor_parallel as tpm
    tp = tpm.of_mesh(mesh, _pcfg())
    out = {}
    for case, shape in SUM_SHAPES.items():
        g = torch.Generator().manual_seed(100 + rank)
        x = torch.randn(shape, generator=g)
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x, group=tp.group)
        want = parts[0].clone()
        for q in parts[1:]:
            want += q
        dim = next((i for i, n in enumerate(shape) if n % tp.size == 0),
                   None)
        out[case] = torch.equal(tp.sum(x), want) and (
            dim is None or torch.equal(tp.cat(tp.sum_chunk(x, dim), dim),
                                       want))
    return out


def full_tree_matches(mesh, lead):
    """``full_tree`` of a sharded model and its moments: on the writer,
    every leaf whole and equal to the one-rank model's (mu, nu: the
    leaves times 2 and 3); elsewhere None."""
    import torch
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.training import optimizer as opt
    name = "deepseek_v2_lite_16b"
    model = tpm.shard_model(_cfg("repro_torch", name), _pcfg(),
                            _model(name), mesh)
    state = opt.init_opt_state(model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            state["mu"][n].copy_(p * 2)
            state["nu"][n].copy_(p * 3)
    tree = tpm.full_tree(model, state, mesh, keep=lead)
    if not lead:
        return tree is None
    whole = dict(_model(name).named_parameters())
    return (set(tree["params"]) == set(whole) and all(
        torch.equal(tree[k][n] if k == "params" else tree["opt"][k][n],
                    w.detach() * f)
        for k, f in (("params", 1), ("mu", 2), ("nu", 3))
        for n, w in whole.items()) and int(tree["opt"]["step"]) == 0)


def driver(out_dir):
    """``launch.train.main --model-parallel 2`` over the world: 2 steps
    with a checkpoint, then a run to 3 that resumes from it."""
    import contextlib
    import io
    from repro_torch.launch import train as ltrain
    args = ["--smoke", "--device", "cpu", "--seq", str(SEQ), "--batch",
            str(BATCH), "--model-parallel", "2", "--log-every", "1",
            "--ckpt-dir", os.path.join(out_dir, "drv")]
    out = []
    for steps in ("2", "3"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ltrain.main(["--steps", steps] + args)
        out.append([rc, buf.getvalue().splitlines()])
    return out


def _ref_model(out_dir):
    """The reduced llama with the reference's initial weights (written
    by the test process)."""
    import torch
    from repro_torch.models import model as M
    with np.load(os.path.join(out_dir, "ref_init.npz")) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    model = M.empty_model(_cfg("repro_torch", "llama32_1b"))
    model.load_state_dict(state, strict=True, assign=True)
    return model


def elastic(rank, mesh, out_dir):
    """check_elastic.py's flow: 3 steps at (2, 2), a checkpoint, 3 more
    at (1, 2) after remesh."""
    import torch
    from repro_torch.core.api import RankRetired
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.distributed.elastic import remesh
    from repro_torch.launch import train as ltrain
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    cfg = _cfg("repro_torch", "llama32_1b")
    pcfg = _pcfg()
    kw = dict(seq=ELASTIC_SEQ, batch=ELASTIC_BATCH, lr=ELASTIC_LR, seed=0)

    def fresh(mesh):
        model = tpm.shard_model(cfg, pcfg, _ref_model(out_dir), mesh)
        return model, opt.init_opt_state(model)
    model, state = fresh(mesh)
    _, _, mets, _ = train("llama32_1b", mesh, range(3), model=model,
                          state=state, **kw)
    out = {"phase1": mets}
    tree = tpm.full_tree(model, state, mesh, keep=rank == 0)
    ck = os.path.join(out_dir, "elastic_ck")
    if rank == 0:
        ckpt.save(ck, 3, tree)
    torch.distributed.barrier()
    try:
        mesh2 = remesh(2, model_parallel=2, device="cpu")
    except RankRetired as e:
        out["retired"] = [e.rank, e.p]
        return out
    model, state = fresh(mesh2)
    ltrain.load_tree(model, state, ckpt.restore(
        ck, 3, tpm.full_shapes(model, state)))
    _, state, mets, _ = train("llama32_1b", mesh2, range(3, 6), model=model,
                              state=state, **kw)
    out.update(phase2=mets, step=int(state["step"]),
               mesh=list(mesh2.ranks.shape))
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_elastic_init():
    """The reference's initial llama weights: (its pytree, the same
    under the port's names as numpy)."""
    import jax
    from repro.models import model as JM
    from repro_torch import convert
    params = JM.init_params(_cfg("repro", "llama32_1b"),
                            jax.random.PRNGKey(0))
    init = convert.lm_params_from_numpy(
        _cfg("repro_torch", "llama32_1b"), jax.tree.map(np.asarray, params),
        device="cpu")
    return params, {k: v.numpy() for k, v in init.state_dict().items()}


def _ref_elastic_losses(params):
    """The reference's 6 losses on one device: check_elastic.py's run."""
    import jax
    from repro import config as jconfig
    from repro.training import data as jdata
    from repro.training import optimizer as jopt
    from repro.training import train_step as jts
    jcfg = _cfg("repro", "llama32_1b")
    state = jopt.init_opt_state(params)
    tcfg = jconfig.TrainConfig(seq_len=ELASTIC_SEQ,
                               global_batch=ELASTIC_BATCH, lr=ELASTIC_LR,
                               steps=10, warmup=2)
    step, _, _ = jts.make_train_step(
        jcfg, jconfig.ParallelConfig(compute_dtype="float32"), tcfg, None)
    pipe = jdata.SyntheticLM(jcfg.vocab, ELASTIC_SEQ, ELASTIC_BATCH, seed=0)
    b0 = jax.tree.map(jax.numpy.asarray, pipe.batch(0))
    fn = jax.jit(step).lower(params, state, b0).compile(
        {"xla_backend_optimization_level": 0})
    losses = []
    for i in range(6):
        params, state, m = fn(params, state,
                              jax.tree.map(jax.numpy.asarray, pipe.batch(i)))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def reference():
    """The reference's numbers, computed in a thread while the worlds'
    ranks run: (the elastic run's initial weights, a future of (its 6
    losses, {layer: the reference's layer}))."""
    from concurrent.futures import ThreadPoolExecutor
    params, init = _ref_elastic_init()

    def compute():
        layers = {name: _ref_layer(name, _model(LAYERS[name][0]))
                  for name in LAYERS}
        return _ref_elastic_losses(params), layers
    with ThreadPoolExecutor(1) as pool:
        yield init, pool.submit(compute)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, reference):
    """shape -> its world's ranks' (arrays, record); the worlds run at
    once, each rank on one thread."""
    from concurrent.futures import ThreadPoolExecutor
    runs = {}
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        for shape, (data, m) in SHAPES.items():
            out = str(tmp_path_factory.mktemp(f"tp{shape}"))
            if shape == "2x2":
                np.savez(os.path.join(out, "ref_init.npz"), **reference[0])
            runs[shape] = pool.submit(_torch_spawn.spawn, __file__, data * m,
                                      out, shape)
        yield lambda shape: runs[shape].result()


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _ref_layer(name, model):
    """The reference's layer on the port model's weights and the same
    inputs: ``{"out", "dx", "g/<leaf>"}``."""
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.models import attention as JA
    from repro.models import layers as JL
    from repro.models import moe as JMOE
    from repro.models import ssm as JS
    from repro.training import train_step as jts
    jcfg = _cfg("repro", LAYERS[name][0])
    jpcfg = jconfig.ParallelConfig(compute_dtype="float32")
    a, b = layer_inputs(name)
    if name == "embed_ce":
        leaves = {"embed": model.embed, "final_norm": model.final_norm}
    else:
        leaves = dict(model.get_submodule(LAYERS[name][1])
                      .named_parameters())
    p = {}
    for n, v in leaves.items():
        *path, leaf = n.split(".")
        d = p
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = jnp.asarray(v.detach().numpy())

    if name == "embed_ce":
        tok, tgt, mask = (jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(_ce_mask()))

        def f(p):
            x = p["embed"][tok]
            hid = JL.rms_norm(x, p["final_norm"], jcfg.norm_eps)
            return jts.chunked_ce(hid, p["embed"].T, tgt, mask, CE_CHUNK)
        out, g = jax.jit(jax.value_and_grad(f)).lower(p).compile(
            {"xla_backend_optimization_level": 0})(p)
        return {"out": np.asarray(out), "g/embed": np.asarray(g["embed"]),
                "g/final_norm": np.asarray(g["final_norm"])}

    def f(x, p):
        aux = 0.0
        if name == "mlp":
            out = JL.swiglu(x, p["w1"], p["w3"], p["w2"])
        elif name.startswith("gqa"):
            out = JA.gqa(jcfg, jpcfg, p, x, {})[0]
        elif name == "mla":
            out = JA.mla(jcfg, jpcfg, p, x, {})[0]
        elif name == "mamba2":
            out = JS.mamba2(jcfg, jpcfg, p, x, {})[0]
        else:
            out, aux = JMOE.moe(jcfg, jpcfg, p, x, dispatch=_dispatch(name))
            aux = aux["lb_loss"]
        return out, jnp.sum(out * jnp.asarray(b)) + MOE_AUX * aux
    def fwd_bwd(x, p):
        (out, _), vjp = jax.vjp(f, x, p)
        return (out,) + vjp((jnp.zeros_like(out), jnp.ones(())))
    x = jnp.asarray(a)
    # compiled without LLVM's backend optimizations: one compile in
    # place of eager dispatch, op by op
    out, dx, gp = jax.jit(fwd_bwd).lower(x, p).compile(
        {"xla_backend_optimization_level": 0})(x, p)
    rec = {"out": np.asarray(out), "dx": np.asarray(dx)}

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.")
            else:
                rec[f"g/{prefix}{k}"] = np.asarray(v)
    flat(gp)
    return rec


def _merged(ranks):
    """(arrays, record): rank 0's with the one-rank runs of every rank."""
    arrays, record = dict(ranks[0][0]), dict(ranks[0][1])
    for a, r in ranks[1:]:
        arrays.update({k: v for k, v in a.items() if "/one" in k
                       or k.startswith("one/")})
        record.update({k: v for k, v in r.items() if k.startswith("one/")})
    return arrays, record


def _layer(arrays, name, which):
    pre = f"layer/{name}/{which}/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_reference(name, shape, worlds, reference):
    got = _layer(worlds(shape)[0][0], name, "tp")
    want = reference[1].result()[1][name]
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], REF_TOL, k)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_one_rank(name, shape, worlds):
    arrays = _merged(worlds(shape))[0]
    got, want = _layer(arrays, name, "tp"), _layer(arrays, name, "one")
    assert set(got) == set(want) and want
    for k in want:
        _close(got[k], want[k], ONE_TOL, k)


@pytest.mark.parametrize("name,leaf,m,spec,width", [
    ("llama32_1b", "segments.0.0.blk0.attn.wk", 4, (None, "model"), "hd"),
    ("llama_two_heads", "segments.0.0.blk0.attn.wk", 2, (None, "model"),
     "hd"),
    ("llama_two_heads", "segments.0.0.blk0.attn.wq", 4, (None, "model"),
     "hd"),
    ("deepseek_one_moe", "segments.1.0.blk0.moe.shared.w1", 2,
     ("model", None), None)])
def test_layer_cases_split_where_they_claim(name, leaf, m, spec, width):
    """The sanitized spec keeps each case's split, and it falls inside a
    head (the gathered paths), or on d (the shared experts' unstacked
    rule)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    cfg = _cfg("repro_torch", name)
    model = _model(name)
    named = dict(model.named_parameters())
    specs = sharding.sanitize_tree(M.param_specs(cfg, _pcfg(), model),
                                   named, {"data": 1, "model": m})
    assert specs[leaf] == sharding.P(*spec)
    if width == "hd":
        assert (named[leaf].shape[1] // m) % cfg.hd != 0


def _train_case(arrays, record, key, name):
    return (record[f"{key}/{name}"],
            {k: v for k, v in arrays.items()
             if k.startswith(f"{key}/{name}/grad")})


@pytest.mark.parametrize("shape,name",
                         [(s, n) for s in SHAPES for n in TRAINED[s]])
def test_train_step_matches_one_rank(shape, name, worlds):
    ranks = worlds(shape)
    arrays, record = _merged(ranks)
    mets, grads = _train_case(arrays, record, "train", name)
    mets1, grads1 = _train_case(arrays, record, "one", name)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        assert mets[0][k] == pytest.approx(mets1[0][k], rel=ONE_TOL,
                                           abs=ONE_TOL), k
    assert len(grads) == len(grads1) > 0
    for k, w in grads1.items():
        _close(grads[k.replace("one/", "train/", 1)], w, ONE_TOL, k)
    for arrays_r, record_r in ranks[1:]:
        assert record_r[f"train/{name}"] == mets


@pytest.mark.parametrize("shape,name",
                         [(s, n) for s in SHAPES for n in SEQ_PARALLEL[s]])
def test_seq_parallel_equals_tp_bit_for_bit(shape, name, worlds):
    for _, record in worlds(shape):
        assert record[f"sp/{name}"] == record[f"train/{name}"]
        assert record[f"sp_equal/{name}"]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_two_runs_and_replicated_leaves_bit_for_bit(shape, worlds):
    ranks = worlds(shape)
    a0 = ranks[0][0]
    for arrays, record in ranks:
        assert record["two_runs_equal"]
        keys = [k for k in a0 if "/param/" in k]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(arrays[k], a0[k], err_msg=k)


@pytest.mark.parametrize("case", list(SUM_SHAPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tp_sum_is_the_rank_order_sum_bit_for_bit(shape, case, worlds):
    for _, record in worlds(shape):
        assert record["sum_forms"][case]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_full_tree_gathers_whole_leaves_to_the_writer(shape, worlds):
    for _, record in worlds(shape):
        assert record["full_tree"] is True


def test_train_driver_on_the_model_axis_resumes(worlds):
    """``launch.train.main --model-parallel 2``: both ranks log the same
    steps, the second run resumes from the whole-leaf checkpoint."""
    import json
    runs = [record["driver"] for _, record in worlds("1x2")]
    for (rc1, first), (rc2, second) in runs:
        assert rc1 == rc2 == 0
        assert first[-1] == second[-1] == "TRAINING DONE"
        assert [json.loads(ln)["step"] for ln in first[:-1]] == [0, 1]
        assert second[0] == "resumed from step 2"
        assert [json.loads(ln)["step"] for ln in second[1:-1]] == [2]

    def losses(run):
        return [(r["loss"], r["grad_norm"]) for _, lines in run
                for r in map(json.loads, [ln for ln in lines
                                          if ln.startswith("{")])]
    assert losses(runs[0]) == losses(runs[1])


def test_dp_over_model_equals_data_parallel_bit_for_bit(worlds):
    for _, record in worlds("2x2"):
        mets_a, mets_b, same = record["dp_over_model"]
        assert mets_a == mets_b and same


def test_elastic_remesh_resumes_at_step_six(worlds, reference):
    losses = reference[1].result()[0]
    for r, (_, record) in enumerate(worlds("2x2")):
        el = record["elastic"]
        got = [m["loss"] for m in el["phase1"]]
        assert got == pytest.approx(losses[:3], rel=REF_TOL)
        if r < 2:
            assert el["step"] == 6 and el["mesh"] == [1, 2]
            assert [m["loss"] for m in el["phase2"]] == pytest.approx(
                losses[3:], rel=REF_TOL)
        else:
            assert el["retired"] == [r, 2]


if __name__ == "__main__":
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
           sys.argv[6])
