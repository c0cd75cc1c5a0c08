"""The port's LM training path (training/{data,optimizer,train_step}.py,
the specs in models/model.py, distributed/sharding.py, launch/train.py)
against the reference's.

The same numpy-seeded inputs go through both packages; the LM weights
are the reference's ``init_params`` draw carried across
(``convert.lm_params_from_numpy``: a ``jax.random`` draw cannot be
reproduced by a ``torch.Generator``).  Tolerances: the data bit for bit;
AdamW over 10 steps within 1e-6; each reduced config's ``lm_loss``
within LOSS_TOL and every gradient leaf within GRAD_TOL of the leaf's
largest magnitude; microbatching within 5e-4 of the full batch (the
reference's own test); exact resume within 1e-6; the partition specs
equal leaf by leaf, the reference's scan axis dropped.  The reference's
value-and-grad of each config is computed once (``ref_grads``).
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import config as jconfig
from repro.distributed import sharding as jsh
from repro.models import model as JM
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import config, convert
from repro_torch.distributed import sharding
from repro_torch.launch import train as ltrain
from repro_torch.models import model as M
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data, optimizer as opt
from repro_torch.training import train_step as ts

ARCH_MODULES = [
    "jamba_v01_52b", "stablelm_1_6b", "llama32_1b", "qwen3_1_7b",
    "qwen3_4b", "qwen2_vl_72b", "mamba2_1_3b", "deepseek_v2_lite_16b",
    "phi35_moe_42b", "hubert_xlarge",
]
PCFG = config.ParallelConfig(compute_dtype="float32")
JPCFG = jconfig.ParallelConfig(compute_dtype="float32")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its ops are small, and beside
    the other test workers' default thread pools (one per core each)
    they crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(pkg, name):
    return importlib.import_module(f"{pkg}.configs.{name}").reduced()


def t(a):
    return torch.as_tensor(np.array(a))


def lm_batch(cfg, B=2, S=32, seed=0):
    """(reference batch, port batch) of one numpy draw, with labels."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.embed_inputs:
        b = {"tokens": lab, "labels": lab}
    else:
        b = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32), "labels": lab}
        if cfg.pos_dims == 3:
            b["positions"] = rng.integers(0, S, (B, S, 3)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: t(v) for k, v in b.items()})


def ref_compiled(f, *args):
    """``jax.jit(f)`` compiled once for ``args``' shapes without LLVM's
    backend optimizations: the same program, a third less compile time
    (most of the reference's cost in these tests)."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def port_model(cfg, params):
    return convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


def assert_leaves(got: dict, want: dict, tol):
    """Every leaf of ``got`` within ``tol`` of the largest magnitude of
    the same leaf of ``want``."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach().cpu().numpy()
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_data_is_the_references_bit_for_bit():
    ours = data.SyntheticLM(1000, 32, 8, seed=5)
    ref = jdata.SyntheticLM(1000, 32, 8, seed=5)
    for step in (0, 3, 11):
        for lo, hi in ((0, None), (2, 5), (7, 8)):
            a, b = ours.batch(step, lo, hi), ref.batch(step, lo, hi)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(ours.batch(3, 2, 5)["tokens"],
                                  ours.batch(3)["tokens"][2:5])
    for pos3 in (False, True):
        a = data.embeds_batch(4, 2, 48, 16, seed=1, pos3=pos3)
        b = jdata.embeds_batch(4, 2, 48, 16, seed=1, pos3=pos3)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_matches_reference_over_10_steps(clip):
    ocfg = opt.AdamWConfig(lr=1e-2, warmup=3, total_steps=10, grad_clip=clip)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup=3, total_steps=10,
                            grad_clip=clip)
    params = _opt_tree()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_opt_state(jp)
    tp = {k: t(v) for k, v in params.items()}
    state = opt.init_opt_state(tp)
    for i in range(10):
        g = {k: v * (i + 1) for k, v in _opt_tree(seed=i + 1).items()}
        jp, js, jm = jopt.adamw_update(jcfg, jp, {k: jnp.asarray(v)
                                                  for k, v in g.items()}, js)
        m = opt.adamw_update(ocfg, tp, {k: t(v) for k, v in g.items()},
                             state)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=OPT_TOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=OPT_TOL)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            np.testing.assert_allclose(state["mu"][k].numpy(),
                                       np.asarray(js["mu"][k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            np.testing.assert_allclose(state["nu"][k].numpy(),
                                       np.asarray(js["nu"][k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
    assert int(state["step"]) == int(js["step"]) == 10
    assert state["step"].dtype == torch.int32


def test_adamw_weight_decay_and_schedule():
    ocfg = opt.AdamWConfig(lr=0.1, weight_decay=0.5, warmup=0,
                           total_steps=10, grad_clip=1e9)
    params = {"w": torch.ones((4,))}
    state = opt.init_opt_state(params)
    opt.adamw_update(ocfg, params, {"w": torch.zeros((4,))}, state)
    assert float(params["w"][0]) < 1.0
    cfg = opt.AdamWConfig(lr=3e-4, warmup=100, total_steps=1000)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup=100, total_steps=1000)
    for step in (1, 100, 1000):
        got = float(opt._schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jopt._schedule(jcfg, jnp.asarray(step, jnp.int32)))
        assert got == pytest.approx(want, rel=OPT_TOL)
    assert float(opt._schedule(cfg, torch.tensor(100))) == \
        pytest.approx(3e-4, rel=OPT_TOL)
    assert float(opt._schedule(cfg, torch.tensor(1000))) == \
        pytest.approx(3e-5, rel=OPT_TOL)


# ---------------------------------------------------------------------------
# lm_loss and its gradients, every reduced config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_grads():
    """name -> (cfg, jcfg, params, batches, loss, metrics, grads by port
    name): the reference's value-and-grad of ``lm_loss``, once a
    config."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, jcfg = reduced("repro_torch", name), reduced("repro", name)
            params = JM.init_params(jcfg, jax.random.PRNGKey(0))
            jb, tb = lm_batch(cfg)
            (loss, met), g = ref_compiled(jax.value_and_grad(
                lambda p: jts.lm_loss(jcfg, JPCFG, p, jb),
                has_aux=True), params)(params)
            cache[name] = (cfg, jcfg, params, tb, float(loss),
                           {k: float(v) for k, v in met.items()},
                           convert._lm_flat(cfg, jax.tree.map(np.asarray, g)))
        return cache[name]
    return get


@pytest.mark.parametrize("name", ARCH_MODULES)
def test_lm_loss_and_grads_match_reference(name, ref_grads):
    cfg, _, params, tb, jloss, jmet, jgrads = ref_grads(name)
    model = port_model(cfg, params)
    loss, met = ts.lm_loss(cfg, PCFG, model, tb)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jloss, rel=LOSS_TOL,
                                                 abs=LOSS_TOL)
    for k in ("nll", "aux"):
        assert float(met[k].detach()) == pytest.approx(
            jmet[k], rel=LOSS_TOL, abs=LOSS_TOL)
    assert_leaves({n: p.grad for n, p in model.named_parameters()},
                  jgrads, GRAD_TOL)


def test_chunked_ce_matches_reference_across_chunks():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 64, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    tg = rng.integers(0, 40, (2, 64))
    mk = (rng.uniform(size=(2, 64)) > 0.3).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda x: jts.chunked_ce(x, jnp.asarray(head), jnp.asarray(tg),
                                 jnp.asarray(mk), chunk=16))(jnp.asarray(h))
    ht = t(h).requires_grad_(True)
    got = ts.chunked_ce(ht, t(head), t(tg), t(mk), chunk=16)
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_TOL)
    got.backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg),
                               rtol=GRAD_TOL, atol=1e-7)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def small_setup(seed=0, seq=64, batch=4):
    cfg = reduced("repro_torch", "llama32_1b")
    model = M.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    state = opt.init_opt_state(model)
    pipe = data.SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    return cfg, model, state, pipe


def tbatch(b):
    return {k: t(v) for k, v in b.items()}


def test_train_steps_match_reference_with_carried_state(ref_grads):
    """Three steps of both packages' train step from the same weights
    (each step's loss and grad norm); then the reference's parameters
    and AdamW state carried across (``lm_params_from_numpy``,
    ``lm_opt_state_from_numpy``) take a fourth step in both: the loss,
    and the parameters and moments after it.  (The parameters after the
    first steps are not compared: AdamW's first steps move a parameter by
    about lr * sign(g), so a gradient within float noise of 0 may move it
    by 2 lr; from a carried state the moments damp that.)"""
    cfg, jcfg, params, _, _, _, _ = ref_grads("llama32_1b")
    tcfg = config.TrainConfig(seq_len=32, global_batch=2, lr=1e-3, steps=10,
                              warmup=2)
    jtcfg = jconfig.TrainConfig(seq_len=32, global_batch=2, lr=1e-3,
                                steps=10, warmup=2)
    pipe = data.SyntheticLM(cfg.vocab, 32, 2, seed=4)
    jstep, _, _ = jts.make_train_step(jcfg, JPCFG, jtcfg, mesh=None)
    step, _, _ = ts.make_train_step(cfg, PCFG, tcfg, mesh=None)
    model = port_model(cfg, params)
    state = opt.init_opt_state(model)
    jp, js = params, jopt.init_opt_state(params)
    fn = None
    for i in range(4):
        b = pipe.batch(i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        fn = fn or ref_compiled(jstep, jp, js, jb)
        if i == 3:
            model = port_model(cfg, jp)
            state = convert.lm_opt_state_from_numpy(
                cfg, jax.tree.map(np.asarray, js), device="cpu")
            assert int(state["step"]) == 3
            assert state["step"].dtype == torch.int32
        jp, js, jm = fn(jp, js, jb)
        m = step(model, state, tbatch(b))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_TOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_TOL)
    assert int(state["step"]) == int(js["step"]) == 4
    assert_leaves(dict(model.named_parameters()),
                  convert._lm_flat(cfg, jax.tree.map(np.asarray, jp)),
                  GRAD_TOL)
    for key in ("mu", "nu"):
        assert_leaves(state[key], convert._lm_flat(
            cfg, jax.tree.map(np.asarray, js[key])), 2 * GRAD_TOL)


def test_loss_decreases_over_steps():
    cfg, model, state, pipe = small_setup()
    tcfg = config.TrainConfig(seq_len=64, global_batch=4, lr=1e-3, steps=60,
                              warmup=5)
    step, _, _ = ts.make_train_step(cfg, PCFG, tcfg, mesh=None)
    losses = [float(step(model, state, tbatch(pipe.batch(i)))["loss"])
              for i in range(60)]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first - 0.1, (first, last)


def test_microbatch_matches_full_batch():
    """Grad accumulation over microbatches == one big batch (same data),
    as the reference's own test holds it (5e-4 on the parameters)."""
    cfg, model, state, pipe = small_setup(seed=3)
    model2 = M.empty_model(cfg)
    model2.load_state_dict({k: v.clone() for k, v in
                            model.state_dict().items()}, assign=True)
    state2 = opt.init_opt_state(model2)
    b = tbatch(pipe.batch(0))
    full, _, _ = ts.make_train_step(cfg, PCFG, config.TrainConfig(
        seq_len=64, global_batch=4, microbatch=0, lr=1e-3), None)
    micro, _, _ = ts.make_train_step(cfg, PCFG, config.TrainConfig(
        seq_len=64, global_batch=4, microbatch=2, lr=1e-3), None)
    full(model, state, b)
    micro(model2, state2, b)
    d = max(float((p - q).abs().max()) for p, q in
            zip(model.parameters(), model2.parameters()))
    assert d < 5e-4, d


def test_exact_resume_reproduces_run(tmp_path):
    """Train 10 steps; vs train 5, checkpoint, restore, train 5 more."""
    cfg, model, state, pipe = small_setup(seed=2)
    tcfg = config.TrainConfig(seq_len=64, global_batch=4, lr=1e-3, steps=20)
    step, _, _ = ts.make_train_step(cfg, PCFG, tcfg, mesh=None)
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(10):
        step(model, state, tbatch(pipe.batch(i)))
    run_a = {k: v.clone() for k, v in model.state_dict().items()}

    model.load_state_dict(snap)
    state = opt.init_opt_state(model)
    for i in range(5):
        step(model, state, tbatch(pipe.batch(i)))
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, ltrain.train_tree(model, state))
    model_b = M.init_params(cfg, torch.Generator().manual_seed(9),
                            device="cpu")
    state_b = opt.init_opt_state(model_b)
    ltrain.load_tree(model_b, state_b, ckpt.restore(
        d, 5, ltrain.train_tree(model_b, state_b)))
    assert int(state_b["step"]) == 5
    for i in range(5, 10):
        step(model_b, state_b, tbatch(pipe.batch(i)))
    for k, v in model_b.state_dict().items():
        np.testing.assert_allclose(v.numpy(), run_a[k].numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# partition specs and sharding hygiene
# ---------------------------------------------------------------------------

def norm(spec):
    """A spec's entries, a one-name tuple as the name (jax's form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, (tuple, list)) else e)
                 for e in spec)


def _path_names(path):
    return [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]


def ref_by_port_name(cfg, tree, is_leaf):
    """{port name: (reference leaf, repeats stacked?)} of a reference
    tree laid out as init_params' (segments' leaves stacked over their
    repeats)."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    for path, leaf in leaves:
        names = _path_names(path)
        if names[0] != "segments":
            out[".".join(names)] = (leaf, False)
            continue
        si = int(names[1])
        cnt = cfg.segments[si][1]
        for ri in range(cnt):
            out[".".join(["segments", str(si), str(ri)] + names[2:])] = \
                (leaf, cnt > 1)
    return out


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("name", ARCH_MODULES)
@pytest.mark.parametrize("dp_over_model", [False, True])
def test_param_specs_equal_reference(name, dp_over_model):
    cfg, jcfg = reduced("repro_torch", name), reduced("repro", name)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    pcfg = config.ParallelConfig(dp_over_model=dp_over_model)
    jpcfg = jconfig.ParallelConfig(dp_over_model=dp_over_model)
    want = ref_by_port_name(cfg, JM.param_specs(jcfg, jpcfg, shapes),
                            _is_spec)
    model = M.empty_model(cfg)
    got = M.param_specs(cfg, pcfg, model)
    assert set(got) == set(want)
    sizes = {"data": 4, "model": 3}
    named = dict(model.named_parameters())
    san = sharding.sanitize_tree(got, named, sizes)
    fsdp = sharding.fsdp_extend_tree(got, named, sizes, "data")
    for pname, (spec, stacked) in want.items():
        ref = jax.sharding.PartitionSpec(*(tuple(spec)[1:] if stacked
                                           else tuple(spec)))
        assert isinstance(got[pname], sharding.P)
        assert norm(got[pname]) == norm(ref), pname
        shape = tuple(named[pname].shape)
        assert norm(san[pname]) == norm(jsh.sanitize_spec(ref, shape, sizes))
        assert norm(fsdp[pname]) == norm(jsh.fsdp_extend_spec(
            ref, shape, sizes, "data"))


@pytest.mark.parametrize("name", ["llama32_1b", "deepseek_v2_lite_16b",
                                  "jamba_v01_52b", "mamba2_1_3b"])
@pytest.mark.parametrize("pod,seq", [(None, False), ("pod", True)])
def test_cache_specs_equal_reference(name, pod, seq):
    cfg, jcfg = reduced("repro_torch", name), reduced("repro", name)
    pcfg = config.ParallelConfig(pod_axis=pod, seq_shard_decode=seq)
    jpcfg = jconfig.ParallelConfig(pod_axis=pod, seq_shard_decode=seq)
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 16))
    want = JM.cache_specs(jcfg, jpcfg, jc)
    got = M.cache_specs(cfg, pcfg, M.init_cache(cfg, 2, 16, device="meta"))
    for si, (_, cnt) in enumerate(cfg.segments):
        assert len(got["segments"][si]) == cnt
        for rep in got["segments"][si]:
            for blk, entry in rep.items():
                ref = want["segments"][si][blk]
                assert set(entry) == set(ref)
                for leaf, spec in entry.items():
                    r = tuple(ref[leaf])
                    r = r[1:] if cnt > 1 else r
                    assert norm(spec) == norm(r), (blk, leaf)


def test_sanitize_and_fsdp_match_reference_rule_for_rule():
    P, JP = sharding.P, jax.sharding.PartitionSpec
    sizes = {"data": 4, "model": 2, "pod": 2}
    specs = [((None, "model"), (12, 6)), (("model", None), (5, 8)),
             ((("pod", "data"), None), (16, 3)), ((("pod", "data"),), (6,)),
             ((None,), (300, 512)), ((), (256, 256)), (("data",), (3, 1024)),
             ((None, None, "model"), (2, 64, 1024))]
    for spec, shape in specs:
        assert norm(sharding.sanitize_spec(P(*spec), shape, sizes)) == \
            norm(jsh.sanitize_spec(JP(*spec), shape, sizes))
        for mn in (2 ** 10, 2 ** 16):
            assert norm(sharding.fsdp_extend_spec(
                P(*spec), shape, sizes, "data", min_size=mn)) == \
                norm(jsh.fsdp_extend_spec(JP(*spec), shape, sizes, "data",
                                          min_size=mn))
    tree = {"a": [P(None, "model"), P("model")], "b": P()}
    shapes = {"a": [torch.empty(3, 4), torch.empty(6)],
              "b": torch.empty(2, 2)}
    out = sharding.sanitize_tree(tree, shapes, sizes)
    assert out == {"a": [P(None, "model"), P("model")], "b": P(None, None)}


def test_constrain_and_model_axis_refused():
    """constrain is the identity, with or without a model axis; the
    train step builds under a mesh with model > 1 (tests/test_torch_tp.py
    runs it); serving a whole model under that mesh raises (decode), as
    does the serve driver asked for a model axis that one process cannot
    hold, rather than run replicated (tests/test_torch_serve_tp.py
    serves on the model axis)."""
    import types
    from repro_torch.launch import serve as lserve
    from repro_torch.serving import decode
    x = torch.ones(2, 3)
    assert M.constrain(x, ("data",), None) is x
    cfg = reduced("repro_torch", "llama32_1b")
    tp = types.SimpleNamespace(axis_sizes={"data": 1, "model": 2},
                               axis_names=("data", "model"), coords=(0, 0),
                               data_group=None, model_group=None)
    step, _, _ = ts.make_train_step(cfg, PCFG, config.TrainConfig(), tp)
    assert callable(step)
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    sharding.set_mesh(tp)
    try:
        assert M.constrain(x) is x
        with pytest.raises(ValueError, match="shard_model"):
            decode.prefill(cfg, PCFG, model, {"tokens": tok})
        cache = M.init_cache(cfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="shard_model"):
            decode.decode_step(cfg, PCFG, model, {"tokens": tok[:, :1]},
                               cache)
        with pytest.raises(ValueError, match=r"\(0, 2\) mesh"):
            lserve.main(["--smoke", "--device", "cpu", "--batches", "1",
                         "--model-parallel", "2"])
    finally:
        sharding.set_mesh(None)
    assert M.batch_axes(jconfig.ParallelConfig(pod_axis="pod")) == \
        JM.batch_axes(jconfig.ParallelConfig(pod_axis="pod"))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

REF_KEYS = {"step", "loss", "grad_norm", "lr", "elapsed"}


def test_train_driver_smoke_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` prints
    the reference's keys a step and TRAINING DONE, checkpoints, and a
    second run (in this process) resumes from the committed step."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    ck = str(tmp_path / "ck")
    args = ["--smoke", "--device", "cpu", "--seq", "64", "--batch", "4",
            "--log-every", "1", "--ckpt-dir", ck]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--steps", "3"] + args, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "TRAINING DONE"
    recs = [json.loads(ln) for ln in lines[:-1]]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert set(r) == REF_KEYS
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
    assert ckpt.latest_step(ck) == 3
    assert ltrain.main(["--steps", "5"] + args) == 0
    again = capsys.readouterr().out.splitlines()
    assert again[0] == "resumed from step 3"
    assert [json.loads(ln)["step"] for ln in again[1:-1]] == [3, 4]
    assert again[-1] == "TRAINING DONE"
    assert ckpt.latest_step(ck) == 5


def test_train_driver_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ltrain.main(["--smoke", "--steps", "1"])
