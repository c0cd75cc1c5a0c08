"""Serving under the mesh's ``model`` axis on gloo ranks.

This file run as a script is the worker (tests/_torch_spawn.py spawns
one world of 4 ranks, once a module).  Each rank forms a (data 2, model
2) mesh and a (data 1, model 4) mesh over the world, loads the reference
``init_params`` draw of every reduced config that has a decode step
(all but HuBERT, an encoder: ``launch/dryrun.py``'s skip) written by the
test process, keeps its shards (``tensor_parallel.shard_model``) and,
with ``seq_shard_decode`` on and off, serves its rows of one batch
(``serving.decode.rows``; the MoE routing is the global batch's):
prefill, ``extend_cache`` and DECODE_STEPS teacher-fed decode steps, its
cache's leaf shapes after each, the cache gathered whole
(``tensor_parallel.full_cache``) and a greedy run.  The one-rank port
(``tensor_parallel.ONE``, whole leaves, no mesh) runs the same, shared
out over the ranks.  The tests hold:

* the prefill's last logits and every decode step's logits at m = 2 and
  4 to the reference's ``decode.prefill``/``decode_step`` (computed once
  a session on one JAX CPU device, in a thread while the ranks run)
  within REF_TOL;
* greedy tokens at m = 2 and 4 to m = 1's;
* each rank's cache leaves to the shapes of the sanitized
  ``cache_specs`` slice (GQA's ``k``/``v`` keep their heads' shard
  without ``seq_shard_decode``: a difference by design), after prefill,
  after ``extend_cache`` (including a length that does not divide by m,
  whole, and one that starts whole and splits after growing) and from
  ``init_cache`` on the mesh, whose empty cache decodes as one rank's;
* the gathered cache to the one-rank cache within ONE_TOL;
* serving under ``seq_parallel`` to TP bit for bit;
* a cached forward on FSDP-split leaves raising ``SERVE_FSDP``;
* ``launch.serve.main --model-parallel 2`` and ``4`` over the world.
"""
import importlib
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import _torch_spawn  # noqa: E402
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

ARCHS = ["jamba_v01_52b", "stablelm_1_6b", "llama32_1b", "qwen3_1_7b",
         "qwen3_4b", "qwen2_vl_72b", "mamba2_1_3b", "deepseek_v2_lite_16b",
         "phi35_moe_42b"]
#: the world's meshes: name -> (data, model)
MESHES = {"m2": (2, 2), "m4": (1, 4)}
WORLD = 4
#: the served batch: rows, prompt positions, teacher-fed decode steps
BATCH, PROMPT, DECODE_STEPS = 2, 8, 8
GREEDY_STEPS = 6
REF_TOL = 1e-4
ONE_TOL = 1e-5
#: placements across extend_cache at m = 4 under seq_shard_decode:
#: (prompt, extra) -> split before, split after
REGIMES = {"whole_to_split": (6, 10), "split_to_whole": (8, 6)}
REGIME_ARCHS = ["llama32_1b", "deepseek_v2_lite_16b", "jamba_v01_52b"]
REGIME_STEPS = 3
#: the driver's runs: --model-parallel -> its batch
DRIVER = {"2": 4, "4": 2}


def _cfg(pkg, name):
    return importlib.import_module(f"{pkg}.configs.{name}").reduced()


def _pcfg(seq=False, seq_parallel=False):
    from repro_torch import config
    return config.ParallelConfig(compute_dtype="float32",
                                 seq_shard_decode=seq,
                                 seq_parallel=seq_parallel)


def inputs(cfg):
    """The batch's prompt and teacher-fed tokens (or embeds): {name:
    (BATCH, PROMPT + DECODE_STEPS, ...)} as numpy."""
    rng = np.random.default_rng(5)
    n = PROMPT + DECODE_STEPS
    if cfg.embed_inputs:
        return {"tokens": rng.integers(0, cfg.vocab, (BATCH, n))}
    return {"embeds": rng.standard_normal((BATCH, n, cfg.d_model))
            .astype(np.float32)}


def _window(batch, lo, hi, a, b):
    import torch
    return {k: torch.as_tensor(v[lo:hi, a:b]) for k, v in batch.items()}


def _model(out_dir, name):
    """The reduced config's model holding the reference's initial
    weights (written by the test process)."""
    import torch
    from repro_torch.models import model as M
    with np.load(os.path.join(out_dir, f"ref_{name}.npz")) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    model = M.empty_model(_cfg("repro_torch", name))
    model.load_state_dict(state, strict=True, assign=True)
    return model


def shapes_of(cache):
    """{"segments.<s>.<r>.<blk>.<leaf>": shape} of a cache."""
    out = {}
    for s, seg in enumerate(cache["segments"]):
        for r, rep in enumerate(seg):
            for blk, entry in rep.items():
                for leaf, x in entry.items():
                    out[f"segments.{s}.{r}.{blk}.{leaf}"] = list(x.shape)
    return out


def _flat(prefix, cache):
    out = {}
    for s, seg in enumerate(cache["segments"]):
        for r, rep in enumerate(seg):
            for blk, entry in rep.items():
                for leaf, x in entry.items():
                    out[f"{prefix}/segments.{s}.{r}.{blk}.{leaf}"] = \
                        x.float().numpy()
    return out


def serve(cfg, pcfg, model, batch, lo, hi, group, prompt, extra, steps,
          tp=None):
    """Prefill of ``prompt`` positions of rows [lo, hi), ``extend_cache``
    by ``extra``, ``steps`` teacher-fed decode steps: (logits (rows,
    1 + steps, vocab), the shapes after prefill and after extending, the
    last cache gathered whole over ``tp``)."""
    import torch
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.serving import decode
    logits, cache = decode.prefill(cfg, pcfg, model,
                                   _window(batch, lo, hi, 0, prompt), group)
    out, shapes = [logits[:, -1]], [shapes_of(cache)]
    cache = decode.extend_cache(cache, extra, pcfg)
    shapes.append(shapes_of(cache))
    for i in range(steps):
        logits, cache = decode.decode_step(
            cfg, pcfg, model,
            _window(batch, lo, hi, prompt + i, prompt + i + 1), cache,
            group)
        out.append(logits[:, 0])
    return torch.stack(out, 1), shapes, tpm.full_cache(cache, tp)


def worker(rank, world, init, out_dir):
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.launch import mesh as lmesh
    from repro_torch.serving import decode
    _torch_spawn.join(rank, world, init)
    arrays, record = {}, {"rank": rank}
    meshes = {k: lmesh.mesh_over(world, d, m, "cpu")
              for k, (d, m) in MESHES.items()}
    for mname, mesh in meshes.items():
        sharding.set_mesh(mesh)
        for name in ARCHS:
            cfg = _cfg("repro_torch", name)
            batch = inputs(cfg)
            model = tpm.shard_model(cfg, _pcfg(), _model(out_dir, name),
                                    mesh)
            for seq in (False, True):
                pcfg = _pcfg(seq)
                tp = tpm.of_mesh(mesh, pcfg)
                lo, hi, group = decode.rows(mesh, pcfg, BATCH)
                key = f"{mname}/{name}/{int(seq)}"
                logits, shapes, full = serve(
                    cfg, pcfg, model, batch, lo, hi, group, PROMPT,
                    DECODE_STEPS, DECODE_STEPS, tp)
                arrays[f"{key}/logits"] = logits.numpy()
                arrays.update(_flat(f"{key}/cache", full))
                record[key] = {"rows": [lo, hi], "shapes": shapes,
                               "coords": list(mesh.coords)}
                if cfg.embed_inputs:
                    toks = decode.greedy_generate(
                        cfg, pcfg, model,
                        _window(batch, lo, hi, 0, PROMPT), GREEDY_STEPS,
                        group)
                    arrays[f"{key}/greedy"] = toks.numpy()
                if name in REGIME_ARCHS:
                    logits, init_shapes = from_init(cfg, pcfg, model, batch,
                                                    lo, hi, group, mesh)
                    arrays[f"{key}/init/logits"] = logits.numpy()
                    record[key]["init_shapes"] = init_shapes
                if mname == "m4" and seq and name in REGIME_ARCHS:
                    logits, _, _ = serve(
                        cfg, _pcfg(True, seq_parallel=True), model, batch,
                        lo, hi, group, PROMPT, DECODE_STEPS, DECODE_STEPS)
                    arrays[f"{key}/sp/logits"] = logits.numpy()
                    for regime, (prompt, extra) in REGIMES.items():
                        logits, shapes, _ = serve(
                            cfg, pcfg, model, batch, lo, hi, group, prompt,
                            extra, REGIME_STEPS, tp)
                        arrays[f"{key}/{regime}/logits"] = logits.numpy()
                        record[f"{key}/{regime}"] = {"shapes": shapes}
        sharding.set_mesh(None)
    record["fsdp"] = fsdp_refused(world)
    record["driver"] = driver()
    # the one-rank runs, shared out over the ranks
    for i, name in enumerate(ARCHS):
        if i % world != rank:
            continue
        cfg = _cfg("repro_torch", name)
        batch = inputs(cfg)
        model = _model(out_dir, name)
        logits, _, full = serve(cfg, _pcfg(), model, batch, 0, BATCH, None,
                                PROMPT, DECODE_STEPS, DECODE_STEPS)
        arrays[f"one/{name}/logits"] = logits.numpy()
        arrays.update(_flat(f"one/{name}/cache", full))
        if cfg.embed_inputs:
            arrays[f"one/{name}/greedy"] = decode.greedy_generate(
                cfg, _pcfg(), model, _window(batch, 0, BATCH, 0, PROMPT),
                GREEDY_STEPS).numpy()
        if name in REGIME_ARCHS:
            arrays[f"one/{name}/init/logits"] = from_init(
                cfg, _pcfg(), model, batch, 0, BATCH, None, None)[0].numpy()
            for regime, (prompt, extra) in REGIMES.items():
                logits, _, _ = serve(cfg, _pcfg(), model, batch, 0, BATCH,
                                     None, prompt, extra, REGIME_STEPS)
                arrays[f"one/{name}/{regime}/logits"] = logits.numpy()
    _torch_spawn.save(out_dir, rank, arrays, record)


def from_init(cfg, pcfg, model, batch, lo, hi, group, mesh):
    """REGIME_STEPS decode steps from an empty cache of PROMPT +
    DECODE_STEPS slots that ``init_cache`` places on ``mesh`` (float32):
    (logits (rows, steps, vocab), its leaf shapes)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import decode
    cache = M.init_cache(cfg, BATCH, PROMPT + DECODE_STEPS, torch.float32,
                         "cpu", pcfg, mesh)
    shapes, out = shapes_of(cache), []
    for i in range(REGIME_STEPS):
        logits, cache = decode.decode_step(
            cfg, pcfg, model, _window(batch, lo, hi, i, i + 1), cache, group)
        out.append(logits[:, 0])
    return torch.stack(out, 1), shapes


def fsdp_refused(world):
    """A prefill of leaves that FSDP split over a (4, 1) mesh raises
    SERVE_FSDP."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import model as M
    from repro_torch.serving import decode
    cfg = _cfg("repro_torch", "llama32_1b")
    mesh = lmesh.mesh_over(world, world, 1, "cpu")
    model = M.init_sharded(cfg, _pcfg(), torch.Generator().manual_seed(0),
                           mesh, fsdp=True, device="cpu")
    sharding.set_mesh(mesh)
    try:
        decode.prefill(cfg, _pcfg(), model,
                       {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    except NotImplementedError as e:
        return str(e) == M.SERVE_FSDP
    finally:
        sharding.set_mesh(None)
    return False


def driver():
    """``launch.serve.main --model-parallel m`` over the world: (exit
    code, its lines) a run."""
    import contextlib
    import io
    from repro_torch.launch import serve as lserve
    out = {}
    for m, batch in DRIVER.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = lserve.main(["--smoke", "--device", "cpu", "--batches", "2",
                              "--batch", str(batch), "--prompt-len", "8",
                              "--gen", "4", "--model-parallel", m])
        out[m] = [rc, buf.getvalue().splitlines()]
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _ref_weights(name):
    """The reference's initial weights: (its pytree, the port's state as
    numpy)."""
    import jax
    from repro.models import model as JM
    from repro_torch import convert
    params = JM.init_params(_cfg("repro", name), jax.random.PRNGKey(1))
    model = convert.lm_params_from_numpy(
        _cfg("repro_torch", name), jax.tree.map(np.asarray, params),
        device="cpu")
    return params, {k: v.numpy() for k, v in model.state_dict().items()}


def _ref_logits(name, params):
    """The reference's prefill last logits and DECODE_STEPS teacher-fed
    decode steps' logits on one device: (BATCH, 1 + steps, vocab)."""
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.serving import decode as jdecode
    jcfg = _cfg("repro", name)
    jpcfg = jconfig.ParallelConfig(compute_dtype="float32")
    batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
             for k, v in inputs(jcfg).items()}

    def window(a, b):
        return {k: v[:, a:b] for k, v in batch.items()}
    logits, cache = jdecode.prefill(jcfg, jpcfg, params, window(0, PROMPT))
    out = [np.asarray(logits[:, -1])]
    cache = jdecode.extend_cache(cache, DECODE_STEPS)
    step = jax.jit(lambda p, b, c: jdecode.decode_step(jcfg, jpcfg, p, b, c))
    for i in range(DECODE_STEPS):
        logits, cache = step(params, window(PROMPT + i, PROMPT + i + 1),
                             cache)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's ranks' (arrays, record), a future of {arch: the
    reference's logits}): the reference's weights written first, its
    decode run in a thread while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor
    out = str(tmp_path_factory.mktemp("serve_tp"))
    params = {}
    for name in ARCHS:
        params[name], state = _ref_weights(name)
        np.savez(os.path.join(out, f"ref_{name}.npz"), **state)
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(lambda: {n: _ref_logits(n, p)
                                   for n, p in params.items()})
        ranks = _torch_spawn.spawn(__file__, WORLD, out)
        yield ranks, ref


def _cases():
    return [(m, n, s) for m in MESHES for n in ARCHS for s in (0, 1)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("mesh,name,seq", _cases())
def test_logits_match_reference(mesh, name, seq, world):
    ranks, ref = world
    want = ref.result()[name]
    for arrays, record in ranks:
        key = f"{mesh}/{name}/{seq}"
        lo, hi = record[key]["rows"]
        got = arrays[f"{key}/logits"]
        assert got.shape == (hi - lo, 1 + DECODE_STEPS, want.shape[-1])
        _close(got, want[lo:hi], REF_TOL, f"rank {record['rank']} {key}")


def _one(ranks, key):
    return next(a[key] for a, _ in ranks if key in a)


@pytest.mark.parametrize("mesh,name,seq", [
    c for c in _cases() if _cfg("repro_torch", c[1]).embed_inputs])
def test_greedy_tokens_equal_one_rank(mesh, name, seq, world):
    ranks, _ = world
    want = _one(ranks, f"one/{name}/greedy")
    for arrays, record in ranks:
        key = f"{mesh}/{name}/{seq}"
        lo, hi = record[key]["rows"]
        np.testing.assert_array_equal(arrays[f"{key}/greedy"], want[lo:hi])


def expected_shapes(name, mesh, seq, S):
    """{leaf path: this rank's shape} of a cache of ``S`` positions: the
    sanitized ``cache_specs`` slice (the model axis at its size, the data
    axis at its), GQA's ``k``/``v`` split on their heads instead where
    ``seq_shard_decode`` is off and the KV heads divide."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    cfg = _cfg("repro_torch", name)
    pcfg = _pcfg(bool(seq))
    data, m = MESHES[mesh]
    sizes = {"data": data, "model": m}
    whole = M.init_cache(cfg, BATCH, S, device="meta")
    specs = sharding.sanitize_tree(M.cache_specs(cfg, pcfg, whole), whole,
                                   sizes)
    out = {}
    for path, shape in shapes_of(whole).items():
        *at, leaf = path.split(".")
        s_, r_, blk = int(at[1]), int(at[2]), at[3]
        spec = specs["segments"][s_][r_][blk][leaf]
        shape = list(shape)
        for i, e in enumerate(spec):
            axes = e if isinstance(e, tuple) else (e,)
            for a in axes:
                if a in sizes:
                    shape[i] //= sizes[a]
        if leaf in ("k", "v") and not seq and cfg.n_kv_heads % m == 0:
            shape[2] //= m
        out[path] = shape
    return out


@pytest.mark.parametrize("mesh,name,seq", _cases())
def test_cache_leaves_are_the_sanitized_slice(mesh, name, seq, world):
    ranks, _ = world
    key = f"{mesh}/{name}/{seq}"
    want = [expected_shapes(name, mesh, seq, PROMPT),
            expected_shapes(name, mesh, seq, PROMPT + DECODE_STEPS)]
    for _, record in ranks:
        assert record[key]["shapes"] == want


@pytest.mark.parametrize("mesh,name,seq", [
    c for c in _cases() if c[1] in REGIME_ARCHS])
def test_init_cache_allocates_the_slice_and_decodes(mesh, name, seq, world):
    """``init_cache`` on the mesh allocates the sanitized slice, and
    decode steps from it equal the one-rank run's."""
    ranks, _ = world
    key = f"{mesh}/{name}/{seq}"
    want = _one(ranks, f"one/{name}/init/logits")
    shapes = expected_shapes(name, mesh, seq, PROMPT + DECODE_STEPS)
    for arrays, record in ranks:
        assert record[key]["init_shapes"] == shapes
        lo, hi = record[key]["rows"]
        _close(arrays[f"{key}/init/logits"], want[lo:hi], ONE_TOL, key)


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("name", REGIME_ARCHS)
def test_extend_cache_replaces_positions_for_the_new_length(name, regime,
                                                            world):
    """At m = 4 under seq_shard_decode: a prompt of 6 stays whole and
    splits at 16; a prompt of 8 splits and stays whole at 14; the logits
    of both equal the one-rank run's."""
    ranks, _ = world
    prompt, extra = REGIMES[regime]
    key = f"m4/{name}/1/{regime}"
    want_shapes = [expected_shapes(name, "m4", 1, prompt),
                   expected_shapes(name, "m4", 1, prompt + extra)]
    cfg = _cfg("repro_torch", name)
    if not cfg.mla_kv_lora:
        split = [(prompt + e) % MESHES["m4"][1] == 0 for e in (0, extra)]
        assert split == ([False, True] if regime == "whole_to_split"
                         else [True, False])
    want = _one(ranks, f"one/{name}/{regime}/logits")
    for arrays, record in ranks:
        assert record[key]["shapes"] == want_shapes
        _close(arrays[f"{key}/logits"], want, ONE_TOL, key)


@pytest.mark.parametrize("name", REGIME_ARCHS)
def test_seq_parallel_serving_equals_tp(name, world):
    """At m = 4 under seq_shard_decode, serving with ``seq_parallel``
    (prefill's residual stream split over positions; a decode step's one
    position runs without the split) gives TP's logits bit for bit."""
    ranks, _ = world
    key = f"m4/{name}/1"
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays[f"{key}/sp/logits"],
                                      arrays[f"{key}/logits"])


@pytest.mark.parametrize("mesh,name,seq", _cases())
def test_full_cache_equals_one_rank_cache(mesh, name, seq, world):
    ranks, _ = world
    pre = f"one/{name}/cache/"
    want = {k[len(pre):]: v for a, _ in ranks for k, v in a.items()
            if k.startswith(pre)}
    assert want
    for arrays, record in ranks:
        key = f"{mesh}/{name}/{seq}"
        lo, hi = record[key]["rows"]
        for leaf, w in want.items():
            _close(arrays[f"{key}/cache/{leaf}"], w[lo:hi], ONE_TOL, leaf)


def test_cached_forward_on_fsdp_leaves_raises(world):
    ranks, _ = world
    assert all(record["fsdp"] is True for _, record in ranks)


@pytest.mark.parametrize("m", list(DRIVER))
def test_serve_driver_on_the_model_axis(m, world):
    """Every rank prints one line a batch and ``SERVING DONE``."""
    ranks, _ = world
    runs = [record["driver"][m] for _, record in ranks]
    for rc, lines in runs:
        assert rc == 0 and lines[-1] == "SERVING DONE"
        recs = [json.loads(ln) for ln in lines[:-1]]
        assert [r["batch"] for r in recs] == [0, 1]
        assert all(r["tokens"] == DRIVER[m] * 4 for r in recs)


if __name__ == "__main__":
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
