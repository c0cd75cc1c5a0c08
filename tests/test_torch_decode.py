"""The port's LM serving path (serving/decode.py, serving/engine.py,
launch/serve.py) against the reference's (after the local-LM tests of
tests/test_serving.py).

Each family's reduced config runs with the reference's ``init_params``
draw carried across (``convert.lm_params_from_numpy``); prefill logits
within 2e-4 and decode logits within 5e-3, the reference's own
tolerances, both against the reference's steps and against the port's
full forward of the same tokens (teacher forcing).
"""
import importlib
import json
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import config as jconfig
from repro.models import model as JM
from repro.serving import decode as jdecode
from repro_torch import config, convert
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.serving import decode
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

FAMILIES = ["llama32_1b", "qwen3_1_7b", "mamba2_1_3b",
            "deepseek_v2_lite_16b", "jamba_v01_52b", "phi35_moe_42b"]
PCFG = config.ParallelConfig(compute_dtype="float32")
JPCFG = jconfig.ParallelConfig(compute_dtype="float32")
PREFILL_TOL = 2e-4
DECODE_TOL = 5e-3
GREEDY_MARGIN = 1e-4
TOPK_MARGIN = 1e-5
# the keys of the reference's line a batch (src/repro/launch/serve.py:69)
SERVE_KEYS = {"batch", "prefill_s", "decode_p50_ms", "decode_p99_ms",
              "tokens"}


def reduced(pkg, name):
    return importlib.import_module(f"{pkg}.configs.{name}").reduced()


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    cfg, jcfg = reduced("repro_torch", name), reduced("repro", name)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, jcfg, params, model


@pytest.fixture
def routing_margins(monkeypatch):
    """The smallest gap, over every routing the port's ``moe`` makes,
    between a token's k-th and (k+1)-th router probabilities."""
    seen = []

    def spy(cfg, p, xf, group=None):
        out = route(cfg, p, xf, group)
        srt = out[0].detach().sort(-1, descending=True).values
        k = cfg.moe_top_k
        if k < srt.shape[-1]:
            seen.append(float((srt[:, k - 1] - srt[:, k]).min()))
        return out
    route = moe.route
    monkeypatch.setattr(moe, "route", spy)
    return seen


def _leaves(cache):
    """{name: [each layer's array]} of a port cache, in layer order."""
    out = {}

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                if isinstance(x[k], torch.Tensor):
                    out.setdefault(k, []).append(x[k].float().numpy())
                else:
                    walk(x[k])
        elif isinstance(x, list):
            for y in x:
                walk(y)
    walk(cache)
    return out


def _jleaves(cfg, cache):
    """The same of a reference cache (repeats stacked on a leading axis
    where a segment repeats)."""
    out = {}
    for (sb, cnt), seg in zip(cfg.segments, cache["segments"]):
        for r in range(cnt):
            for i in range(len(sb)):
                for k, v in sorted(seg[f"blk{i}"].items()):
                    v = np.asarray(v)
                    out.setdefault(k, []).append(v[r] if cnt > 1 else v)
    return out


def test_decode_matches_reference_and_teacher_forcing(family,
                                                      routing_margins):
    """(MoE families: every routing's top-k margin exceeds TOPK_MARGIN,
    so a flipped expert would be a fault.)"""
    cfg, jcfg, params, model = family
    B, S = 2, 16
    half = S // 2
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    with torch.inference_mode():
        full, _, _ = M.forward(cfg, PCFG, model,
                               {"tokens": torch.tensor(toks)},
                               want_cache=False)
    logits, cache = decode.prefill(cfg, PCFG, model,
                                   {"tokens": torch.tensor(toks[:, :half])})
    jlogits, jcache = jdecode.prefill(
        jcfg, JPCFG, params, {"tokens": jnp.asarray(toks[:, :half],
                                                    jnp.int32)})
    assert logits.shape == (B, 1, cfg.vocab)
    close(logits, jlogits, PREFILL_TOL)
    close(logits[:, -1], full[:, half - 1], PREFILL_TOL)
    ours, theirs = _leaves(cache), _jleaves(jcfg, jcache)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        for a, b in zip(ours[k], theirs[k]):
            close(a, b, PREFILL_TOL)

    cache = decode.extend_cache(cache, S - half)
    jcache = jdecode.extend_cache(jcache, S - half)
    ours, theirs = _leaves(cache), _jleaves(jcfg, jcache)
    for k in ours:
        assert [a.shape for a in ours[k]] == [b.shape for b in theirs[k]]
    for pos in range(half, S):
        logits, cache = decode.decode_step(
            cfg, PCFG, model, {"tokens": torch.tensor(toks[:, pos:pos + 1])},
            cache)
        jlogits, jcache = jdecode.decode_step(
            jcfg, JPCFG, params,
            {"tokens": jnp.asarray(toks[:, pos:pos + 1], jnp.int32)}, jcache)
        close(logits, jlogits, DECODE_TOL)
        close(logits[:, 0], full[:, pos], DECODE_TOL)
    assert min(routing_margins, default=1.0) > TOPK_MARGIN
    ours, theirs = _leaves(cache), _jleaves(jcfg, jcache)
    for k in ours:
        for a, b in zip(ours[k], theirs[k]):
            close(a, b, DECODE_TOL)


def test_extend_cache_pads_attention_caches_only():
    cfg = reduced("repro_torch", "jamba_v01_52b")
    cache = M.init_cache(cfg, B=2, S=5, device="cpu")
    grown = decode.extend_cache(cache, 3)
    before, after = _leaves(cache), _leaves(grown)
    for k in before:
        for a, b in zip(before[k], after[k]):
            if k in ("k", "v"):
                assert b.shape == a.shape[:1] + (8,) + a.shape[2:]
            else:
                assert b.shape == a.shape
    mla = reduced("repro_torch", "deepseek_v2_lite_16b")
    grown = _leaves(decode.extend_cache(M.init_cache(mla, 2, 5, device="cpu"),
                                        4))
    assert {a.shape[1] for k in ("c_kv", "k_pe") for a in grown[k]} == {9}


def test_greedy_generate_matches_reference():
    """Equal tokens up to the first step whose top-2 logit margin (the
    reference's) is within GREEDY_MARGIN, and determinism."""
    cfg, jcfg = reduced("repro_torch", "llama32_1b"), \
        reduced("repro", "llama32_1b")
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    steps = 6
    out = decode.greedy_generate(cfg, PCFG, model,
                                 {"tokens": torch.tensor(prompt)}, steps)
    again = decode.greedy_generate(cfg, PCFG, model,
                                   {"tokens": torch.tensor(prompt)}, steps)
    assert out.shape == (2, steps)
    assert torch.equal(out, again)
    want = np.asarray(jdecode.greedy_generate(
        jcfg, JPCFG, params, {"tokens": jnp.asarray(prompt, jnp.int32)},
        steps))
    # the reference's margins at each step, teacher-forced on its tokens
    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    logits, _, _ = JM.forward(jcfg, JPCFG, params,
                              {"tokens": jnp.asarray(seq, jnp.int32)},
                              want_cache=False)
    top2 = -np.sort(-np.asarray(logits)[:, prompt.shape[1] - 1:], -1)[..., :2]
    margin = (top2[..., 0] - top2[..., 1]).min(0)            # per step
    n = int(np.argmax(margin <= GREEDY_MARGIN)) if \
        (margin <= GREEDY_MARGIN).any() else steps
    assert n >= steps // 2
    np.testing.assert_array_equal(out.numpy()[:, :n], want[:, :n])


def test_serve_main_prints_the_reference_lines(capsys):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--batches", "2",
            "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "SERVING DONE"
    recs = [json.loads(ln) for ln in lines[:-1]]
    assert [r["batch"] for r in recs] == [0, 1]
    for r in recs:
        assert set(r) == SERVE_KEYS
        assert r["tokens"] == 2 * 4
        assert r["prefill_s"] >= 0 and r["decode_p99_ms"] >= \
            r["decode_p50_ms"] >= 0


def test_engine_alias_warns_and_reexports():
    sys.modules.pop("repro_torch.serving.engine", None)
    with pytest.warns(DeprecationWarning, match="deprecated alias"):
        engine = importlib.import_module("repro_torch.serving.engine")
    for name in engine.__all__:
        assert getattr(engine, name) is getattr(decode, name)
    import repro_torch.serving as pkg
    assert "repro_torch.serving.decode" in pkg.__doc__


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--batches", "1"])
    cfg = reduced("repro_torch", "llama32_1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy(cfg, {})
