"""The port's LM zoo (config, configs, models/) against the reference's.

Every registered config must equal the reference's field for field,
with the same analytic parameter counts.  The layers, attention, SSD
and MoE functions run on the same seeded numpy inputs in both packages;
each architecture's reduced config runs one forward with the
reference's ``init_params`` draw carried across
(``convert.lm_params_from_numpy``: a ``jax.random`` draw cannot be
reproduced by a ``torch.Generator``).  Float32 logits within 1e-4 and
``aux`` within 1e-5; bfloat16 (dense configs only: MoE routing under
bfloat16 is too sensitive to hold across frameworks) within BF16_TOL.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import config as jconfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch import config, convert
from repro_torch.kernels import _build
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models import model as M
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

ARCH_MODULES = [
    "jamba_v01_52b", "stablelm_1_6b", "llama32_1b", "qwen3_1_7b",
    "qwen3_4b", "qwen2_vl_72b", "mamba2_1_3b", "deepseek_v2_lite_16b",
    "phi35_moe_42b", "hubert_xlarge",
]
PCFG = config.ParallelConfig(compute_dtype="float32")
JPCFG = jconfig.ParallelConfig(compute_dtype="float32")
F32_TOL = 1e-4
AUX_TOL = 1e-5
# bfloat16 logits: both packages round every matmul output and residual
# to bfloat16 in their own order, so they differ by about as much as
# either differs from its float32 run (5-9e-3 at these widths, |logits|
# up to 1.5)
BF16_TOL = 1e-2
TOPK_MARGIN = 1e-5


def reduced(pkg, name):
    return importlib.import_module(f"{pkg}.configs.{name}").reduced()


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def make_batch(cfg, B=2, S=32, seed=0):
    """(reference batch, port batch) of the same numpy draw."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        tok = rng.integers(0, cfg.vocab, (B, S))
        return ({"tokens": jnp.asarray(tok, jnp.int32)},
                {"tokens": t(tok)})
    e = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jb, tb = {"embeds": jnp.asarray(e)}, {"embeds": t(e)}
    if cfg.pos_dims == 3:
        pos = rng.integers(0, S, (B, S, 3))
        jb["positions"], tb["positions"] = jnp.asarray(pos, jnp.int32), t(pos)
    return jb, tb


def state_of(tree, prefix=""):
    """A reference parameter dict as a flat torch state dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(state_of(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = t(v)
    return out


def port_model(cfg, params):
    return convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_registry_lists_the_same_configs():
    assert config.list_configs() == jconfig.list_configs()
    from repro.configs import ARCH_IDS as J_IDS
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == J_IDS


@pytest.mark.parametrize("name", jconfig.list_configs())
def test_config_equals_reference(name):
    cfg, want = config.get_config(name), jconfig.get_config(name)
    assert _fields(cfg) == _fields(want)
    assert (cfg.hd, cfg.n_layers, cfg.d_inner, cfg.ssm_heads) == \
        (want.hd, want.n_layers, want.d_inner, want.ssm_heads)
    assert cfg.param_count() == want.param_count()
    assert cfg.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("name", ARCH_MODULES)
def test_reduced_config_equals_reference(name):
    cfg, want = reduced("repro_torch", name), reduced("repro", name)
    assert _fields(cfg) == _fields(want)
    assert cfg.param_count() == want.param_count()
    assert cfg.active_param_count() == want.active_param_count()


def test_other_configs_equal_reference():
    from repro.configs import paper_gnn as jgnn
    from repro_torch.configs import paper_gnn as gnn
    assert _fields(gnn.GNNConfig()) == _fields(jgnn.GNNConfig())
    assert _fields(gnn.ALSConfig()) == _fields(jgnn.ALSConfig())
    for cls in ("ParallelConfig", "TrainConfig", "ServeConfig"):
        assert _fields(getattr(config, cls)()) == \
            _fields(getattr(jconfig, cls)())


# ---------------------------------------------------------------------------
# layers, attention, SSD
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    s = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    close(layers.rms_norm(t(x), t(s), 1e-5),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5), 1e-6)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = layers.rms_norm(t(x).to(torch.bfloat16), t(s), 1e-5)
    assert got.dtype == torch.bfloat16
    close(got.float(), jlayers.rms_norm(xb, jnp.asarray(s)), 1e-2)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 7))
    close(layers.apply_rope(t(x), t(pos), theta),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)


def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 30, (2, 6, 3))
    sections = (6, 5, 5)
    close(layers.apply_mrope(t(x), t(pos), 1e4, sections),
          jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                              sections), 1e-5)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(3)
    x, w1, w3, w2 = (rng.standard_normal(s).astype(np.float32) * 0.3
                     for s in ((2, 5, 16), (16, 24), (16, 24), (24, 16)))
    close(layers.swiglu(t(x), t(w1), t(w3), t(w2)),
          jlayers.swiglu(*map(jnp.asarray, (x, w1, w3, w2))), 1e-5)


@pytest.mark.parametrize("causal,block,hd_v", [(True, 16, 16),
                                               (False, 16, 16),
                                               (True, 64, 24),
                                               (True, 48, 16)])
def test_flash_attention_matches_reference(causal, block, hd_v):
    rng = np.random.default_rng(4)
    B, S, H, Kv, hd = 2, 64, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, hd_v)).astype(np.float32)
    got = attention.flash_attention(t(q), t(k), t(v), causal=causal,
                                    block=block)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                 causal=causal, block=block)
    assert got.shape == (B, S, H, hd_v)
    close(got, want, 2e-5)


def test_flash_attention_kv_len_and_refusal():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    kv_len = np.array([5, 12])
    got = attention.flash_attention(t(q), t(k), t(v), causal=False, block=4,
                                    q_offset=9, kv_len=t(kv_len))
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                 block=4, q_offset=9,
                                 kv_len=jnp.asarray(kv_len))
    close(got, want, 2e-5)
    # 25 keys in blocks of 16: one block of 25; 35 keys: 2 blocks of 17
    # leave one key out, which the reference's reshape refuses too
    k5 = rng.standard_normal((2, 35, 4, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        attention.flash_attention(t(q), t(k5), t(k5), causal=False,
                                  block=16)
    with pytest.raises(TypeError):
        jattn.flash_attention(*map(jnp.asarray, (q, k5, k5)), causal=False,
                              block=16)


def test_plain_decode_attention_matches_reference():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 1, 6, 8)).astype(np.float32)
    k = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 12)).astype(np.float32)
    kv_len = np.array([1, 4, 10])
    close(attention.plain_decode_attention(t(q), t(k), t(v), t(kv_len)),
          jattn.plain_decode_attention(*map(jnp.asarray,
                                            (q, k, v, kv_len))), 2e-5)


def _ssd_inputs(seed=0, B=2, S=64, H=3, P=8, N=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.05, 0.3, (B, S, H)).astype(np.float32),
            -rng.uniform(0.3, 1.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    x, dt, A, Bm, Cm = _ssd_inputs()
    y, fin = ssm._ssd_chunked(*map(t, (x, dt, A, Bm, Cm)), chunk)
    jy, jfin = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                 chunk)
    close(y, jy, 2e-5)
    close(fin, jfin, 2e-5)
    # the O(1) decode recurrence, step by step, from the zero state
    s = np.zeros(fin.shape, np.float64)
    ys = []
    for i in range(x.shape[1]):
        s = s * np.exp(dt[:, i] * A[None])[:, :, None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, i], Bm[:, i], x[:, i])
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, i], s))
    close(y, np.stack(ys, 1), 2e-4)
    close(fin, s, 2e-4)
    with pytest.raises(ValueError):
        ssm._ssd_chunked(*map(t, (x, dt, A, Bm, Cm)), 48)


def test_mamba2_decode_recurrence_matches_reference():
    """One prefill of 8 tokens, then 3 O(1) decode steps, both packages."""
    cfg = reduced("repro_torch", "mamba2_1_3b")
    jcfg = reduced("repro", "mamba2_1_3b")
    p = jssm.init_mamba2(jax.random.PRNGKey(3), jcfg)
    tp = ssm.Mamba2(layers.Init(None, torch.float32, "meta"), cfg)
    tp.load_state_dict(state_of(p), assign=True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32) * 0.5
    with torch.inference_mode():
        out, c = ssm.mamba2(cfg, PCFG, tp, t(x[:, :8]), {})
        jout, jc = jssm.mamba2(jcfg, JPCFG, p, jnp.asarray(x[:, :8]), {})
        close(out, jout, 1e-5)
        for i in range(8, 11):
            out, c = ssm.mamba2(cfg, PCFG, tp, t(x[:, i:i + 1]), {}, c)
            jout, jc = jssm.mamba2(jcfg, JPCFG, p, jnp.asarray(x[:, i:i + 1]),
                                   {}, jc)
            close(out, jout, 1e-5)
            close(c["ssm"], jc["ssm"], 1e-5)
            close(c["conv"], jc["conv"], 1e-6)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = [("phi35_moe_42b", 16), ("deepseek_v2_lite_16b", 16),
             ("jamba_v01_52b", 12)]


def _moe_setup(name, S, seed=3):
    cfg, jcfg = reduced("repro_torch", name), reduced("repro", name)
    p = jmoe.init_moe(jax.random.PRNGKey(2), jcfg)
    tp = moe.MoE(layers.Init(None, torch.float32, "meta"), cfg)
    tp.load_state_dict(state_of(p), assign=True)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, tp, x


def _assert_topk_margin(k, probs):
    """The k-th and (k+1)-th router probabilities of every token differ
    by more than TOPK_MARGIN, so a flipped choice would be a fault."""
    srt = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    if k < srt.shape[-1]:
        assert (srt[:, k - 1] - srt[:, k]).min() > TOPK_MARGIN


@pytest.fixture
def routings(monkeypatch):
    """Every routing the port's ``moe`` makes: (cfg, probs, keep)."""
    seen = []

    def spy(cfg, p, xf, group=None):
        out = route(cfg, p, xf, group)
        seen.append((cfg, out[0].detach(), out[4]))
        return out
    route = moe.route
    monkeypatch.setattr(moe, "route", spy)
    return seen


@pytest.mark.parametrize("name,S", MOE_CASES)
@pytest.mark.parametrize("dispatch", ["einsum", "spmm"])
def test_moe_matches_reference(name, S, dispatch, routings):
    cfg, jcfg, p, tp, x = _moe_setup(name, S)
    with torch.inference_mode():
        out, aux = moe.moe(cfg, PCFG, tp, t(x), dispatch=dispatch)
    jout, jaux = jmoe.moe(jcfg, JPCFG, p, jnp.asarray(x), dispatch=dispatch)
    _assert_topk_margin(cfg.moe_top_k, routings[0][1])
    close(out, jout, 2e-5)
    close(aux["lb_loss"], jaux["lb_loss"], AUX_TOL)


def test_moe_capacity_drops_match_reference(routings):
    """A capacity factor that drops assignments: dropped ones add nothing
    in either dispatch, as in the reference."""
    cfg, jcfg, p, tp, x = _moe_setup("phi35_moe_42b", 16)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    with torch.inference_mode():
        e, _ = moe.moe(cfg, PCFG, tp, t(x), dispatch="einsum")
        s, _ = moe.moe(cfg, PCFG, tp, t(x), dispatch="spmm")
    je, _ = jmoe.moe(jcfg, JPCFG, p, jnp.asarray(x), dispatch="einsum")
    js, _ = jmoe.moe(jcfg, JPCFG, p, jnp.asarray(x), dispatch="spmm")
    assert not bool(routings[0][2].all())          # some were dropped
    _assert_topk_margin(cfg.moe_top_k, routings[0][1])
    close(e, je, 2e-5)
    close(s, js, 2e-5)
    close(s, e, 2e-4)


@pytest.mark.parametrize("name,S", MOE_CASES)
def test_moe_spmm_equals_einsum(name, S):
    """The SpMM dispatch (the kernels' plain version on the CPU) equals
    the einsum dispatch, as tests/test_models.py holds the reference."""
    cfg, _, _, tp, x = _moe_setup(name, S)
    with torch.inference_mode():
        e, _ = moe.moe(cfg, PCFG, tp, t(x), dispatch="einsum")
        s, _ = moe.moe(cfg, PCFG, tp, t(x), dispatch="spmm")
    close(s, e, 2e-4)
    with pytest.raises(ValueError):
        moe.moe(cfg, PCFG, tp, t(x), dispatch="dense")


@pytest.mark.parametrize("T,k,E,C", [(2048, 6, 64, 240), (10, 2, 4, 3),
                                     (64, 6, 64, 7)])
def test_moe_packs_are_the_dispatch_and_combine(T, k, E, C):
    """The packs hold D[slot, t] = 1 and G[t, slot] = gate for the kept
    assignments, windows of MOE_ROW_TILE rows, and at DeepSeek's width
    the SpMM kernel takes them in its bulk form."""
    rng = np.random.default_rng(8)
    gate_i = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    flat = np.eye(E, dtype=np.int64)[gate_i].reshape(T * k, E)
    rank = ((np.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(T, k)
    keep = rank < C
    slot = gate_i * C + np.minimum(rank, C - 1)
    gates = rng.uniform(0.1, 1, (T, k)).astype(np.float32) * keep
    D = moe.dispatch_pack(t(slot), t(keep), T, E * C, torch.float32)
    G = moe.combine_pack(t(slot), t(gates), E * C)
    rt = moe.MOE_ROW_TILE
    assert D.row_tile == G.row_tile == rt
    assert D.shape[0] % rt == 0 and G.shape[0] % rt == 0
    want_d = np.zeros((E * C, T), np.float32)
    want_g = np.zeros((T, E * C), np.float32)
    for ti in range(T):
        for j in range(k):
            if keep[ti, j]:
                want_d[slot[ti, j], ti] = 1
            want_g[ti, slot[ti, j]] += gates[ti, j]
    np.testing.assert_array_equal(D.to_dense()[:E * C].numpy(), want_d)
    np.testing.assert_array_equal(G.to_dense()[:T].numpy(), want_g)
    for S in (D, G):
        assert (S.tile_base.numpy() == np.arange(S.nblocks) * rt).all()
        assert int(S.rows_local.max()) < rt
    if T == 2048:
        d = 2048
        for S, n in ((D, T), (G, E * C)):
            B = torch.zeros((n, d))
            _build.validate("spmm", S.tile_base, S.rows_local, S.cols,
                            S.vals, [B], row_tile=rt, m=S.shape[0],
                            r_tile=d, blocks_per_step=1)
            assert _build.choose_form(
                "spmm", r=d, k=S.nz_block, row_tile=rt,
                dense_dtype=B.dtype, vals_dtype=S.vals.dtype,
                addresses=[0]) == "bulk"


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCH_MODULES)
def arch(request):
    """(cfg, jcfg, reference params, port model) of one architecture."""
    name = request.param
    cfg, jcfg = reduced("repro_torch", name), reduced("repro", name)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return name, cfg, jcfg, params, port_model(cfg, params)


def test_forward_matches_reference(arch, routings):
    name, cfg, jcfg, params, model = arch
    jb, tb = make_batch(cfg)
    with torch.inference_mode():
        logits, cache, aux = M.forward(cfg, PCFG, model, tb,
                                       want_cache=False)
    jl, _, jaux = JM.forward(jcfg, JPCFG, params, jb, want_cache=False)
    assert cache is None
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 32, cfg.vocab)
    for _, probs, _ in routings:
        _assert_topk_margin(cfg.moe_top_k, probs)
    assert len(routings) == sum(n * sum(s.ffn == "moe" for s in sb)
                                for sb, n in cfg.segments)
    close(logits, jl, F32_TOL)
    close(aux, jaux, AUX_TOL)
    with torch.inference_mode():
        hidden, c2, _ = M.forward(cfg, PCFG, model, tb, return_hidden=True)
    assert hidden.shape == (2, 32, cfg.d_model)
    assert len(c2["segments"]) == len(cfg.segments)
    assert [len(s) for s in c2["segments"]] == [n for _, n in cfg.segments]


def test_param_count_matches_model(arch):
    """The port's model holds as many parameters as the reference's tree;
    the analytic count holds them all where the reference's own test
    (test_param_count_matches_init) checks it (it leaves out qk_norm)."""
    name, cfg, _, params, model = arch
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(params))
    if name in ("llama32_1b", "mamba2_1_3b", "deepseek_v2_lite_16b",
                "jamba_v01_52b"):
        assert n == cfg.param_count()


@pytest.mark.parametrize("name", ["llama32_1b", "qwen3_1_7b"])
def test_forward_bf16_matches_reference(name):
    cfg, jcfg = reduced("repro_torch", name), reduced("repro", name)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = port_model(cfg, params)
    jb, tb = make_batch(cfg, S=16)
    pcfg = config.ParallelConfig(compute_dtype="bfloat16")
    with torch.inference_mode():
        logits, _, _ = M.forward(cfg, pcfg, model, tb, want_cache=False)
    jl, _, _ = JM.forward(jcfg, jconfig.ParallelConfig(), params, jb,
                          want_cache=False)
    assert logits.dtype == torch.float32
    close(logits, jl, BF16_TOL)


def test_init_params_shapes_scales_and_device():
    cfg = reduced("repro_torch", "jamba_v01_52b")
    g = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, g, device="cpu")
    jparams = JM.init_params(reduced("repro", "jamba_v01_52b"),
                             jax.random.PRNGKey(0))
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    carried = {k: tuple(v.shape) for k, v in
               port_model(cfg, jparams).state_dict().items()}
    assert ours == carried
    blk = model.segments[0][0]
    np.testing.assert_array_equal(blk.blk0.mamba.A_log.detach(), 0)
    np.testing.assert_array_equal(blk.blk0.mamba.D.detach(), 1)
    np.testing.assert_array_equal(blk.blk0.mamba.dt_bias.detach(), -2)
    np.testing.assert_array_equal(blk.blk0.norm1.detach(), 1)
    assert abs(float(model.embed.detach().std()) - 0.02) < 2e-3
    assert abs(float(blk.blk0.mamba.conv_w.detach().std()) - 0.2) < 3e-2
    again = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert torch.equal(again.embed, model.embed)
    bf = M.init_params(cfg, torch.Generator().manual_seed(0), "bfloat16",
                       device="cpu")
    assert bf.embed.dtype == torch.bfloat16


def test_converter_refuses_missing_extra_and_misshapen_leaves():
    cfg, jcfg = reduced("repro_torch", "llama32_1b"), \
        reduced("repro", "llama32_1b")
    params = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    missing = dict(params)
    del missing["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        convert.lm_params_from_numpy(cfg, missing, device="cpu")
    extra = dict(params, head=np.zeros((cfg.d_model, cfg.vocab),
                                       np.float32))
    with pytest.raises(KeyError, match="head"):
        convert.lm_params_from_numpy(cfg, extra, device="cpu")
    seg = jax.tree.map(lambda a: a, params["segments"][0])
    seg["blk0"]["attn"]["wq"] = seg["blk0"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        convert.lm_params_from_numpy(
            cfg, dict(params, segments=[seg]), device="cpu")
    unstacked = jax.tree.map(lambda a: a[0], params["segments"][0])
    with pytest.raises(ValueError, match="repeats"):
        convert.lm_params_from_numpy(
            cfg, dict(params, segments=[unstacked]), device="cpu")
    bf = convert.lm_params_from_numpy(cfg, params, device="cpu",
                                      dtype=torch.bfloat16)
    assert bf.embed.dtype == torch.bfloat16
