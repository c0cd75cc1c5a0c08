"""Gradients through the port's MoE SpMM dispatch against the reference.

``torch.autograd`` of the port's ``moe(..., dispatch="spmm")`` against
``jax.grad`` of the reference's (which differentiates its plain SpMM,
``backend="ref"``) on phi3.5-moe's reduced config, the same weights and
inputs, a loss of the output against a fixed random projection plus the
load-balancing loss: every leaf (x, router, w1, w2, w3) within GRAD_TOL.
Each case runs twice: as is (the kernels' plain versions on the CPU,
which carry a graph of their own), and with ``ops.spmm_cuda`` /
``ops.sddmm_cuda`` replaced by wrappers that compute the plain version
under ``torch.no_grad()``, as the card's ``ctypes`` launch returns a
tensor with no graph: only the dispatch's autograd Functions
(``moe._DispatchSpMM``, ``moe._CombineSpMM``) give the expert weights
and the router their gradients there, with 4 SpMM and 1 SDDMM calls.
The ``cuda``-marked twins run the same on the card against the CPU
(they import nothing of jax).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch import config
from repro_torch.kernels import ops
from repro_torch.models import layers, moe

GRAD_TOL = 2e-4
AUX_WEIGHT = 0.01
#: (capacity_factor override: None keeps the config's 8.0, 0.5 drops)
CASES = [None, 0.5]
LEAVES = ("router", "w1", "w3", "w2")
PCFG = config.ParallelConfig(compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its ops are small, and beside
    the other test workers' default thread pools (one per core each)
    they crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, cf):
    cfg = importlib.import_module(f"{pkg}.configs.phi35_moe_42b").reduced()
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def _inputs(cfg, seed=3):
    """Weights, x (2, 16, d) and the loss projection, as numpy."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    w = {"router": rng.standard_normal((d, E)) * 0.5,
         "w1": rng.standard_normal((E, d, ff)) * 0.02,
         "w3": rng.standard_normal((E, d, ff)) * 0.02,
         "w2": rng.standard_normal((E, ff, d)) * 0.02}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    proj = rng.standard_normal((2, 16, d)).astype(np.float32)
    return w, x, proj


def _port_grads(cfg, w, x, proj, device="cpu"):
    """(loss, {leaf: grad}) of the port's spmm dispatch on ``device``."""
    p = moe.MoE(layers.Init(None, torch.float32, "meta"), cfg)
    p.load_state_dict({k: torch.from_numpy(v).to(device)
                       for k, v in w.items()}, assign=True)
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    out, aux = moe.moe(cfg, PCFG, p, xt, dispatch="spmm")
    loss = (out * torch.from_numpy(proj).to(device)).sum() \
        + AUX_WEIGHT * aux["lb_loss"]
    loss.backward()
    grads = {k: getattr(p, k).grad for k in LEAVES}
    grads["x"] = xt.grad
    return loss.detach(), grads


def _reference_grads(cf, w, x, proj):
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.models import moe as jmoe
    jcfg = _cfg("repro", cf)
    jp = jconfig.ParallelConfig(compute_dtype="float32")

    def loss(p, xx):
        out, aux = jmoe.moe(jcfg, jp, p, xx, dispatch="spmm")
        return jnp.sum(out * proj) + AUX_WEIGHT * aux["lb_loss"]
    params = {k: jnp.asarray(v) for k, v in w.items()}
    xx = jnp.asarray(x)
    # compiled without LLVM's backend optimizations: the same program,
    # a third less compile time
    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1))).lower(
        params, xx).compile({"xla_backend_optimization_level": 0})(params, xx)
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["x"] = np.asarray(gx)
    return float(val), grads


def _assert_grads(got, want):
    for k in ("x",) + LEAVES:
        g = got[k]
        assert g is not None, f"{k}: no gradient"
        g = g.detach().cpu().numpy()
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


@pytest.fixture
def no_graph_kernels(monkeypatch):
    """``ops.spmm_cuda``/``sddmm_cuda`` computing the plain version under
    ``torch.no_grad()`` (a result with no graph, as the card's launch),
    counting calls."""
    calls = {"spmm": 0, "sddmm": 0}

    def wrap(name, orig):
        def call(*a, **k):
            calls[name] += 1
            with torch.no_grad():
                return orig(*a, **k)
        return call
    monkeypatch.setattr(ops, "spmm_cuda", wrap("spmm", ops.spmm_cuda))
    monkeypatch.setattr(ops, "sddmm_cuda", wrap("sddmm", ops.sddmm_cuda))
    return calls


@pytest.mark.parametrize("cf", CASES)
def test_moe_spmm_grads_match_reference(cf):
    cfg = _cfg("repro_torch", cf)
    w, x, proj = _inputs(cfg)
    loss, got = _port_grads(cfg, w, x, proj)
    jloss, want = _reference_grads(cf, w, x, proj)
    assert abs(float(loss) - jloss) <= 1e-4 * max(1.0, abs(jloss))
    _assert_grads(got, want)


@pytest.mark.parametrize("cf", CASES)
def test_moe_spmm_grads_without_kernel_graph(cf, no_graph_kernels):
    """The kernels' results carry no graph, as on the card: the
    dispatch's Functions give every leaf its gradient, 4 SpMM and 1
    SDDMM calls a forward and backward."""
    cfg = _cfg("repro_torch", cf)
    w, x, proj = _inputs(cfg)
    _, got = _port_grads(cfg, w, x, proj)
    assert no_graph_kernels == {"spmm": 4, "sddmm": 1}
    _, want = _reference_grads(cf, w, x, proj)
    _assert_grads(got, want)
    if cf is not None:
        S = 16 * 2
        _, _, _, _, keep, _, _ = moe.route(
            cfg, _loaded(cfg, w), torch.from_numpy(x).reshape(S, -1))
        assert not bool(keep.all())        # the case drops assignments


def _loaded(cfg, w):
    p = moe.MoE(layers.Init(None, torch.float32, "meta"), cfg)
    p.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()},
                      assign=True)
    return p


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(the kernels build with nvcc at first use)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cf", CASES)
def test_cuda_moe_spmm_grads_match_cpu(cuda, cf):
    """The Hopper SpMM and SDDMM under the dispatch's Functions: every
    leaf's gradient on the card against the plain versions on the CPU,
    4 SpMM and 1 SDDMM launches."""
    cfg = _cfg("repro_torch", cf)
    w, x, proj = _inputs(cfg)
    ops.reset_launch_counts()
    _, got = _port_grads(cfg, w, x, proj, device=cuda)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["spmm"] == 4 and counts["sddmm"] == 1, counts
    _, want = _port_grads(cfg, w, x, proj)
    _assert_grads(got, {k: v.numpy() for k, v in want.items()})
