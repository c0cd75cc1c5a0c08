"""The port's lossy wire formats (``repro_torch.training.compression``)
against the reference's ``repro.training.compression``, after
tests/test_training.py: each function on the same numpy input, the bf16
casts, the int8 codes and scales and the error-feedback sequences equal
bit for bit; ``compressed_psum`` on the stacked backend against the
reference's under ``jax.vmap`` (its psum over the mapped axis), and on
4 gloo ranks (this file run as a script, one process a rank) against the
stacked run, bit for bit.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_spawn import join, save, spawn  # noqa: E402

WORLD = 4
#: (c, axis) of the 4-rank grids compressed_psum sums over
PSUM_GRIDS = [(1, "layer"), (2, "layer"), (2, "fiber")]
PSUM_SHAPES = [(300,), (17, 33)]
STEPS = 3


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


def _ref():
    import jax
    import jax.numpy as jnp
    from repro.training import compression as jc
    return jax, jnp, jc


def _np(t):
    return t.detach().cpu().numpy()


def _bits(a):
    """float32 values as their bits (bf16 -> float32 is exact)."""
    return np.asarray(a, np.float32).view(np.int32)


def test_bf16_roundtrip_matches_reference_bitwise():
    import torch
    from repro_torch.training import compression as tc
    jax, jnp, jc = _ref()
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(512) * 10.0 ** rng.integers(
        -6, 6, 512), [0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8,
                      3.4e38, -1e-40]]).astype(np.float32)
    w = tc.to_bf16(torch.from_numpy(x))
    assert w.dtype == torch.bfloat16
    back = tc.from_bf16(w)
    assert back.dtype == torch.float32
    want = np.asarray(jc.from_bf16(jc.to_bf16(jnp.asarray(x))))
    np.testing.assert_array_equal(_bits(_np(back)), _bits(want))
    np.testing.assert_allclose(_np(back)[:512], x[:512], rtol=8e-3, atol=0)


@pytest.mark.parametrize("shape", [(17,), (64, 33), (3, 5, 7), (256,),
                                   (2, 512)])
def test_quantize_int8_matches_reference_bitwise(shape):
    import torch
    from repro_torch.training import compression as tc
    jax, jnp, jc = _ref()
    rng = np.random.default_rng(1)
    g = rng.standard_normal(shape).astype(np.float32)
    g.reshape(-1)[:min(g.size, 256)] *= 0.0      # an all-zero block
    g.reshape(-1)[-1] = 0.5                      # a tie of round-half-even
    q, s, meta = tc.quantize_int8(torch.from_numpy(g))
    jq, js, jmeta = jc.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_bits(_np(s)), _bits(js))
    assert meta == (tuple(jmeta[0]), jmeta[1])
    deq = tc.dequantize_int8(q, s, meta)
    assert tuple(deq.shape) == shape
    np.testing.assert_array_equal(
        _bits(_np(deq)), _bits(jc.dequantize_int8(jq, js, jmeta)))
    assert np.abs(_np(deq) - g).max() <= np.abs(g).max() / 127 + 1e-6


def test_int8_error_feedback_sequence_matches_reference():
    """Quantize with feedback for 50 steps: every step's dequantized
    payload and residual equal the reference's bit for bit, and the
    accumulated updates track the true sum."""
    import torch
    from repro_torch.training import compression as tc
    jax, jnp, jc = _ref()
    g_np = (np.random.default_rng(0).standard_normal(1024) * 1e-3) \
        .astype(np.float32)
    g, jg = torch.from_numpy(g_np), jnp.asarray(g_np)
    err, jerr = torch.zeros_like(g), jnp.zeros_like(jg)
    acc = np.zeros(1024)
    for _ in range(50):
        deq = tc.dequantize_int8(*tc.quantize_int8(g + err))
        jdeq = jc.dequantize_int8(*jc.quantize_int8(jg + jerr))
        err, jerr = (g + err) - deq, (jg + jerr) - jdeq
        np.testing.assert_array_equal(_bits(_np(deq)), _bits(jdeq))
        np.testing.assert_array_equal(_bits(_np(err)), _bits(jerr))
        acc += _np(deq)
    np.testing.assert_allclose(acc, 50 * g_np, rtol=0.02, atol=2e-4)


def test_bf16_error_feedback_matches_reference_and_beats_raw_casting():
    import torch
    from repro_torch.training import compression as tc
    jax, jnp, jc = _ref()
    g_np = np.linspace(1e-3, 1.0, 1000).astype(np.float32)
    h_np = np.random.default_rng(2).standard_normal((4, 5)) \
        .astype(np.float32)
    ef, jef = tc.ErrorFeedback(), jc.ErrorFeedback()
    tree = {"g": torch.from_numpy(g_np), "hs": (torch.from_numpy(h_np),)}
    jtree = {"g": jnp.asarray(g_np), "hs": (jnp.asarray(h_np),)}
    acc_fb = np.zeros(1000)
    acc_raw = np.zeros(1000)
    for _ in range(50):
        seen, jseen = ef(tree), jef(jtree)
        np.testing.assert_array_equal(_bits(_np(seen["g"])),
                                      _bits(jseen["g"]))
        np.testing.assert_array_equal(_bits(_np(seen["hs"][0])),
                                      _bits(jseen["hs"][0]))
        np.testing.assert_array_equal(_bits(_np(ef.residual["g"])),
                                      _bits(jef.residual["g"]))
        acc_fb += _np(seen["g"]).astype(np.float64)
        acc_raw += _np(tc.from_bf16(tc.to_bf16(tree["g"]))).astype(
            np.float64)
    assert isinstance(ef.residual["hs"], tuple)
    assert ef.residual["g"].device == tree["g"].device
    exact = 50 * g_np.astype(np.float64)
    err_fb = np.abs(acc_fb - exact).max()
    err_raw = np.abs(acc_raw - exact).max()
    assert err_fb < 0.1 * err_raw, (err_fb, err_raw)


def _psum_inputs(shape, step):
    """The WORLD ranks' gradients of one step, stacked in rank order."""
    rng = np.random.default_rng(100 + step)
    return (rng.standard_normal((WORLD, *shape)) * 1e-2).astype(np.float32)


def _stacked_psum(c, axis, shape):
    """compressed_psum on the stacked 4-rank (4/c, c) grid over
    ``axis``, STEPS steps with error feedback: per step (sums, errors),
    stacked (p, ...) in rank order."""
    import torch
    from repro_torch.core.collectives import Stacked
    from repro_torch.core.grid import make_grid15
    from repro_torch.training import compression as tc
    grid = make_grid15(c, devices=[torch.device("cpu")] * WORLD)
    coll = Stacked(grid)
    errors, out = None, []
    for step in range(STEPS):
        g = torch.from_numpy(_psum_inputs(shape, step)).reshape(
            *grid.shape, *shape)
        (s,), errors = tc.compressed_psum((g,), coll, axis,
                                          None if errors is None else errors)
        out.append((_np(s).reshape(WORLD, *shape),
                    _np(errors[0]).reshape(WORLD, *shape)))
    assert len(coll.log) == STEPS * (grid.shape[grid.dim(axis)] - 1)
    return out


@pytest.mark.parametrize("c,axis", PSUM_GRIDS)
@pytest.mark.parametrize("shape", PSUM_SHAPES)
def test_compressed_psum_stacked_matches_reference(c, axis, shape):
    """Stacked compressed_psum, step by step with error feedback: each
    rank's errors equal the reference's quantization of the same
    corrected gradient bit for bit, the sums are the rank-order sums of
    the reference's dequantized payloads bit for bit, and the
    reference's own compressed_psum (a psum over a ``jax.vmap`` axis)
    within float32 rounding."""
    jax, jnp, jc = _ref()
    L = WORLD // c
    d = 0 if axis == "layer" else 1
    e_prev = np.zeros((WORLD, *shape), np.float32)
    for step, (sums, errs) in enumerate(_stacked_psum(c, axis, shape)):
        g = _psum_inputs(shape, step)
        corrected = g + e_prev
        deq = np.stack([np.asarray(jc.dequantize_int8(*jc.quantize_int8(
            jnp.asarray(x)))) for x in corrected])
        want_e = corrected - deq
        np.testing.assert_array_equal(_bits(errs), _bits(want_e))
        # rank-order sums over the axis, every rank holding its group's
        grouped = np.moveaxis(deq.reshape(L, c, *shape), d, 0)
        total = grouped[0]
        for k in range(1, grouped.shape[0]):
            total = total + grouped[k]
        want = np.moveaxis(np.broadcast_to(total, grouped.shape), 0, d)
        np.testing.assert_array_equal(
            _bits(sums), _bits(want.reshape(WORLD, *shape)))
        # the reference's compressed_psum, the summed axis vmapped
        gm = np.moveaxis(g.reshape(L, c, *shape), d, 0)
        em = np.moveaxis(e_prev.reshape(L, c, *shape), d, 0)
        js, je = jax.vmap(jax.vmap(
            lambda a, b: jc.compressed_psum(a, "i", b), axis_name="i"),
            in_axes=1, out_axes=1)(jnp.asarray(gm), jnp.asarray(em))
        np.testing.assert_array_equal(
            _bits(errs), _bits(np.moveaxis(np.asarray(je), 0, d)
                               .reshape(WORLD, *shape)))
        np.testing.assert_allclose(
            sums, np.moveaxis(np.asarray(js), 0, d).reshape(WORLD, *shape),
            rtol=1e-6, atol=1e-9)
        e_prev = want_e


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------

def _worker(rank, world, init, out_dir):
    import torch
    dist = join(rank, world, init)
    from repro_torch.core.collectives import Dist
    from repro_torch.core.grid import make_grid15
    from repro_torch.training import compression as tc
    arrays = {}
    try:
        for c, axis in PSUM_GRIDS:
            grid = make_grid15(c, devices=[torch.device("cpu")] * world,
                               group=dist.group.WORLD)
            for shape in PSUM_SHAPES:
                errors = None
                for step in range(STEPS):
                    g = torch.from_numpy(_psum_inputs(shape, step)[rank])
                    g = g.reshape(*grid.local_shape, *shape)
                    coll = Dist(grid)
                    (s,), errors = tc.compressed_psum([g], coll, axis,
                                                      errors)
                    tag = f"{c}/{axis}/{shape}/{step}"
                    arrays[tag + "/sum"] = _np(s).reshape(shape)
                    arrays[tag + "/err"] = _np(errors[0]).reshape(shape)
    finally:
        dist.destroy_process_group()
    save(out_dir, rank, arrays, {"rank": rank})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(__file__, WORLD, str(tmp_path_factory.mktemp("psum")))


@pytest.mark.parametrize("c,axis", PSUM_GRIDS)
def test_compressed_psum_gloo_equals_stacked_bitwise(ranks, c, axis):
    for shape in PSUM_SHAPES:
        want = _stacked_psum(c, axis, shape)
        for rank, (got, _) in enumerate(ranks):
            for step, (sums, errs) in enumerate(want):
                tag = f"{c}/{axis}/{shape}/{step}"
                np.testing.assert_array_equal(
                    _bits(got[tag + "/sum"]), _bits(sums[rank]), tag)
                np.testing.assert_array_equal(
                    _bits(got[tag + "/err"]), _bits(errs[rank]), tag)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5])
