"""Port's local kernels vs the reference's Pallas kernels (interpret mode).

Both frameworks get the same pack (``repro.core.sparse.pack_row_tiled``
carried across with ``repro_torch.convert``) and the same numpy-seeded
dense operands, in float32 and bf16, with tests/test_kernels.py's
tolerances.  On the CPU the port's wrappers run their plain versions;
the CUDA kernels themselves are held to those plain versions by the
tests marked ``cuda`` below, which skip without a card, and by
``chip_smoke.py`` on the H100.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import sparse as jsparse
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fusedmm import fusedmm_cuda, fusedmm_plain
from repro_torch.kernels.sddmm import sddmm_cuda, sddmm_plain
from repro_torch.kernels.spmm import spmm_cuda, spmm_plain
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

CPU = torch.device("cpu")
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]

SHAPES = [  # tests/test_kernels.py
    (128, 128, 64, 4),
    (256, 128, 128, 8),
    (512, 384, 128, 8),
    (384, 512, 256, 2),
    (128, 640, 32, 16),
]
TILINGS = [(128, 1), (64, 1), (32, 2), (32, 4)]


def _both(m, n, r, k, seed, jdt, tdt, row_tile=128, nz_block=64, group=1):
    """One pack and dense operands in both frameworks."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = jsparse.erdos_renyi(m, n, k, seed=seed)
    S = jsparse.pack_row_tiled(rows, cols, vals, (m, n), row_tile=row_tile,
                               nz_block=nz_block, group=group)
    A = rng.standard_normal((m, r)).astype(np.float32)
    B = rng.standard_normal((n, r)).astype(np.float32)
    jA, jB = jnp.asarray(A, jdt), jnp.asarray(B, jdt)
    tA = torch.from_numpy(np.array(jA.astype(jnp.float32))).to(tdt)
    tB = torch.from_numpy(np.array(jB.astype(jnp.float32))).to(tdt)
    return (S, jA, jB), (convert.row_tiled_from_numpy(S, device=CPU), tA,
                         tB)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("m,n,r,k", SHAPES)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_sddmm_spmm_match_pallas(m, n, r, k, jdt, tdt):
    (S, jA, jB), (T, tA, tB) = _both(m, n, r, k, m + r, jdt, tdt)
    f32 = tdt == torch.float32
    got = ops.sddmm(tA, tB, T).vals
    want = jops.sddmm(jA, jB, S).vals
    assert got.dtype == torch.float32          # vals dtype (the pack's)
    tol = 2e-5 if f32 else 0.12 * np.sqrt(r) / 8
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    got = ops.spmm(T, tB)
    want = jops.spmm(S, jB)
    assert got.dtype == tdt and tuple(got.shape) == (m, r)
    tol = 2e-4 if f32 else 0.15
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,n,r,k", SHAPES[:3])
def test_fusedmm_matches_pallas_and_composition(m, n, r, k):
    (S, jA, jB), (T, tA, tB) = _both(m, n, r, k, 3 * m + r, jnp.float32,
                                     torch.float32)
    out, R = ops.fusedmm(tA, tB, T)
    jout, jR = jops.fusedmm(jA, jB, S)
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(R.vals.numpy(), _np(jR.vals), rtol=2e-5,
                               atol=2e-5)
    # fused == explicit SDDMM then SpMM, within the port
    R2 = ops.sddmm(tA, tB, T)
    np.testing.assert_array_equal(R.vals.numpy(), R2.vals.numpy())
    np.testing.assert_allclose(out.numpy(), ops.spmm(R2, tB).numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("r_tile,bps", TILINGS)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_tiling_knobs_match_pallas(r_tile, bps, jdt, tdt):
    """Every tiling, including the reference's two-phase fused kernel
    (r_tile < r), against the port's wrappers given the same knobs."""
    (S, jA, jB), (T, tA, tB) = _both(256, 192, 128, 6, 11, jdt, tdt,
                                     row_tile=64, nz_block=32, group=4)
    f32 = tdt == torch.float32
    kw = dict(r_tile=r_tile, blocks_per_step=bps)
    tol = 2e-4 if f32 else 0.12 * np.sqrt(128) / 8
    np.testing.assert_allclose(_np(ops.sddmm(tA, tB, T, **kw).vals),
                               _np(jops.sddmm(jA, jB, S, **kw).vals),
                               rtol=tol, atol=tol)
    tol = 2e-4 if f32 else 0.2
    np.testing.assert_allclose(_np(ops.spmm(T, tB, **kw)),
                               _np(jops.spmm(S, jB, **kw)),
                               rtol=tol, atol=tol)
    tol = 2e-3 if f32 else 0.5
    out, R = ops.fusedmm(tA, tB, T, **kw)
    jout, jR = jops.fusedmm(jA, jB, S, **kw)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(R.vals), _np(jR.vals), rtol=tol,
                               atol=tol)


def test_ref_backend_matches_reference_ref():
    (S, jA, jB), (T, tA, tB) = _both(256, 192, 64, 5, 21, jnp.float32,
                                     torch.float32, row_tile=32,
                                     nz_block=32)
    from repro.kernels import ref as jref
    np.testing.assert_allclose(
        ops.sddmm(tA, tB, T, backend="ref").vals.numpy(),
        _np(jref.sddmm(jA, jB, S).vals), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ops.spmm(T, tB, backend="ref").numpy(),
                               _np(jref.spmm(S, jB)), rtol=2e-4, atol=2e-4)
    out, R = ops.fusedmm(tA, tB, T, m=256, backend="ref")
    jout, jR = jref.fusedmm(jA, jB, S, m=256)
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(R.vals.numpy(), _np(jR.vals), rtol=2e-5,
                               atol=2e-5)


def test_chunked_plain_version_is_exact_on_cpu(monkeypatch):
    """The plain versions cut the work into chunks; on the CPU the sums
    keep entry order, so a tiny chunk changes no bit."""
    (_, _, _), (T, tA, tB) = _both(256, 192, 64, 6, 5, jnp.float32,
                                   torch.float32, row_tile=32, nz_block=32)
    whole = ops.fusedmm(tA, tB, T, backend="ref")
    monkeypatch.setattr(ref, "CHUNK", 37)
    cut = ops.fusedmm(tA, tB, T, backend="ref")
    assert torch.equal(whole[0], cut[0])
    assert torch.equal(whole[1].vals, cut[1].vals)


def test_spmm_transpose_pack_and_empty_windows():
    m, n, r = 256, 384, 64
    rng = np.random.default_rng(7)
    rows, cols, vals = tsparse.erdos_renyi(m, n, 6, seed=7)
    St = tsparse.pack_row_tiled(cols, rows, vals, (n, m), row_tile=128,
                                nz_block=64, device=CPU)
    A = rng.standard_normal((m, r)).astype(np.float32)
    Sd = np.zeros((m, n), np.float32)
    Sd[rows, cols] = vals
    np.testing.assert_allclose(ops.spmm(St, torch.from_numpy(A)).numpy(),
                               Sd.T @ A, rtol=2e-4, atol=2e-4)
    S = tsparse.pack_row_tiled(np.array([0, 1, 2], np.int32),
                               np.array([5, 6, 7], np.int32),
                               np.ones(3, np.float32), (512, 128),
                               row_tile=128, nz_block=64, device=CPU)
    out = ops.spmm(S, torch.ones((128, 64))).numpy()
    assert np.all(out[128:] == 0.0) and np.all(out[3:128] == 0.0)
    assert np.all(out[:3] == 1.0)


def test_refusals():
    (_, _, _), (T, tA, tB) = _both(256, 192, 128, 6, 3, jnp.float32,
                                   torch.float32, row_tile=64, nz_block=32)
    with pytest.raises(ValueError, match="r_tile"):
        ops.spmm(T, tB, r_tile=48, blocks_per_step=1)
    with pytest.raises(ValueError, match="blocks_per_step"):
        ops.sddmm(tA, tB, T, r_tile=128, blocks_per_step=5)
    with pytest.raises(ValueError, match="backend"):
        ops.spmm(T, tB, backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        ops.set_default_backend("triton")
    # a grouped pack makes every divisor of the group legal
    (_, _, _), (G, _, gB) = _both(256, 192, 128, 6, 3, jnp.float32,
                                  torch.float32, row_tile=64, nz_block=32,
                                  group=4)
    ops.spmm(G, gB, r_tile=32, blocks_per_step=4)
    # the kernels refuse devices they have no kernel for
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spmm_cuda(T.tile_base, T.rows_local, T.cols, T.vals, meta,
                  row_tile=T.row_tile, m=256)


def test_wrappers_take_the_plain_version_on_cpu():
    (_, _, _), (T, tA, tB) = _both(256, 192, 64, 5, 2, jnp.float32,
                                   torch.float32, row_tile=32, nz_block=32)
    ops.reset_launch_counts()
    pk = (T.tile_base, T.rows_local, T.cols, T.vals)
    assert torch.equal(spmm_cuda(*pk, tB, row_tile=32, m=256),
                       spmm_plain(*pk, tB, row_tile=32, m=256))
    assert torch.equal(sddmm_cuda(*pk, tA, tB, row_tile=32),
                       sddmm_plain(*pk, tA, tB, row_tile=32))
    for a, b in zip(fusedmm_cuda(*pk, tA, tB, row_tile=32, m=256),
                    fusedmm_plain(*pk, tA, tB, row_tile=32, m=256)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == {"spmm": 0, "sddmm": 0, "fusedmm": 0}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(the kernels build with nvcc at first use)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,k", SHAPES)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, m, n, r, k, tdt):
    rows, cols, vals = tsparse.erdos_renyi(m, n, k, seed=m + r)
    S = tsparse.pack_row_tiled(rows, cols, vals, (m, n), row_tile=128,
                               nz_block=64, device=cuda)
    rng = np.random.default_rng(m + r)
    A = torch.from_numpy(rng.standard_normal((m, r))).to(cuda, tdt)
    B = torch.from_numpy(rng.standard_normal((n, r))).to(cuda, tdt)
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    f32 = tdt == torch.float32
    before = ops.launch_counts()
    got = sddmm_cuda(*pk, A, B, row_tile=S.row_tile)
    tol = 2e-5 if f32 else 0.12 * np.sqrt(r) / 8
    torch.testing.assert_close(got, sddmm_plain(*pk, A, B,
                                                row_tile=S.row_tile),
                               rtol=tol, atol=tol)
    assert torch.equal(got, sddmm_cuda(*pk, A, B, row_tile=S.row_tile))
    got = spmm_cuda(*pk, B, row_tile=S.row_tile, m=m)
    tol = 2e-4 if f32 else 0.15
    torch.testing.assert_close(got.float(), spmm_plain(
        *pk, B, row_tile=S.row_tile, m=m).float(), rtol=tol, atol=tol)
    assert torch.equal(got, spmm_cuda(*pk, B, row_tile=S.row_tile, m=m))
    out, R = fusedmm_cuda(*pk, A, B, row_tile=S.row_tile, m=m)
    want_out, want_R = fusedmm_plain(*pk, A, B, row_tile=S.row_tile, m=m)
    tol = 2e-3 if f32 else 0.5
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(R, want_R, rtol=tol, atol=tol)
    after = ops.launch_counts()
    assert after["sddmm"] == before["sddmm"] + 2
    assert after["spmm"] == before["spmm"] + 2
    assert after["fusedmm"] == before["fusedmm"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("r_tile", [128, 64])
def test_cuda_fusedmm_both_forms(cuda, r_tile):
    rows, cols, vals = tsparse.erdos_renyi(256, 192, 6, seed=17)
    S = tsparse.pack_row_tiled(rows, cols, vals, (256, 192), row_tile=64,
                               nz_block=32, group=4, device=cuda)
    rng = np.random.default_rng(17)
    A = torch.from_numpy(rng.standard_normal((256, 128))).to(cuda,
                                                            torch.float32)
    B = torch.from_numpy(rng.standard_normal((192, 128))).to(cuda,
                                                            torch.float32)
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    out, R = fusedmm_cuda(*pk, A, B, row_tile=64, m=256, r_tile=r_tile)
    assert fusedmm_cuda.last_two_pass == (r_tile < 128)
    want_out, want_R = fusedmm_plain(*pk, A, B, row_tile=64, m=256)
    torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(R, want_R, rtol=2e-3, atol=2e-3)
    Rs = sddmm_cuda(*pk, A, B, row_tile=64)
    assert torch.equal(R, Rs)
    assert torch.equal(out, spmm_cuda(*pk[:3], Rs, B, row_tile=64, m=256))
