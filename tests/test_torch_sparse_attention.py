"""The port's block-sparse attention (core/sparse_attention.py) against
the reference's (after tests/test_sparse_attention.py): the masks are
element-equal, the heads agree within tests/test_sparse_attention.py's
tolerance, on the same numpy-seeded inputs."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import sparse_attention as jsa
from repro.kernels import ops as jops
from repro_torch.core import sparse_attention as sa
from repro_torch.kernels import ops

CPU = torch.device("cpu")
FIELDS = ("rows_local", "cols", "vals", "tile_base")


@pytest.mark.parametrize("seq,block,w,g,rt,nz", [
    (256, 32, 2, 1, 128, 256), (256, 32, 2, 1, 64, 64),
    (128, 16, 2, 1, 32, 32), (192, 16, 3, 2, 32, 64)])
def test_mask_equals_reference(seq, block, w, g, rt, nz):
    want = jsa.build_causal_block_mask(seq, block, w, global_blocks=g,
                                       row_tile=rt, nz_block=nz)
    got = sa.build_causal_block_mask(seq, block, w, global_blocks=g,
                                     row_tile=rt, nz_block=nz, device=CPU)
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.shape == tuple(want.shape) and got.row_tile == want.row_tile
    assert sa.sparsity_stats(got, seq, 64) == \
        jsa.sparsity_stats(want, seq, 64)


def test_mask_is_causal_and_windowed():
    seq = 256
    mask = sa.build_causal_block_mask(seq, 32, 2, global_blocks=1,
                                      device=CPU)
    d = mask.to_dense().numpy()
    assert np.triu(d, 1).sum() == 0
    assert all(d[i, i] != 0 for i in range(seq))
    assert d[200, 64] == 0          # outside window, not global
    assert d[200, 10] != 0          # global block 0
    assert 0 < sa.sparsity_stats(mask, seq, 64)["fraction"] < 0.5


def _qkv(seq, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((seq, hd)).astype(np.float32)
            for _ in range(3)]


def test_sparse_attention_matches_reference_and_dense():
    seq, hd = 256, 32
    jmask = jsa.build_causal_block_mask(seq, 32, 2, row_tile=64,
                                        nz_block=64)
    mask = sa.build_causal_block_mask(seq, 32, 2, row_tile=64, nz_block=64,
                                      device=CPU)
    q, k, v = _qkv(seq, hd, 0)
    want = np.asarray(jsa.sparse_attention_head(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask))
    got = sa.sparse_attention_head(*map(torch.from_numpy, (q, k, v)), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)
    dense = sa.dense_reference(*map(torch.from_numpy, (q, k, v)),
                               mask.to_dense())
    jdense = np.asarray(jsa.dense_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        np.asarray(jmask.to_dense())))
    np.testing.assert_allclose(dense.numpy(), jdense, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=5e-4,
                               atol=5e-4)


def test_probs_rows_sum_to_one_and_match_reference():
    seq, hd = 128, 16
    jmask = jsa.build_causal_block_mask(seq, 16, 2, row_tile=32,
                                        nz_block=32)
    mask = sa.build_causal_block_mask(seq, 16, 2, row_tile=32, nz_block=32,
                                      device=CPU)
    q, k, _ = _qkv(seq, hd, 1)
    want = jsa.row_softmax(jops.sddmm(jnp.asarray(q), jnp.asarray(k),
                                      jmask))
    probs = sa.row_softmax(ops.sddmm(torch.from_numpy(q),
                                     torch.from_numpy(k), mask))
    np.testing.assert_allclose(probs.vals.numpy(), np.asarray(want.vals),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(probs.to_dense().numpy().sum(1), 1.0,
                               rtol=1e-5)
