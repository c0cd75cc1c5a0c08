"""The two kernel forms of the port's SpMM, SDDMM and FusedMM, and the
window offsets all three read.

On the CPU: ``_build.window_offsets`` against numpy's ``searchsorted``
on the reference packer's packs (group padding, empty windows, padding
blocks after the last window), ``_build.choose_form`` over dtype x r x
k x alignment and each kernel's limits, and FusedMM's two-pass route
still refused or taken by the plain version as before.  On the card
(marked ``cuda``): a shape that takes the load form, a window longer
than one staged index chunk, both forms on the same inputs giving the
same bits, FusedMM's bulk form equal to SDDMM then SpMM, and untouched
windows exactly 0.
"""
import numpy as np
import pytest
import torch

from repro.core import sparse as jsparse
from repro_torch import convert
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import _build, ops
from repro_torch.kernels.fusedmm import fusedmm_cuda, fusedmm_plain
from repro_torch.kernels.sddmm import sddmm_cuda, sddmm_plain
from repro_torch.kernels.spmm import spmm_cuda, spmm_plain
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

CPU = torch.device("cpu")
F32, BF16 = torch.float32, torch.bfloat16


def _numpy_offsets(tile_base, row_tile, n_windows):
    starts = np.arange(n_windows + 1, dtype=np.int64) * row_tile
    return np.searchsorted(np.asarray(tile_base), starts, side="left")


def _sparse_rows(m, n, every, seed):
    """COO with nonzeros only in rows that are multiples of ``every``,
    so most windows are empty."""
    rows, cols, vals = jsparse.erdos_renyi(m, n, 5, seed=seed)
    keep = rows % every == 0
    return rows[keep], cols[keep], vals[keep]


PACKS = [  # (name, m, n, coo, pack kwargs)
    ("plain", 256, 192, None, dict(row_tile=32, nz_block=32)),
    ("group-padded", 256, 192, None, dict(row_tile=64, nz_block=32,
                                          group=4)),
    ("empty windows", 512, 128, 200, dict(row_tile=32, nz_block=16)),
    ("padding after last", 256, 192, None, dict(row_tile=32, nz_block=32,
                                                nblocks=96)),
    ("all empty", 128, 64, "none", dict(row_tile=32, nz_block=8)),
]


@pytest.mark.parametrize("name,m,n,coo,kw", PACKS,
                         ids=[p[0] for p in PACKS])
def test_window_offsets_match_numpy(name, m, n, coo, kw):
    if coo is None:
        rows, cols, vals = jsparse.erdos_renyi(m, n, 6, seed=m + n)
    elif coo == "none":
        rows = cols = np.zeros(0, np.int32)
        vals = np.zeros(0, np.float32)
    else:
        rows, cols, vals = _sparse_rows(m, n, coo, seed=5)
    S = jsparse.pack_row_tiled(rows, cols, vals, (m, n), **kw)
    T = convert.row_tiled_from_numpy(S, device=CPU)
    W = m // T.row_tile
    off = _build.window_offsets(T.tile_base, T.row_tile, W)
    assert off.dtype == torch.int64 and tuple(off.shape) == (W + 1,)
    want = _numpy_offsets(np.asarray(S.tile_base), T.row_tile, W)
    np.testing.assert_array_equal(off.numpy(), want)
    # every block lies in exactly one window's run, and the run's blocks
    # carry that window's base
    tb = T.tile_base.numpy()
    assert off[0] == 0 and off[-1] == T.nblocks
    for w in range(W):
        assert np.all(tb[off[w]:off[w + 1]] == w * T.row_tile)
    if name == "empty windows":
        assert int((off[1:] == off[:-1]).sum()) > W // 2
    if name == "padding after last":
        live = int(np.asarray(S.vals).any(axis=1).sum())
        assert T.nblocks == 96 and live < 96
        last = int(tb[-1]) // T.row_tile
        assert off[last + 1] - off[last] > 96 - live


def _form(kind, r=128, k=32, row_tile=32, dense=F32, vals=F32, addr=0,
          a_rows=None, n_windows=None):
    if kind in ("sddmm", "fusedmm") and a_rows is None:
        a_rows, n_windows = 4 * row_tile, 4
    return _build.choose_form(kind, r=r, k=k, row_tile=row_tile,
                              dense_dtype=dense, vals_dtype=vals,
                              addresses=[4096, 8192 + addr],
                              a_rows=a_rows, n_windows=n_windows)


@pytest.mark.parametrize("kind", ["spmm", "sddmm", "fusedmm"])
@pytest.mark.parametrize("dense,r,want", [
    (F32, 128, "bulk"), (F32, 36, "bulk"), (F32, 34, "load"),
    (F32, 1, "load"), (BF16, 128, "bulk"), (BF16, 40, "bulk"),
    (BF16, 36, "load"), (BF16, 4, "load")])
def test_form_by_dtype_and_width(kind, dense, r, want):
    assert _form(kind, r=r, dense=dense) == want


@pytest.mark.parametrize("kind", ["spmm", "sddmm", "fusedmm"])
def test_form_by_alignment_and_block_size(kind):
    assert _form(kind) == "bulk"
    for addr in (4, 8, 2):
        assert _form(kind, addr=addr) == "load"
    assert _form(kind, addr=16) == "bulk"
    # nz_block: whole 16-byte units of int32 indices and of the values
    assert _form(kind, k=4) == "bulk"
    assert _form(kind, k=6) == "load"
    assert _form(kind, k=4, vals=BF16) == "load"
    assert _form(kind, k=8, vals=BF16) == "bulk"


def test_form_limits_per_kernel():
    # spmm: the window accumulator (narrowed to 32 columns) must fit
    assert _form("spmm", row_tile=512) == "bulk"
    assert _form("spmm", row_tile=1024) == "load"
    # sddmm: one staged row of B and one window of A must fit
    assert _form("sddmm", r=256) == "bulk"
    assert _form("sddmm", r=260) == "load"
    assert _form("sddmm", r=512, dense=BF16) == "bulk"
    assert _form("sddmm", r=128, row_tile=128) == "bulk"      # 64 KB of A
    assert _form("sddmm", r=256, row_tile=128) == "load"      # 128 KB
    # A's rows must be exactly the windows
    assert _form("sddmm", a_rows=100, n_windows=3) == "load"
    assert _form("sddmm", a_rows=96, n_windows=3) == "bulk"
    with pytest.raises(ValueError, match="forms"):
        _form("gemm")


MAIN_WINDOWS = (1 << 22) // 32   # the main path: m = 2^22, row_tile 32
FUSED_FORMS = [  # (case, kwargs of _form, the form)
    ("main path", dict(a_rows=MAIN_WINDOWS * 32, n_windows=MAIN_WINDOWS),
     "bulk"),
    ("main path bf16", dict(dense=BF16, a_rows=MAIN_WINDOWS * 32,
                            n_windows=MAIN_WINDOWS), "bulk"),
    ("r=34 fp32", dict(r=34), "load"),
    ("r=36 bf16", dict(r=36, dense=BF16), "load"),
    ("r=36 fp32", dict(r=36), "bulk"),
    ("unaligned values", dict(addr=4), "load"),
    ("B row of 1 KB", dict(r=256, row_tile=64), "bulk"),
    ("B row over 1 KB", dict(r=260, row_tile=32), "load"),
    ("accumulator of 64 KB", dict(r=512, dense=BF16), "bulk"),
    ("accumulator over 64 KB", dict(r=256, dense=BF16, row_tile=128),
     "load"),
    # A's rows are read through the cache, not staged by windows
    ("A rows not the windows", dict(a_rows=100, n_windows=3), "bulk"),
    ("A rows one window short", dict(a_rows=96, n_windows=4), "bulk"),
]


@pytest.mark.parametrize("case,kw,want", FUSED_FORMS,
                         ids=[c[0] for c in FUSED_FORMS])
def test_fused_form_by_shape(case, kw, want):
    assert _form("fusedmm", **kw) == want
    if case == "accumulator over 64 KB":
        # A's window (64 KB of bf16) and B's rows fit: only the float32
        # accumulator sends this shape to the load form
        assert _form("sddmm", **kw) == "bulk"
    if case.startswith("A rows"):
        # only SDDMM's bulk form stages whole windows of A
        assert _form("sddmm", **kw) == "load"


def test_fused_two_pass_route_unchanged_on_cpu():
    rows, cols, vals = tsparse.erdos_renyi(256, 192, 6, seed=17)
    S = tsparse.pack_row_tiled(rows, cols, vals, (256, 192), row_tile=64,
                               nz_block=32, device=CPU)
    G = tsparse.pack_row_tiled(rows, cols, vals, (256, 192), row_tile=64,
                               nz_block=32, group=4, device=CPU)
    rng = np.random.default_rng(17)
    A = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((192, 128)).astype(np.float32))
    # the refusals of the reference's tiling knobs
    with pytest.raises(ValueError, match="does not divide"):
        ops.fusedmm(A, B, S, r_tile=48)
    with pytest.raises(ValueError, match="infeasible"):
        ops.fusedmm(A, B, S, r_tile=32, blocks_per_step=8)
    # r_tile < r on CPU tensors: the plain version, bit for bit, no launch
    # and no route recorded
    ops.reset_launch_counts()
    fusedmm_cuda.last_form = None
    for P, bps in ((S, 1), (G, 4)):
        want = fusedmm_plain(P.tile_base, P.rows_local, P.cols, P.vals, A, B,
                             row_tile=64, m=256)
        for r_tile in (32, 64, 128):
            out, R = ops.fusedmm(A, B, P, r_tile=r_tile, blocks_per_step=bps)
            assert torch.equal(out, want[0])
            assert torch.equal(R.vals, want[1])
    assert ops.launch_counts()["fusedmm"] == 0
    assert fusedmm_cuda.last_form is None


def test_wrappers_record_no_form_on_cpu():
    rows, cols, vals = tsparse.erdos_renyi(64, 64, 4, seed=1)
    S = tsparse.pack_row_tiled(rows, cols, vals, (64, 64), row_tile=32,
                               nz_block=8, device=CPU)
    B = torch.ones((64, 16))
    spmm_cuda.last_form = sddmm_cuda.last_form = None
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    spmm_cuda(*pk, B, row_tile=32, m=64)
    sddmm_cuda(*pk, B, B, row_tile=32)
    assert spmm_cuda.last_form is None and sddmm_cuda.last_form is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(the kernels build with nvcc at first use)")
    return torch.device("cuda")


def _operands(dev, m, n, r, per_row, row_tile, nz_block, dt, seed):
    rows, cols, vals = tsparse.erdos_renyi(m, n, per_row, seed=seed)
    S = tsparse.pack_row_tiled(rows, cols, vals, (m, n), row_tile=row_tile,
                               nz_block=nz_block, device=dev)
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((m, r))).to(dev, dt)
    B = torch.from_numpy(rng.standard_normal((n, r))).to(dev, dt)
    return S, A, B


def _misaligned(x):
    """The same values at a base 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    shift = (4 // x.element_size()) + (
        (-buf.data_ptr() // x.element_size()) % (16 // x.element_size()))
    y = buf[shift:shift + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("case,m,n,r,per_row,row_tile,nz_block,dt,form", [
    ("load form fp32 r=34", 256, 192, 34, 6, 64, 32, F32, "load"),
    ("bulk form fp32 r=36", 256, 192, 36, 6, 64, 32, F32, "bulk"),
    ("load form bf16 r=36", 256, 192, 36, 6, 64, 32, BF16, "load"),
    ("long window", 512, 4096, 128, 64, 128, 64, F32, "bulk"),
    ("long window bf16", 512, 4096, 128, 64, 128, 64, BF16, "bulk"),
])
def test_cuda_forms_match_plain(cuda, case, m, n, r, per_row, row_tile,
                                nz_block, dt, form):
    S, A, B = _operands(cuda, m, n, r, per_row, row_tile, nz_block, dt,
                        seed=m + r)
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    if case.startswith("long"):   # one window's run outgrows a chunk
        off = _build.window_offsets(S.tile_base, row_tile, m // row_tile)
        assert int((off[1:] - off[:-1]).max()) * nz_block > 1024
    f32 = dt == F32
    got = sddmm_cuda(*pk, A, B, row_tile=row_tile)
    assert sddmm_cuda.last_form == form
    tol = 2e-5 if f32 else 0.12 * np.sqrt(r) / 8
    torch.testing.assert_close(got, sddmm_plain(*pk, A, B,
                                                row_tile=row_tile),
                               rtol=tol, atol=tol)
    assert torch.equal(got, sddmm_cuda(*pk, A, B, row_tile=row_tile))
    out = spmm_cuda(*pk, B, row_tile=row_tile, m=m)
    assert spmm_cuda.last_form == form
    tol = 2e-4 if f32 else 0.15
    torch.testing.assert_close(out.float(), spmm_plain(
        *pk, B, row_tile=row_tile, m=m).float(), rtol=tol, atol=tol)
    assert torch.equal(out, spmm_cuda(*pk, B, row_tile=row_tile, m=m))
    if f32:   # fused == sddmm then spmm, bit for bit, in either form
        fo, fR = fusedmm_cuda(*pk, A, B, row_tile=row_tile, m=m)
        assert torch.equal(fR, got)
        assert torch.equal(fo, spmm_cuda(*pk[:3], got, B, row_tile=row_tile,
                                         m=m))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [F32, BF16])
def test_cuda_bulk_and_load_forms_agree_bitwise(cuda, dt):
    S, A, B = _operands(cuda, 512, 384, 128, 8, 64, 32, dt, seed=3)
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    bulk = (sddmm_cuda(*pk, A, B, row_tile=64),
            spmm_cuda(*pk, B, row_tile=64, m=512))
    assert sddmm_cuda.last_form == spmm_cuda.last_form == "bulk"
    # unaligned values take the load form; A and B stay aligned, so the
    # load form's dots take the same four-at-a-time order
    pk2 = pk[:3] + (_misaligned(S.vals),)
    load = (sddmm_cuda(*pk2, A, B, row_tile=64),
            spmm_cuda(*pk2, B, row_tile=64, m=512))
    assert sddmm_cuda.last_form == spmm_cuda.last_form == "load"
    assert torch.equal(bulk[0], load[0])
    assert torch.equal(bulk[1], load[1])


def _fused_case(cuda, m, n, r, per_row, row_tile, nz_block, dt, seed):
    S, A, B = _operands(cuda, m, n, r, per_row, row_tile, nz_block, dt, seed)
    return (S.tile_base, S.rows_local, S.cols, S.vals), A, B


@pytest.mark.cuda
@pytest.mark.parametrize("case,m,n,r,per_row,row_tile,nz_block,dt", [
    ("main widths", 512, 384, 128, 8, 32, 32, F32),
    ("main widths bf16", 512, 384, 128, 8, 32, 32, BF16),
    ("r=36", 256, 192, 36, 6, 64, 32, F32),
    ("r=40 bf16", 256, 192, 40, 6, 64, 32, BF16),
    ("r=256 row_tile 64", 256, 192, 256, 6, 64, 32, F32),
    ("r=512 bf16", 256, 192, 512, 6, 32, 32, BF16),
])
def test_cuda_fused_bulk_equals_load_bitwise(cuda, case, m, n, r, per_row,
                                             row_tile, nz_block, dt):
    pk, A, B = _fused_case(cuda, m, n, r, per_row, row_tile, nz_block, dt,
                           seed=m + r)
    bulk = fusedmm_cuda(*pk, A, B, row_tile=row_tile, m=m)
    assert fusedmm_cuda.last_form == "bulk"
    want = fusedmm_plain(*pk, A, B, row_tile=row_tile, m=m)
    tol = 2e-3 if dt == F32 else 0.5
    for got, ref in zip(bulk, want):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    again = fusedmm_cuda(*pk, A, B, row_tile=row_tile, m=m)
    # unaligned values take the load form on the same pack
    load = fusedmm_cuda(*pk[:3], _misaligned(pk[3]), A, B,
                        row_tile=row_tile, m=m)
    assert fusedmm_cuda.last_form == "load"
    for a, b, c in zip(bulk, again, load):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("case,m,n,r,per_row,row_tile,nz_block", [
    ("main widths", 512, 384, 128, 8, 32, 32),
    ("long window", 512, 4096, 128, 64, 128, 64),
    ("r=256", 256, 192, 256, 6, 64, 32),
])
def test_cuda_fused_bulk_equals_sddmm_then_spmm(cuda, case, m, n, r,
                                                per_row, row_tile, nz_block):
    pk, A, B = _fused_case(cuda, m, n, r, per_row, row_tile, nz_block, F32,
                           seed=m + r + 1)
    out, R = fusedmm_cuda(*pk, A, B, row_tile=row_tile, m=m)
    assert fusedmm_cuda.last_form == "bulk"
    Rs = sddmm_cuda(*pk, A, B, row_tile=row_tile)
    assert sddmm_cuda.last_form == "bulk"
    assert torch.equal(R, Rs)
    assert torch.equal(out, spmm_cuda(*pk[:3], Rs, B, row_tile=row_tile,
                                      m=m))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [F32, BF16])
def test_cuda_fused_bulk_long_window(cuda, dt):
    m, row_tile, nz_block = 512, 128, 64
    pk, A, B = _fused_case(cuda, m, 4096, 128, 64, row_tile, nz_block, dt,
                           seed=11)
    off = _build.window_offsets(pk[0], row_tile, m // row_tile)
    # one window's run outgrows a staged index chunk (256 entries) many
    # times over
    assert int((off[1:] - off[:-1]).max()) * nz_block > 8 * 256
    out, R = fusedmm_cuda(*pk, A, B, row_tile=row_tile, m=m)
    assert fusedmm_cuda.last_form == "bulk"
    want = fusedmm_plain(*pk, A, B, row_tile=row_tile, m=m)
    tol = 2e-3 if dt == F32 else 0.5
    torch.testing.assert_close(out.float(), want[0].float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(R.float(), want[1].float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_cuda_fused_bulk_takes_a_beyond_the_windows(cuda):
    # A with rows past the last window: SDDMM's bulk form (whole windows
    # of A staged) refuses it, FusedMM's reads A's rows through the cache
    pk, A, B = _fused_case(cuda, 256, 192, 128, 6, 32, 32, F32, seed=23)
    extra = torch.randn((40, 128), device=cuda)
    A2 = torch.cat([A, extra])
    out, R = fusedmm_cuda(*pk, A2, B, row_tile=32, m=256)
    assert fusedmm_cuda.last_form == "bulk"
    Rs = sddmm_cuda(*pk, A2, B, row_tile=32)
    assert sddmm_cuda.last_form == "load"
    assert torch.equal(R, Rs)
    assert torch.equal(out, spmm_cuda(*pk[:3], Rs, B, row_tile=32, m=256))
    load = fusedmm_cuda(*pk[:3], _misaligned(pk[3]), A2, B, row_tile=32,
                        m=256)
    assert fusedmm_cuda.last_form == "load"
    assert torch.equal(out, load[0]) and torch.equal(R, load[1])


@pytest.mark.cuda
def test_cuda_fused_bulk_untouched_windows_zero(cuda):
    S = tsparse.pack_row_tiled(np.array([0, 1, 2, 300], np.int32),
                               np.array([5, 6, 7, 8], np.int32),
                               np.ones(4, np.float32), (512, 128),
                               row_tile=32, nz_block=16, device=cuda)
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    A = torch.ones((512, 64), device=cuda)
    B = torch.ones((128, 64), device=cuda)
    out, R = fusedmm_cuda(*pk, A, B, row_tile=32, m=512)
    assert fusedmm_cuda.last_form == "bulk"
    touched = torch.zeros(512, dtype=torch.bool, device=cuda)
    touched[[0, 1, 2, 300]] = True
    assert bool((out[~touched] == 0).all())
    # coeff = 1 * <1, 1> = 64, out row = 64 * B row
    assert bool((out[touched] == 64).all())
    assert bool((R[S.vals != 0] == 64).all())
