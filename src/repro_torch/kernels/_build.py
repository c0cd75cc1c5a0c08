"""Build the CUDA kernels with ``nvcc``, load them with ``ctypes``, and
check what the wrappers hand them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``_build/`` beside this
file (listed in ``.gitignore``) at first use.  The library's file name
carries a digest of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is.  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module on
a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("spmm", "sddmm", "fusedmm")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()
#: ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: under ``$CUDA_HOME``, ``/usr/local/cuda``, or
    on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, in parallel.

    Returns ``{name: seconds}`` (0.0 for a library already built).
    Raises RuntimeError with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not lib_path(name).exists():
                build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.rt_error_string.restype = ctypes.c_char_p
            lib.rt_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


# ---------------------------------------------------------------------------
# Launch helpers shared by the wrappers
# ---------------------------------------------------------------------------

#: dtype flags of the C interface
DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


#: kernel forms of the C interface (``csrc/bulk.cuh``)
FORM_FLAG = {"load": 0, "bulk": 1}
#: routes the fused kernel reports (``csrc/fusedmm.cu``)
FUSED_ROUTE = {0: "load", 1: "bulk", 2: "two_pass"}
#: bulk-form limits, as ``csrc/bulk.cuh`` and ``csrc/fusedmm.cu`` set them
SPMM_MAX_ROW_TILE = 512           # float32 accumulator of 32 columns
MAX_ROW_BYTES = 1024              # one staged row of B (sddmm, fusedmm)
SDDMM_MAX_A_WINDOW = 64 * 1024    # one staged window of A (sddmm)
FUSED_MAX_ACC = 64 * 1024         # float32 window accumulator (fusedmm)


def choose_form(kind: str, *, r: int, k: int, row_tile: int, dense_dtype,
                vals_dtype, addresses, a_rows: int | None = None,
                n_windows: int | None = None) -> str:
    """The form of the ``kind`` ("spmm", "sddmm" or "fusedmm") kernel
    for a shape.

    "bulk" moves rows, index runs and A's windows with bulk asynchronous
    copies, which take whole 16-byte units at 16-byte aligned addresses:
    rows of ``r * itemsize % 16 == 0`` bytes, ``k`` entries a multiple of
    16 bytes of every index and value array, and every base in
    ``addresses`` aligned.  The bulk forms of SDDMM and FusedMM also stage
    whole rows of B, within the limit above.  SDDMM's stages a whole
    window of A too, and needs A's rows to be exactly ``n_windows``
    windows; FusedMM's reads A's rows through the cache and keeps the
    window's float32 accumulator in shared memory.  Anything else takes
    "load" (FusedMM's two-pass route is decided apart from this, by
    ``r_tile`` and the row width).
    """
    dsz, vsz = dense_dtype.itemsize, vals_dtype.itemsize
    ok = (r > 0 and (r * dsz) % 16 == 0 and (k * 4) % 16 == 0
          and (k * vsz) % 16 == 0 and all(a % 16 == 0 for a in addresses))
    if kind == "spmm":
        ok = ok and row_tile <= SPMM_MAX_ROW_TILE
    elif kind == "sddmm":
        ok = (ok and r * dsz <= MAX_ROW_BYTES
              and row_tile * r * dsz <= SDDMM_MAX_A_WINDOW
              and a_rows == n_windows * row_tile)
    elif kind == "fusedmm":
        ok = (ok and r * dsz <= MAX_ROW_BYTES
              and row_tile * r * 4 <= FUSED_MAX_ACC)
    else:
        raise ValueError(f"no kernel forms for {kind!r}")
    return "bulk" if ok else "load"


def window_offsets(tile_base: torch.Tensor, row_tile: int,
                   n_windows: int) -> torch.Tensor:
    """int64 (n_windows + 1,): window w's run of pack blocks is
    ``off[w] .. off[w + 1]`` (``tile_base`` is non-decreasing; padding
    blocks after the last window fall in its run).  On the pack's
    device, once per call."""
    starts = torch.arange(0, (n_windows + 1) * row_tile, row_tile,
                          dtype=tile_base.dtype, device=tile_base.device)
    return torch.searchsorted(tile_base, starts)


def addresses(*tensors: torch.Tensor) -> list:
    return [t.data_ptr() for t in tensors]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def validate(what: str, tile_base, rows_local, cols, vals, dense, *,
             row_tile: int, m: int | None, r_tile, blocks_per_step: int):
    """Refuse what the kernels do not take (device, dtype, shape, layout).

    ``dense`` is the list of dense operands (all one dtype, rows of width
    r).  Returns (nb, k, r).
    """
    dev = dense[0].device
    tensors = [tile_base, rows_local, cols, vals, *dense]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    for t in (tile_base, rows_local, cols):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: index arrays must be int32, "
                            f"got {t.dtype}")
    if vals.dtype not in DTYPE_FLAG:
        raise TypeError(f"{what}: vals must be float32 or bfloat16, "
                        f"got {vals.dtype}")
    if rows_local.dim() != 2 or cols.shape != rows_local.shape \
            or vals.shape != rows_local.shape \
            or tile_base.shape != rows_local.shape[:1]:
        raise ValueError(f"{what}: pack shapes disagree: rows_local "
                         f"{tuple(rows_local.shape)}, cols "
                         f"{tuple(cols.shape)}, vals {tuple(vals.shape)}, "
                         f"tile_base {tuple(tile_base.shape)}")
    nb, k = rows_local.shape
    r = dense[0].shape[-1]
    for t in dense:
        if t.dim() != 2 or t.shape[-1] != r or t.dtype != dense[0].dtype:
            raise ValueError(f"{what}: dense operands must be 2-D of one "
                             f"dtype and width")
    if dense[0].dtype not in DTYPE_FLAG:
        raise TypeError(f"{what}: dense operands must be float32 or "
                        f"bfloat16, got {dense[0].dtype}")
    if m is not None and m % row_tile:
        raise ValueError(f"{what}: m={m} is not a multiple of "
                         f"row_tile={row_tile}")
    r_tile = r if r_tile is None else r_tile
    if r_tile <= 0 or r % r_tile:
        raise ValueError(f"{what}: r_tile={r_tile} does not divide r={r}")
    if blocks_per_step <= 0 or nb % blocks_per_step:
        raise ValueError(f"{what}: blocks_per_step={blocks_per_step} does "
                         f"not divide nblocks={nb}")
    return nb, k, r
