"""Minimal Matrix Market (``.mtx``) I/O for real sparse matrices.

Port of ``repro.core.mtx`` (numpy only, as there), kept as the port's
own copy.

The paper's strong-scaling experiments run on SuiteSparse matrices
distributed in Matrix Market coordinate format; this loader lets the
examples, benchmarks and dryruns consume those files directly instead of
only the synthetic Erdos-Renyi/RMAT generators.  Kept dependency-free
(no scipy.io): the subset implemented — ``coordinate`` storage with
``real``/``integer``/``pattern`` fields and ``general``/``symmetric``/
``skew-symmetric`` symmetry — covers the SuiteSparse collection's sparse
matrices.  ``array`` (dense) storage is intentionally rejected: this
library is about sparse kernels.

A tiny bundled fixture lives at ``tests/fixtures/tiny.mtx`` so the
``--mtx`` paths of the examples/benchmarks are exercised in CI without
shipping a real dataset.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["load_mtx", "save_mtx"]


def load_mtx(path: str, dtype=np.float32):
    """Read a Matrix Market coordinate file.

    Returns ``(rows, cols, vals, (m, n))`` with int32 zero-based
    coordinates, ``dtype`` values (``pattern`` entries become 1.0), and
    symmetric/skew-symmetric storage expanded to the full pattern
    (off-diagonal entries mirrored, negated for skew).  Duplicate
    entries are summed, matching common sparse-assembly convention.
    """
    with open(path, "r") as f:
        header = f.readline()
        parts = header.strip().split()
        if len(parts) < 5 or parts[0] != "%%MatrixMarket":
            raise ValueError(f"{path}: not a MatrixMarket file: {header!r}")
        _, obj, fmt, field, symmetry = (p.lower() for p in parts[:5])
        if obj != "matrix" or fmt != "coordinate":
            raise ValueError(f"{path}: only 'matrix coordinate' supported, "
                             f"got '{obj} {fmt}'")
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: unsupported field {field!r} "
                             "(real/integer/pattern)")
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise ValueError(f"{path}: unsupported symmetry {symmetry!r}")
        line = f.readline()
        while line and line.lstrip().startswith("%"):
            line = f.readline()
        dims = line.split()
        if len(dims) != 3:
            raise ValueError(f"{path}: bad size line {line!r}")
        m, n, nnz = (int(x) for x in dims)
        body = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
    if body.shape[0] != nnz:
        raise ValueError(f"{path}: size line promises {nnz} entries, "
                         f"found {body.shape[0]}")
    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    bad = (rows < 0) | (rows >= m) | (cols < 0) | (cols >= n)
    if bool(bad.any()):
        i = int(np.argmax(bad))
        raise ValueError(
            f"{path}: entry {i} at 1-based ({rows[i] + 1}, {cols[i] + 1}) "
            f"outside the declared {m} x {n} shape")
    if field == "pattern":
        vals = np.ones(nnz, np.float64)
    else:
        if body.shape[1] < 3:
            raise ValueError(f"{path}: {field} matrix without value column")
        vals = body[:, 2].astype(np.float64)
    if symmetry != "general":
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, sign * vals[off]])
    # sum duplicates + canonical row-major order (matches erdos_renyi)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq, starts = np.unique(key, return_index=True)
    summed = np.add.reduceat(vals, starts) if len(vals) else vals
    rows = (uniq // n).astype(np.int32)
    cols = (uniq % n).astype(np.int32)
    return rows, cols, summed.astype(dtype), (m, n)


def save_mtx(path: str, rows, cols, vals, shape: Tuple[int, int]):
    """Write a general real coordinate Matrix Market file (1-based)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    m, n = shape
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"% written by repro_torch.core.mtx\n{m} {n} {len(vals)}\n")
        for i, j, v in zip(rows, cols, vals):
            f.write(f"{int(i) + 1} {int(j) + 1} {float(v):.9g}\n")
