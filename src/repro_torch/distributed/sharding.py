"""Sharding hygiene: divisibility sanitizing and FSDP extension.

Port of ``repro.distributed.sharding``.  A partition spec is the port's
own :class:`P`: a tuple with one entry a dimension, each ``None``
(replicated), a mesh axis name, or a tuple of axis names.  The functions
are the reference's, rule for rule:

``sanitize_spec`` drops any entry whose mesh-axis product does not
divide the corresponding dimension (odd vocab sizes like 50280 or
batch=1 decode fall back to replication on that dimension, as a
production launcher must rather than crash).

``fsdp_extend_spec`` is ZeRO-3/FSDP's placement: each parameter (and
its optimizer moments) additionally shards one free, divisible dimension
over the data axis.

A tree is nested dicts, lists and tuples with a P or a shaped leaf
(anything with ``.shape``) at each leaf; a spec tree and its shape tree
have one structure.  ``set_mesh`` installs the ambient mesh
(``launch/mesh.py``'s ``Mesh``) that ``models.model.constrain`` reads.
"""
from __future__ import annotations

import math
from typing import Dict


class P(tuple):
    """A partition spec: one entry a dimension (None, an axis name, or a
    tuple of axis names); missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes_size(entry, axis_sizes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(axis_sizes.get(a, 1) for a in entry if a)
    return axis_sizes.get(entry, 1)


def sanitize_spec(spec: P, shape, axis_sizes: Dict[str, int]) -> P:
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        size = _axes_size(entry, axis_sizes)
        out.append(entry if size > 0 and dim % size == 0 else None)
    return P(*out)


def _map(fn, spec_tree, shape_tree):
    """``fn(spec, shape)`` at each P leaf of ``spec_tree``, the tree's
    structure kept."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, tuple(shape_tree.shape))
    if isinstance(spec_tree, dict):
        return {k: _map(fn, v, shape_tree[k]) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map(fn, v, x)
                               for v, x in zip(spec_tree, shape_tree))
    raise TypeError(f"spec tree leaf {spec_tree!r} is not a P")


def sanitize_tree(spec_tree, shape_tree, axis_sizes: Dict[str, int]):
    return _map(lambda s, shape: sanitize_spec(s, shape, axis_sizes),
                spec_tree, shape_tree)


def fsdp_extend_spec(spec: P, shape, axis_sizes: Dict[str, int],
                     data_axis: str, min_size: int = 2 ** 16) -> P:
    """Shard one free dim over the data axis (largest divisible dim)."""
    if math.prod(shape) < min_size:      # skip small tensors (norms, biases)
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dsize = axis_sizes.get(data_axis, 1)
    best, best_dim = None, 0
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        if entry is None and dim % dsize == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is not None:
        entries[best] = data_axis
    return P(*entries)


def fsdp_extend_tree(spec_tree, shape_tree, axis_sizes, data_axis):
    return _map(lambda s, shape: fsdp_extend_spec(s, shape, axis_sizes,
                                                  data_axis),
                spec_tree, shape_tree)


_ACTIVE_MESH = None


def set_mesh(mesh) -> None:
    """Install ``mesh`` as the ambient mesh (None clears it); an elastic
    remesh re-installs."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def current_mesh():
    """The ambient mesh, or None."""
    return _ACTIVE_MESH
