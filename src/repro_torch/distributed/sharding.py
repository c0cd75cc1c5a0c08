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
over the data axis.  :func:`fsdp_specs` applies it as the reference's
training dry run does (to the *stacked* leaf, a repeating segment's
scan axis in front, then sanitized) and drops the scan entry;
:func:`fsdp_dims` is the dimension of each of the port's leaves that
the data axis splits (``distributed/fsdp.py`` executes it).

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


def fsdp_specs(cfg, pcfg, model, mesh) -> dict:
    """``{parameter name: P}``: the reference's FSDP placement
    (``launch/dryrun.py``: ``param_specs``, ``fsdp_extend_tree`` over
    ``pcfg.data_axis``, ``sanitize_tree``) judged on each stacked leaf's
    shape, the scan entry dropped.  ``model`` may be on the meta device
    (its leaves' shapes are read, whole).  A leaf whose data split falls
    on the scan axis raises: the port's leaf is one repeat and has no
    such dimension."""
    from repro_torch.models import model as M
    sizes = mesh.axis_sizes
    out = {}
    for name, (spec, shape, stacked) in M.stacked_specs(
            cfg, pcfg, model).items():
        ext = sanitize_spec(fsdp_extend_spec(spec, shape, sizes,
                                             pcfg.data_axis), shape, sizes)
        if stacked and ext[0] == pcfg.data_axis:
            raise NotImplementedError(
                f"{name}: the FSDP placement splits the scan axis of its "
                f"stacked shape {shape} over {pcfg.data_axis!r}")
        out[name] = P(*ext[1:]) if stacked else ext
    return out


def fsdp_dims(cfg, pcfg, model, mesh) -> dict:
    """``{parameter name: the dimension split over the data axis, or
    None}`` of :func:`fsdp_specs` (one dimension at most)."""
    return {n: next((i for i, e in enumerate(spec) if e == pcfg.data_axis),
                    None)
            for n, spec in fsdp_specs(cfg, pcfg, model, mesh).items()}


_ACTIVE_MESH = None


def set_mesh(mesh) -> None:
    """Install ``mesh`` as the ambient mesh (None clears it); an elastic
    remesh re-installs."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def current_mesh():
    """The ambient mesh, or None."""
    return _ACTIVE_MESH
