"""Fault-tolerant checkpointing: npz + manifest, atomic, keep-k.

Port of ``repro.training.checkpoint``, with the same on-disk layout, so
a checkpoint written by either package restores in the other:

  <dir>/step_000123/
      manifest.json          {step, paths, shapes, dtypes, meta}
      shard_h000.npz         leaf_<i> for each leaf, in flatten order
      _COMMITTED             written last -- restore ignores uncommitted dirs

Writes go to a tmp dir and an atomic rename, so a crash mid-save never
corrupts the latest checkpoint.  A tree is nested dicts, lists and tuples
of tensors or arrays, flattened in jax's order (dict keys sorted) with
jax's ``keystr`` paths (``['X']``, ``[0]``).  Restore puts each leaf on
the restore target's device and dtype, so a run may resume on another
grid.

Errors are typed so callers can tell *absence* (nothing to resume from
-- start fresh) from *corruption* (on-disk state that disagrees with its
own manifest or with the requested tree -- fail loudly):

* :class:`CheckpointMissing` -- the directory/step doesn't exist or was
  never committed;
* :class:`CheckpointError` -- committed state that fails validation
  (missing shard, leaf-count drift, shape mismatch vs ``manifest.json``
  or vs the restore target).

``save(..., meta=...)`` embeds JSON metadata in the manifest: the
distributed trainers store ``DistProblem.meta_dict()`` there, so a resume
rebuilds the packs on the original grid (pinned family/c) or re-dispatches
onto a degraded one (``api.problem_from_meta``).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """Committed checkpoint state that fails validation (corruption or a
    restore target whose tree doesn't match what was saved)."""


class CheckpointMissing(CheckpointError):
    """No committed checkpoint at the requested location -- absence, not
    corruption; callers typically start fresh."""


def _flatten(tree, path=""):
    """(keystr path, leaf) pairs in jax's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, keep: int = 3,
         meta: dict | None = None) -> str:
    """Synchronous single-host save.

    ``meta`` (JSON-able) rides in the manifest -- e.g. the distributed
    problem's :meth:`repro_torch.core.api.DistProblem.meta_dict`.
    """
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = [(p, _host(leaf)) for p, leaf in _flatten(tree)]
    np.savez(os.path.join(tmp, "shard_h000.npz"),
             **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)})
    manifest = {
        "step": step,
        "paths": [p for p, _ in leaves],
        "shapes": [list(a.shape) for _, a in leaves],
        "dtypes": [str(a.dtype) for _, a in leaves],
    }
    if meta is not None:
        manifest["meta"] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(ckpt_dir, d, "_COMMITTED")):
            continue   # crash mid-save: ignore
        best = max(best if best is not None else -1, int(d.split("_")[1]))
    return best


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """The committed manifest of one step (typed errors, see module doc)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "_COMMITTED")):
        raise CheckpointMissing(f"no committed checkpoint at {path}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise CheckpointError(f"{path} is committed but has no "
                              "manifest.json -- corrupt checkpoint") from e
    except json.JSONDecodeError as e:
        raise CheckpointError(f"{path}/manifest.json is not valid JSON "
                              "-- corrupt checkpoint") from e


def _like(val: np.ndarray, ref):
    """A restored leaf on ``ref``'s device and dtype."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(val)).to(
            device=ref.device, dtype=ref.dtype)
    if hasattr(ref, "dtype"):
        return val.astype(ref.dtype)
    return val


def restore(ckpt_dir: str, step: int, tree_like):
    """Restore into the structure of ``tree_like``.

    Every restored leaf is validated against the shapes recorded in
    ``manifest.json`` (shard/manifest disagreement = corruption) AND
    against ``tree_like``'s leaf shapes (mismatch = wrong restore
    target); both raise :class:`CheckpointError` naming the offending
    leaf path.  Absence raises :class:`CheckpointMissing`.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = load_manifest(ckpt_dir, step)
    npz = os.path.join(path, "shard_h000.npz")
    if not os.path.exists(npz):
        raise CheckpointError(f"{path} is committed but shard_h000.npz "
                              "is missing -- corrupt checkpoint")
    with np.load(npz) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    if len(leaves) != len(manifest["shapes"]):
        raise CheckpointError(
            f"{path}: shard holds {len(leaves)} leaves but the manifest "
            f"records {len(manifest['shapes'])} -- corrupt checkpoint")
    flat = [leaf for _, leaf in _flatten(tree_like)]
    if len(flat) != len(leaves):
        raise CheckpointError(
            f"restore target has {len(flat)} leaves but {path} saved "
            f"{len(leaves)} (paths {manifest['paths'][:3]}...) -- "
            "tree structure mismatch")
    out = []
    for i, (ref, val, want, p_name) in enumerate(
            zip(flat, leaves, manifest["shapes"], manifest["paths"])):
        if list(np.shape(val)) != list(want):
            raise CheckpointError(
                f"{path}: leaf {i} ({p_name}) has shape "
                f"{list(np.shape(val))} on disk but the manifest says "
                f"{want} -- corrupt checkpoint")
        ref_shape = list(ref.shape) if hasattr(ref, "shape") else None
        if ref_shape is not None and ref_shape != list(want):
            raise CheckpointError(
                f"{path}: leaf {i} ({p_name}) was saved with shape "
                f"{want} but the restore target expects {ref_shape} -- "
                "refusing to restore mismatched state")
        out.append(_like(val, ref))
    return _unflatten(tree_like, iter(out))
