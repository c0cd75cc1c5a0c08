"""Lossy wire formats for distributed collectives, with error feedback.

Port of ``repro.training.compression``.  Two compression levels:

* **bf16 payload casts** -- the wire format of the support-pruned sends
  (``core.common.pruned_permute`` and its gathers ship payloads through
  :func:`to_bf16` / :func:`from_bf16` when a plan carries
  ``compress="bf16"``).  Halves every pruned channel's bytes; lossy, so
  results are no longer bitwise those of the exact wire.
* **int8 block-quantized gradients** -- before the sum over ranks, each
  tensor is scaled to int8 per block of 256 elements (the scale
  ``max|x| / 127 + 1e-12``, rounding half to even).

Both run under **error feedback**: the compression residual is carried
to the next step and added back before compressing again, so the
accumulated error stays bounded (:class:`ErrorFeedback` for the generic
per-tensor form, :func:`compressed_psum` for the fused int8 + sum form).

A "tree" here is a tensor or a (nested) tuple, list or dict of them.
"""
from __future__ import annotations

import torch

BLOCK = 256


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# bf16 wire casts (the compress="bf16" payload format of the pruned sends)
# ---------------------------------------------------------------------------

def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 payload -> bf16 wire format (half the bytes), rounded to
    nearest even."""
    return x.to(torch.bfloat16)


def from_bf16(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bf16 wire payload -> the compute dtype at the receiver."""
    return x.to(dtype)


class ErrorFeedback:
    """Per-tensor compression-residual accumulator.

    ``seen = ef(tree)`` returns what the receivers observe after the
    lossy round trip and folds the residual ``corrected - seen`` into
    the next call.  The default round trip is the bf16 wire cast; pass
    any elementwise lossy function to model another format.  The
    residual lives on the device of the tensors it was made from.
    """

    def __init__(self, roundtrip=None):
        self.residual = None
        self._roundtrip = roundtrip or \
            (lambda x: from_bf16(to_bf16(x), x.dtype))

    def __call__(self, tree):
        if self.residual is None:
            self.residual = _tree_map(torch.zeros_like, tree)
        corrected = _tree_map(lambda g, e: g + e, tree, self.residual)
        seen = _tree_map(self._roundtrip, corrected)
        self.residual = _tree_map(lambda c, s: c - s, corrected, seen)
        return seen


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

def quantize_int8(g: torch.Tensor):
    """g -> (q int8 (blocks, 256), scales float32 (blocks, 1), meta)."""
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, (tuple(g.shape), pad)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, meta):
    shape, pad = meta
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _per_rank(coll, fn, x):
    """``fn`` on each held rank's block of ``x`` (rank axes in front),
    restacked: each rank quantizes its own tensor, as it would alone."""
    grid = coll.grid
    outs = [fn(x[grid.at(*rk)]) for rk in grid.ranks()]
    return torch.stack(outs).reshape(*grid.local_shape, *outs[0].shape)


def rank_order_sum(coll, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's block of ``x`` summed over ``axis`` in rank order
    0, 1, .. (each rank holding the sum), on either backend with the
    same bits: the size - 1 cyclic permutes bring every peer's block, and
    the sum runs over them in rank order (a backend's reduction would not
    fix the order)."""
    grid = coll.grid
    d = grid.dim(axis)
    size = grid.shape[d]
    arrived = torch.stack([x] + [coll.permute(x, axis, k)
                                 for k in range(1, size)])
    me = grid.held_coords(x.device)[d]        # this rank's position
    total = None
    for j in range(size):
        # rank j's block reached rank i through offset (i - j) mod size
        k = ((me - j) % size).reshape(1, *me.shape, *(1,) * (x.ndim
                                                            - me.ndim))
        part = torch.take_along_dim(arrived, k.expand(1, *x.shape),
                                    dim=0)[0]
        total = part if total is None else total + part
    return total


def compressed_psum(grads, coll, axis: str, errors=None):
    """The sum over ``axis`` of the dequantized int8 payloads, with error
    feedback.  ``grads``: a tree of tensors with ``coll.grid``'s rank
    axes in front.  Returns ``(sums, new_errors)``; ``errors=None``
    starts the feedback at zero.  The sum runs in rank order
    (:func:`rank_order_sum`), so the stacked and the torch.distributed
    backends give the same bits."""
    if errors is None:
        errors = _tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                           grads)

    def one(g, e):
        corrected = g.to(torch.float32) + e
        deq = _per_rank(coll, lambda t: dequantize_int8(*quantize_int8(t)),
                        corrected)
        return rank_order_sum(coll, deq, axis), corrected - deq

    outs = []
    sums = _tree_map(lambda g, e: outs.append(one(g, e)) or outs[-1][0],
                     grads, errors)
    it = iter(outs)
    return sums, _tree_map(lambda g: next(it)[1], grads)
