"""Serving steps: prefill (build the KV/SSM cache) and decode (one token).

Port of ``repro.serving.decode``, on the port's model
(``repro_torch.models.model``).  Each step runs under
``torch.inference_mode()``.  Under an installed mesh
(``sharding.set_mesh``) the forward runs on the model axis
(``models.model._forward_tp``) and the cache is placed as
``models.model.init_cache`` places it: each rank holds its slice of the
sanitized ``cache_specs`` (its block of positions under
``seq_shard_decode``, its heads of an SSM state, its channels of a conv
window).  The batch a rank passes is its rows (:func:`rows`), and
``group`` the data group where the rows split over it (MoE routing is
the global batch's).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models import model as M


@torch.inference_mode()
def prefill(cfg: ModelConfig, pcfg: ParallelConfig, model, batch,
            group=None):
    """Full-sequence forward returning (last_logits, cache).

    Only the final position is projected through the LM head (``embed.T``
    when tied; this rank's vocab columns gathered where it splits) -- the
    full (B, S, vocab) logits tensor is never made."""
    hidden, cache, _ = M.forward(cfg, pcfg, model, batch, want_cache=True,
                                 return_hidden=True, group=group)
    tp = tpm.active(pcfg)
    tp = tpm.ONE if tp is None else dataclasses.replace(tp, seq=False)
    return M.logits_tp(cfg, model, hidden[:, -1:], tp), cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, pcfg: ParallelConfig, model, token_batch,
                cache, group=None):
    """One decode step.  token_batch: {"tokens": (B, 1)} (or embeds)."""
    logits, cache, _ = M.forward(cfg, pcfg, model, token_batch, cache=cache,
                                 want_cache=True, group=group)
    return logits, cache


def rows(mesh, pcfg: ParallelConfig, B: int):
    """``(lo, hi, group)``: the rows of a global batch of ``B`` that this
    rank serves, and the data group to route them with: its share where
    ``B`` splits over the data axis (``cache_specs``' batch entry,
    sanitized), else every row and no group."""
    if mesh is None:
        return 0, B, None
    n = mesh.axis_sizes.get(pcfg.data_axis, 1)
    if n == 1 or B % n:
        return 0, B, None
    i = mesh.coords[list(mesh.axis_names).index(pcfg.data_axis)]
    return i * (B // n), (i + 1) * (B // n), mesh.data_group


# the sequence axis of each attention cache entry, from the end
_SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_pe": -2}


@torch.inference_mode()
def extend_cache(cache, extra: int, pcfg: ParallelConfig = None):
    """Pad the sequence axis of attention caches by `extra` slots: the
    global axis, re-placed under the sanitized rule for the new length
    (with ``pcfg``, on the installed mesh's model group: this rank's
    block of the ``S + extra`` positions where they split, every position
    where they do not).  A leaf split over positions needs ``pcfg``."""
    tp = (tpm.active(pcfg) if pcfg is not None else None) or tpm.ONE
    if isinstance(cache, dict):
        out = {}
        for name, x in cache.items():
            if name in _SEQ_AXIS and isinstance(x, torch.Tensor):
                out[name] = _extend(x, extra, _SEQ_AXIS[name], tp, pcfg)
            else:
                out[name] = extend_cache(x, extra, pcfg)
        return out
    if isinstance(cache, list):
        return [extend_cache(x, extra, pcfg) for x in cache]
    return cache


def _extend(x, extra, axis, tp, pcfg):
    """One attention leaf padded by ``extra`` positions and re-placed."""
    dim = x.dim() + axis
    split = tpm.shard_dim(x)
    if split == dim and tp.size == 1:
        raise ValueError("extend_cache: a cache split over positions needs "
                         "its pcfg under the installed mesh")
    if split not in (None, dim):         # heads: the positions stay whole
        pad = [0, 0] * (-axis)
        pad[-1] = extra
        return tpm.placed(F.pad(x, pad), split)
    whole = x if split is None else tp.cat(x, dim)
    S = whole.shape[dim] + extra
    seq = pcfg is not None and pcfg.seq_shard_decode and tp.size > 1 \
        and S % tp.size == 0
    n = S // tp.size if seq else S
    lo = tp.rank * n if seq else 0
    shape = list(whole.shape)
    shape[dim] = n
    out = whole.new_zeros(shape)
    have = max(0, min(whole.shape[dim], lo + n) - lo)
    if have:
        out.narrow(dim, 0, have).copy_(whole.narrow(dim, lo, have))
    return tpm.placed(out, dim if seq else None)


@torch.inference_mode()
def greedy_generate(cfg, pcfg, model, prompt_batch, steps: int, group=None):
    """Host-driven greedy loop (examples / tests; not the hot path)."""
    logits, cache = prefill(cfg, pcfg, model, prompt_batch, group)
    cache = extend_cache(cache, steps, pcfg)
    toks = [logits[:, -1].argmax(-1)]
    for _ in range(steps - 1):
        logits, cache = decode_step(
            cfg, pcfg, model, {"tokens": toks[-1][:, None]}, cache, group)
        toks.append(logits[:, -1].argmax(-1))
    return torch.stack(toks, dim=1)
