"""Serving steps: prefill (build the KV/SSM cache) and decode (one token).

Port of ``repro.serving.decode``, on the port's model
(``repro_torch.models.model``).  Each step runs under
``torch.inference_mode()``.  Under an installed mesh with a ``model``
axis the forward raises (``models.model.SERVE_TP_ITEM``): serving there
is not ported yet, and is never run replicated in silence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models import model as M


@torch.inference_mode()
def prefill(cfg: ModelConfig, pcfg: ParallelConfig, model, batch):
    """Full-sequence forward returning (last_logits, cache).

    Only the final position is projected through the LM head (``embed.T``
    when tied) -- the full (B, S, vocab) logits tensor is never made."""
    hidden, cache, _ = M.forward(cfg, pcfg, model, batch, want_cache=True,
                                 return_hidden=True)
    head = (model.embed.T if cfg.tie_embeddings
            else model.head).to(hidden.dtype)
    return (hidden[:, -1:] @ head).float(), cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, pcfg: ParallelConfig, model, token_batch,
                cache):
    """One decode step.  token_batch: {"tokens": (B, 1)} (or embeds)."""
    logits, cache, _ = M.forward(cfg, pcfg, model, token_batch, cache=cache,
                                 want_cache=True)
    return logits, cache


# the sequence axis of each attention cache entry, from the end
_SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_pe": -2}


@torch.inference_mode()
def extend_cache(cache, extra: int):
    """Pad the sequence axis of attention caches by `extra` slots."""
    if isinstance(cache, dict):
        out = {}
        for name, x in cache.items():
            if name in _SEQ_AXIS and isinstance(x, torch.Tensor):
                pad = [0, 0] * (-_SEQ_AXIS[name])
                pad[-1] = extra
                out[name] = F.pad(x, pad)
            else:
                out[name] = extend_cache(x, extra)
        return out
    if isinstance(cache, list):
        return [extend_cache(x, extra) for x in cache]
    return cache


@torch.inference_mode()
def greedy_generate(cfg, pcfg, model, prompt_batch, steps: int):
    """Host-driven greedy loop (examples / tests; not the hot path)."""
    logits, cache = prefill(cfg, pcfg, model, prompt_batch)
    cache = extend_cache(cache, steps)
    toks = [logits[:, -1].argmax(-1)]
    for _ in range(steps - 1):
        logits, cache = decode_step(
            cfg, pcfg, model, {"tokens": toks[-1][:, None]}, cache)
        toks.append(logits[:, -1].argmax(-1))
    return torch.stack(toks, dim=1)
