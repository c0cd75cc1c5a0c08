"""Model assembly: segments of super-blocks, looped over repeats.

Port of ``repro.models.model``.  A config's layer stack is a list of
(super_block, repeat) segments.  The model is an ``nn.Module``:
``segments[s]`` is a ``ModuleList`` of the segment's repeats, each a
:class:`SuperBlock` holding one :class:`Block` a layer (``blk0``,
``blk1``, ...), and the forward loops over the repeats where the
reference scans over stacked parameters.  A cache mirrors that layout:
``{"segments": [[{"blk0": entry, ...} for each repeat] for each
segment]}``, one entry a layer.

The reference's partition specs (``param_specs``, ``cache_specs``) and
activation constraints (``constrain``, ``batch_axes``) place nothing on
one card; they come with ``distributed/sharding.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import device as _device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Init, init_mlp, init_rms, rms_norm,
                                       swiglu)


def _dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ``norm1`` and its mixer (``attn`` or ``mamba``), then,
    unless its ffn is "none", ``norm2`` and ``mlp`` or ``moe``."""

    def __init__(self, init: Init, cfg: ModelConfig, spec):
        super().__init__()
        self.norm1 = init_rms(init, cfg.d_model)
        if spec.mixer == "attn":
            self.attn = (attn_mod.init_mla(init, cfg) if cfg.mla_kv_lora
                         else attn_mod.init_gqa(init, cfg))
        else:
            self.mamba = ssm_mod.init_mamba2(init, cfg)
        if spec.ffn != "none":
            self.norm2 = init_rms(init, cfg.d_model)
            if spec.ffn == "dense":
                self.mlp = init_mlp(init, cfg.d_model, cfg.d_ff)
            else:
                self.moe = moe_mod.init_moe(init, cfg)


class SuperBlock(nn.Module):
    """One repeat of a segment: its layers as ``blk0``, ``blk1``, ..."""

    def __init__(self, init: Init, cfg: ModelConfig, sb):
        super().__init__()
        for i, spec in enumerate(sb):
            self.add_module(f"blk{i}", Block(init, cfg, spec))


class Model(nn.Module):
    """``embed`` (vocab, d) when the config embeds tokens, ``head`` (d,
    vocab) unless tied, ``final_norm``, and ``segments``."""

    def __init__(self, init: Init, cfg: ModelConfig):
        super().__init__()
        if cfg.embed_inputs:
            self.embed = init.normal((cfg.vocab, cfg.d_model), 0.02)
        if not cfg.tie_embeddings:
            self.head = init.normal((cfg.d_model, cfg.vocab), 0.02)
        self.final_norm = init_rms(init, cfg.d_model)
        self.segments = nn.ModuleList(
            nn.ModuleList(SuperBlock(init, cfg, sb) for _ in range(cnt))
            for sb, cnt in cfg.segments)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                param_dtype: str = "float32", device=None) -> Model:
    """The model with the reference's shapes and scales (normal weights
    of std 0.02, ``conv_w`` 0.2; ``A_log`` 0, ``D`` 1, ``dt_bias`` -2;
    norms 1), drawn from ``generator`` on its own device and placed on
    ``device`` (default: the card)."""
    dev = _device.resolve(device)
    return Model(Init(generator, _dtype(param_dtype), dev), cfg)


def empty_model(cfg: ModelConfig, param_dtype: str = "float32") -> Model:
    """The model's shapes on the meta device, to be filled by
    ``load_state_dict(..., assign=True)``."""
    return Model(Init(None, _dtype(param_dtype), "meta"), cfg)


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16,
               device=None):
    """Static KV/SSM cache mirroring the segment structure."""
    dev = _device.resolve(device)
    segs = []
    for sb, cnt in cfg.segments:
        reps = []
        for _ in range(cnt):
            blks = {}
            for i, spec in enumerate(sb):
                if spec.mixer == "attn":
                    if cfg.mla_kv_lora:
                        c = attn_mod.init_mla_cache(cfg, B, S, dtype, dev)
                    else:
                        c = attn_mod.init_gqa_cache(cfg, B, S, dtype, dev)
                else:
                    c = ssm_mod.init_mamba2_cache(cfg, B, dtype, dev)
                blks[f"blk{i}"] = c
            reps.append(blks)
        segs.append(reps)
    return {"segments": segs}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_block(cfg, pcfg, spec, p, x, batch, cache, aux,
                 want_cache=True):
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    if spec.mixer == "attn":
        fn = attn_mod.mla if cfg.mla_kv_lora else attn_mod.gqa
        out, new_cache = fn(cfg, pcfg, p.attn, h, batch, cache)
    else:
        out, new_cache = ssm_mod.mamba2(cfg, pcfg, p.mamba, h, batch, cache)
    if not want_cache:
        new_cache = None
    x = x + out
    if spec.ffn != "none":
        h = rms_norm(x, p.norm2, cfg.norm_eps)
        if spec.ffn == "dense":
            x = x + swiglu(h, p.mlp.w1, p.mlp.w3, p.mlp.w2)
        else:
            out, moe_aux = moe_mod.moe(cfg, pcfg, p.moe, h)
            x = x + out
            aux = aux + moe_aux["lb_loss"]
    return x, new_cache, aux


def _apply_superblock(cfg, pcfg, sb, blocks, x, batch, caches, aux,
                      want_cache=True):
    new_caches = {}
    for i, spec in enumerate(sb):
        cache_i = None if caches is None else caches[f"blk{i}"]
        x, nc, aux = _apply_block(cfg, pcfg, spec, getattr(blocks, f"blk{i}"),
                                  x, batch, cache_i, aux, want_cache)
        new_caches[f"blk{i}"] = nc
    return x, (new_caches if want_cache else None), aux


def forward(cfg: ModelConfig, pcfg: ParallelConfig, model: Model, batch,
            cache: Optional[dict] = None, want_cache: bool = True,
            return_hidden: bool = False):
    """Returns (logits f32, new_cache, aux_loss).

    batch: {"tokens": (B,S) int} or {"embeds": (B,S,d)}; optional
    "positions" ((B,S) or (B,S,3) for M-RoPE).  want_cache=False
    (training) keeps no cache.  ``aux`` sums the MoE layers' load-balancing
    losses.  return_hidden=True returns the final-normed hidden states in
    place of the logits (the caller projects: last-token-only prefill).
    """
    cdt = _dtype(pcfg.compute_dtype)
    if cfg.embed_inputs:
        x = model.embed[batch["tokens"]].to(cdt)
    else:
        x = batch["embeds"].to(cdt)

    new_segs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (sb, _) in enumerate(cfg.segments):
        seg_c = cache["segments"][si] if cache is not None else None
        reps = []
        for ri, blocks in enumerate(model.segments[si]):
            x, nc, aux = _apply_superblock(
                cfg, pcfg, sb, blocks, x, batch,
                None if seg_c is None else seg_c[ri], aux, want_cache)
            reps.append(nc)
        new_segs.append(reps)

    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    new_cache = {"segments": new_segs} if want_cache else None
    if return_hidden:
        return x, new_cache, aux
    head = (model.embed.T if cfg.tie_embeddings else model.head).to(cdt)
    return (x @ head).float(), new_cache, aux
