"""Model assembly: segments of super-blocks, looped over repeats.

Port of ``repro.models.model``.  A config's layer stack is a list of
(super_block, repeat) segments.  The model is an ``nn.Module``:
``segments[s]`` is a ``ModuleList`` of the segment's repeats, each a
:class:`SuperBlock` holding one :class:`Block` a layer (``blk0``,
``blk1``, ...), and the forward loops over the repeats where the
reference scans over stacked parameters.  A cache mirrors that layout:
``{"segments": [[{"blk0": entry, ...} for each repeat] for each
segment]}``, one entry a layer.

The partition specs (``param_specs``, ``cache_specs``) are the
reference's rules keyed by the port's parameter and cache names, without
the reference's leading scan axis (a segment's repeats are a
``ModuleList``).  The port executes both axes of a mesh: ``data`` (the
train step's ``group``: each rank holds rows of the global batch, see
``models/moe.py``) and ``model``: under an installed mesh with ``model
> 1`` (``sharding.set_mesh``) the forward runs on the leaves' shards
(drawn by :func:`init_sharded`, or kept from a whole model by
``distributed.tensor_parallel.shard_model``), Megatron-style
(:func:`_forward_tp`; ``seq_parallel`` and ``dp_over_model`` as the
reference reads them).  Every forward runs that code, with or without a
cache, on one process's whole leaves as a group of one.  A serving
forward keeps a cache placed as :func:`init_cache` places it (the
sanitized ``cache_specs``: this rank's positions under
``seq_shard_decode``, its heads of the SSM state, its channels of the
conv window).  Under FSDP (``distributed/fsdp.py``: leaves split over
the data axis, drawn by :func:`init_sharded`) each block gathers its
leaves at its start, and ``ParallelConfig.remat`` runs each block under
``torch.utils.checkpoint``; a forward that keeps a cache refuses leaves
that FSDP split (:data:`SERVE_FSDP`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import device as _device
from repro_torch.distributed import fsdp as fsdp_mod
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Init, init_mlp, init_rms, swiglu_tp


def _dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def batch_axes(pcfg):
    axes = ((pcfg.pod_axis, pcfg.data_axis) if pcfg.pod_axis
            else (pcfg.data_axis,))
    if pcfg.dp_over_model:
        axes = axes + (pcfg.model_axis,)
    return axes


#: why the cached forward refuses a model whose leaves FSDP has split
SERVE_FSDP = ("FSDP splits leaves over the data axis for training; the "
              "cached (serving) forward runs on whole leaves")


def constrain(x, *spec):
    """The activation sharding constraint: ``x`` itself.  Under the
    installed mesh the ``data`` axis is each rank's own rows already, and
    the layers place the ``model`` axis themselves (``_forward_tp``)."""
    del spec
    return x


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


class _Made(Init):
    """A meta Init that lists the parameters in the order it makes
    them."""

    def __init__(self, dtype):
        super().__init__(None, dtype, "meta")
        self.made = []

    def _param(self, x):
        p = super()._param(x)
        self.made.append(p)
        return p


def init_sharded(cfg: ModelConfig, pcfg: ParallelConfig,
                 generator: torch.Generator, mesh, fsdp: bool = True,
                 param_dtype: str = "float32", device=None) -> Model:
    """:func:`init_params` sharded as it is drawn: the leaves come from
    ``generator`` in init_params' order, one whole leaf at a time, and
    each keeps this rank's shard over the mesh's model axis and, under
    ``fsdp``, its data axis (``tensor_parallel.placement``) before the
    next is drawn.  A card holds its shards and one whole leaf at most.
    Equal bit for bit to ``tensor_parallel.shard_model(cfg, pcfg,
    init_params(...), mesh, fsdp)``."""
    dt = _dtype(param_dtype)
    made = _Made(dt)
    meta = Model(made, cfg)
    names = {id(p): n for n, p in meta.named_parameters()}
    order = iter([names[id(p)] for p in made.made])
    dims = tpm.placement(cfg, pcfg, meta, mesh, fsdp)
    tp = tpm.of_mesh(mesh, pcfg)
    fs = fsdp_mod.of_mesh(mesh, pcfg) if fsdp else None
    del meta, made

    def keep(whole):
        return tpm.local_leaf(whole, dims[next(order)], tp, fs)
    with torch.no_grad():
        model = Model(Init(generator, dt, _device.resolve(device), keep),
                      cfg)
    return tpm.mark(model, dims, tp, fs)


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16,
               device=None, pcfg: Optional[ParallelConfig] = None,
               mesh=None):
    """Static KV/SSM cache mirroring the segment structure.  With
    ``pcfg``, under ``mesh`` (default: the installed one) each leaf is
    only this rank's slice of the whole (:func:`cache_placement`), its
    model-axis split recorded (``tensor_parallel.placed``)."""
    dev = _device.resolve(device)
    whole_dev = "meta" if pcfg is not None else dev
    segs = []
    for sb, cnt in cfg.segments:
        reps = []
        for _ in range(cnt):
            blks = {}
            for i, spec in enumerate(sb):
                if spec.mixer == "attn":
                    if cfg.mla_kv_lora:
                        c = attn_mod.init_mla_cache(cfg, B, S, dtype,
                                                    whole_dev)
                    else:
                        c = attn_mod.init_gqa_cache(cfg, B, S, dtype,
                                                    whole_dev)
                else:
                    c = ssm_mod.init_mamba2_cache(cfg, B, dtype, whole_dev)
                blks[f"blk{i}"] = c
            reps.append(blks)
        segs.append(reps)
    cache = {"segments": segs}
    if pcfg is None:
        return cache
    mesh = sharding.current_mesh() if mesh is None else mesh
    sizes = {} if mesh is None else mesh.axis_sizes

    def local(_, x, dims):
        shape = list(x.shape)
        for dim, axis in zip(dims, (pcfg.model_axis, pcfg.data_axis)):
            if dim is not None:
                shape[dim] //= sizes[axis]
        return tpm.placed(torch.zeros(shape, dtype=x.dtype, device=dev),
                          dims[0])
    return _cache_map(local, cache, cache_placement(cfg, pcfg, cache, mesh))


def _cache_map(fn, cache, *others):
    """``fn(leaf name, leaf, each of others' leaves)`` at each leaf of a
    tree of :func:`init_cache`'s structure."""
    return {"segments": [[{blk: {
        name: fn(name, x, *(o["segments"][si][ri][blk][name] for o in others))
        for name, x in entry.items()} for blk, entry in rep.items()}
        for ri, rep in enumerate(seg)]
        for si, seg in enumerate(cache["segments"])]}


def cache_placement(cfg: ModelConfig, pcfg: ParallelConfig, cache, mesh):
    """``cache``'s structure with ``(dimension split over the model axis,
    over the data axis)`` a leaf, each None where that axis does not
    split it: :func:`cache_specs` sanitized on the whole shapes
    (``cache``'s leaves; the meta device will do), as the reference's
    serving cells place their caches.  One difference by design: without
    ``seq_shard_decode`` a GQA cache's ``k``/``v`` keep the KV heads that
    this rank's column shard of ``wk``/``wv`` makes (where they split:
    ``n_kv_heads % model == 0``), where ``cache_specs`` keeps them whole
    on every model rank.  The model axis splits nothing where the forward
    does not run on it (no mesh, one model rank, ``dp_over_model``)."""
    sizes = {} if mesh is None else mesh.axis_sizes
    specs = sharding.sanitize_tree(cache_specs(cfg, pcfg, cache), cache,
                                   sizes)
    tp = None if mesh is None else tpm.of_mesh(mesh, pcfg)
    m = 1 if tp is None else tp.size
    rows = sizes.get(pcfg.data_axis, 1) > 1

    def axis_dim(spec, axis):
        return next((i for i, e in enumerate(spec) if e == axis or (
            isinstance(e, tuple) and axis in e)), None)

    def dims(name, spec):
        td = axis_dim(spec, pcfg.model_axis) if m > 1 else None
        if name in ("k", "v") and m > 1 and not pcfg.seq_shard_decode \
                and cfg.n_kv_heads % m == 0:
            td = 2
        return td, axis_dim(spec, pcfg.data_axis) if rows else None
    return _cache_map(lambda name, _, spec: dims(name, spec), cache, specs)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, pcfg: ParallelConfig, model: Model, batch,
            cache: Optional[dict] = None, want_cache: bool = True,
            return_hidden: bool = False, group=None):
    """Returns (logits f32, new_cache, aux_loss).

    batch: {"tokens": (B,S) int} or {"embeds": (B,S,d)}; optional
    "positions" ((B,S) or (B,S,3) for M-RoPE).  want_cache=False
    (training) keeps no cache.  ``aux`` sums the MoE layers' load-balancing
    losses.  return_hidden=True returns the final-normed hidden states in
    place of the logits (the caller projects: last-token-only prefill).
    ``group``: the data-parallel group whose ranks hold consecutive rows
    of one global batch (MoE routing and ``aux`` are the global batch's,
    ``aux`` this rank's share; ``models/moe.py``).  Runs
    :func:`_forward_tp`: on the installed mesh's model group, or on this
    process's whole leaves as a group of one; a cache is placed as
    :func:`init_cache` places it.
    """
    tp = tpm.active(pcfg)
    serving = cache is not None or want_cache
    if serving and getattr(model, "fsdp_shards", None) is not None:
        raise NotImplementedError(SERVE_FSDP)
    tpm.check_sharded(model, tp)
    return _forward_tp(cfg, pcfg, fsdp_mod.view(model, pcfg), batch,
                       return_hidden, group, tp or tpm.ONE, cache,
                       want_cache)


# ---------------------------------------------------------------------------
# forward under tensor parallelism
# ---------------------------------------------------------------------------

def _apply_block_tp(cfg, pcfg, spec, p, x, batch, aux, group, tp,
                    cache=None, serving=False):
    """One layer on the leaves' shards: each sublayer enters from the
    residual stream and exits onto it (``tensor_parallel.TP``).  Returns
    ``(x, aux, new cache entry)``, the entry None unless ``serving``."""
    h = tp.enter(tpm.rms_norm(x, p.norm1, cfg.norm_eps, tp))
    if spec.mixer == "attn":
        fn = attn_mod.mla_tp if cfg.mla_kv_lora else attn_mod.gqa_tp
        res = fn(cfg, pcfg, p.attn, h, batch, tp, cache, serving)
    else:
        res = ssm_mod.mamba2_tp(cfg, pcfg, p.mamba, h, tp, cache, serving)
    (part, rep), new = res if serving else (res, None)
    x = x + tp.exit(part, rep)
    if spec.ffn != "none":
        h = tp.enter(tpm.rms_norm(x, p.norm2, cfg.norm_eps, tp))
        if spec.ffn == "dense":
            part, rep = swiglu_tp(h, p.mlp.w1, p.mlp.w3, p.mlp.w2)
        else:
            (part, rep), moe_aux = moe_mod.moe_tp(cfg, pcfg, p.moe, h, tp,
                                                 group=group)
            aux = aux + moe_aux["lb_loss"]
        x = x + tp.exit(part, rep)
    return x, aux, new


def embed_tp(cfg, model, batch, cdt, tp):
    """The residual stream's start: a vocab-parallel lookup (this rank's
    rows of ``embed``, zero elsewhere, summed over the group) where the
    table is split, else the replicated input."""
    if not cfg.embed_inputs:
        return tp.exit(replicated=batch["embeds"].to(cdt))
    tok = batch["tokens"]
    if tpm.shard_dim(model.embed) != 0:
        # F.embedding: its backward sums each row's gradients in a fixed
        # order (indexing's backward accumulates in thread order on the
        # CPU)
        return tp.exit(replicated=F.embedding(tok, model.embed).to(cdt))
    rows = model.embed.shape[0]
    local = tok - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    e = F.embedding(torch.where(inside, local, 0), model.embed)
    return tp.exit(partial=torch.where(inside[..., None], e, 0.0).to(cdt))


def vocab_head(cfg, model):
    """(head (d, vocab or this rank's vocab columns), its first vocab
    id, or None where the head is whole)."""
    w = model.embed if cfg.tie_embeddings else model.head
    split = tpm.shard_dim(w) == (0 if cfg.tie_embeddings else 1)
    head = w.T if cfg.tie_embeddings else w
    if not split:
        return head, None
    return head, model.tp_shards[1] * head.shape[1]


def logits_tp(cfg, model, x, tp, cdt=None):
    """The logits (float32) of final-normed hidden states ``x``, the
    residual stream's positions under ``tp`` (this rank's under
    ``seq_parallel``), of every position: through the whole head, or this
    rank's vocab columns of it gathered whole."""
    h = tp.enter(x)
    head, lo = vocab_head(cfg, model)
    cdt = x.dtype if cdt is None else cdt
    if lo is None:
        return (h.rep @ head.to(cdt)).float()
    return tp.gather(h.par @ head.to(cdt), -1).float()


def _forward_tp(cfg, pcfg, model, batch, return_hidden, group, tp,
                cache=None, want_cache=False):
    """:func:`forward` on the leaves' shards, or on one process's whole
    leaves under ``tensor_parallel.ONE``.  Without a cache (training) the
    returned hidden states are this rank's positions under
    ``seq_parallel``; logits are gathered whole.  ``model`` is
    ``fsdp.view``'s: each block gathers its FSDP-split leaves at its
    start.  Under ``pcfg.remat`` "full" or "dots" (alike, as in the
    reference) each block of a training forward runs under
    ``torch.utils.checkpoint``, its gathers inside: the backward
    recomputes the block, gathering again, so a block's whole leaves live
    only while it runs; the values are those without remat, bit for bit.
    Without remat the gathered leaves that the block's backward reads
    stay alive until it runs.

    With a cache, or ``want_cache`` (serving), each layer reads and
    writes its cache entry and no block is recomputed; a step whose
    positions do not split over the group's ``seq_parallel`` (a decode
    step's one) runs without the sequence split (the same values:
    tests/test_torch_tp.py holds ``seq_parallel`` to TP bit for bit), and
    returned hidden states are the whole sequence."""
    cdt = _dtype(pcfg.compute_dtype)
    serving = cache is not None or want_cache
    S = next(iter(batch.values())).shape[1]
    if tp.seq and S % tp.size:
        if not serving:
            raise ValueError(f"seq_parallel: {S} positions do not split "
                             f"over {tp.size} model ranks")
        tp = dataclasses.replace(tp, seq=False)
    if pcfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f"{pcfg.remat!r}")
    fs = fsdp_mod.group_of(model)
    x = embed_tp(cfg, model, batch, cdt, tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_segs = []
    for si, (sb, _) in enumerate(cfg.segments):
        reps = []
        for ri, blocks in enumerate(model.segments[si]):
            entries = {}
            for i, spec in enumerate(sb):
                key = f"blk{i}"
                entry = (None if cache is None
                         else cache["segments"][si][ri][key])

                def run(x, aux, spec=spec, blk=getattr(blocks, key),
                        entry=entry):
                    return _apply_block_tp(cfg, pcfg, spec,
                                           fsdp_mod.gathered(blk, fs), x,
                                           batch, aux, group, tp, entry,
                                           serving)
                if serving or pcfg.remat == "none":
                    x, aux, entries[key] = run(x, aux)
                else:
                    x, aux = checkpoint(lambda x, aux, run=run: run(
                        x, aux)[:2], x, aux, use_reentrant=False)
            reps.append(entries)
        new_segs.append(reps)
    new_cache = {"segments": new_segs} if want_cache else None
    x = tpm.rms_norm(x, model.final_norm, cfg.norm_eps, tp)
    if return_hidden:
        return (tp.cat(x, 1) if serving and tp.seq else x), new_cache, aux
    return logits_tp(cfg, model, x, tp, cdt), new_cache, aux


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------

def stacked_specs(cfg: ModelConfig, pcfg: ParallelConfig, model: Model):
    """``{parameter name: (P, shape, stacked)}``: the reference's spec
    and shape of the leaf that holds this one, Megatron-style TP over the
    "model" axis (fully replicated when dp_over_model re-purposes the
    axis as data parallelism).  A repeating segment's leaf is held by the
    reference's stacked leaf (one dimension more, the scan axis, in
    front; ``stacked`` True); any other leaf by itself."""
    P = sharding.P
    mdl = None if pcfg.dp_over_model else pcfg.model_axis

    def rule(names, rank):

        def lead(spec2):
            return P(*((None,) * (rank - len(spec2)) + spec2))

        if "embed" in names:
            return P(mdl, None)
        if "head" in names:
            return P(None, mdl)
        if "moe" in names:
            if names[-1] in ("w1", "w3", "w2"):          # (E, d, ff)
                return lead((mdl, None, None))
            return lead((None,))                         # router, shared
        if names[-1] in ("wq", "wk", "wv", "w1", "w3", "in_proj",
                         "wuk", "wuv"):
            return lead((None, mdl))
        if names[-1] in ("wo", "w2", "out_proj"):
            return lead((mdl, None))
        if names[-1] in ("wdkv", "wkpe"):
            return lead((None, None))
        return lead(())                                  # norms, scalars

    out = {}
    for name, x in model.named_parameters():
        names = name.split(".")
        shape = tuple(x.shape)
        cnt = cfg.segments[int(names[1])][1] if names[0] == "segments" \
            else 1
        if cnt > 1:
            out[name] = (rule(names, x.ndim + 1), (cnt,) + shape, True)
        else:
            out[name] = (rule(names, x.ndim), shape, False)
    return out


def param_specs(cfg: ModelConfig, pcfg: ParallelConfig, model: Model):
    """``{parameter name: P}``: the reference's rules on the port's names
    (:func:`stacked_specs`).  A repeating segment's leaf gets the spec of
    its stacked leaf with that first entry dropped, its quirks kept (a
    stacked shared expert's ``w1`` has "model" on the scan axis, so none
    on its own)."""
    return {name: sharding.P(*spec[1:]) if stacked else spec
            for name, (spec, _, stacked) in stacked_specs(
                cfg, pcfg, model).items()}


def cache_specs(cfg: ModelConfig, pcfg: ParallelConfig, cache):
    """Shard caches: batch over data(+pod); seq-shard long caches if
    asked.  ``cache``'s structure (``init_cache``) with a P a leaf."""
    del cfg
    P = sharding.P
    baxes = ((pcfg.pod_axis, pcfg.data_axis) if pcfg.pod_axis
             else (pcfg.data_axis,))

    def rule(leaf, x):
        rank = x.ndim
        if leaf == "pos":
            return P(*((None,) * (rank - 1) + (baxes,)))
        lead = (None,) * (rank - 4)
        seq = pcfg.model_axis if pcfg.seq_shard_decode else None
        if leaf in ("k", "v"):           # (B, S, Kv, hd)
            return P(*lead, baxes, seq, None, None)
        if leaf in ("c_kv", "k_pe"):     # (B, S, l)
            lead3 = (None,) * (rank - 3)
            return P(*lead3, baxes, seq, None)
        if leaf == "ssm":                # (B, H, P, N)
            return P(*lead, baxes, pcfg.model_axis, None, None)
        if leaf == "conv":               # (B, K-1, C)
            lead3 = (None,) * (rank - 3)
            return P(*lead3, baxes, None, pcfg.model_axis)
        return P(*((None,) * rank))

    return _cache_map(rule, cache)
