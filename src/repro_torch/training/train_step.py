"""Loss and train step builders.

Port of ``repro.training.train_step``.  ``make_train_step`` returns a
step that takes the model (an ``nn.Module``), the optimizer state and a
batch, runs forward and backward with microbatch gradient accumulation,
and updates the parameters in place (the reference returns new ones).

**Data parallelism** over the mesh's ``data`` axis (``launch/mesh.py``):
each rank holds rows [lo, hi) of the global batch (:func:`data_rows`)
and computes its share of the global loss: the cross-entropy's token sum
over the *global* mask count, and the MoE load-balancing loss over the
global token set (``models/moe.py``, which also routes over the global
token order).  The shares' gradients are summed over the ``data`` group
in one fixed order (every rank sums the all-gathered gradients in rank
order, :func:`ordered_sum`), so every rank applies the same update and
the replicas stay equal bit for bit.

**Tensor parallelism** over the ``model`` axis
(``distributed/tensor_parallel.py``): the model holds this rank's
shards (``tensor_parallel.shard_model``), every model rank takes the
same rows, the cross-entropy is vocab-parallel (:func:`chunked_ce`: the
row max and the sum of exponentials over the model group, the target's
logit from the rank that holds it), a sharded leaf's gradient stays
this rank's shard and a replicated one comes out whole (it is not
summed over the model group again), and the clip's norm counts each
shard once (``optimizer.global_norm``).  Under ``dp_over_model`` the
model axis is more data parallelism: the leaves stay whole and the rows
split over data x model.

**FSDP** over the ``data`` axis (``distributed/fsdp.py``; a model whose
leaves ``fsdp_shards`` records): a split leaf's gradient arrives
reduce-scattered from its gather's backward, this rank's shard of the
rank-order sum, so :func:`ordered_sum` takes only the other leaves, and
the clip's norm adds the shards' squares over the data group.  With
``microbatch > 1`` each microbatch's backward reduce-scatters, and the
shard accumulates the microbatches' sums: (sum over ranks of mb 0) +
(sum over ranks of mb 1), where the replicated path sums each rank's
accumulated gradient, so those bits differ by rounding.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.distributed import fsdp as fsdp_mod
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt

#: gradients are summed in buckets of this many float32 elements
SUM_BUCKET = 1 << 26


def ordered_sum(tensors, group) -> None:
    """Replace each tensor by its sum over ``group``, in place: the
    ranks' copies all-gathered (in buckets of SUM_BUCKET elements) and
    added in rank order on every rank, so every rank holds the same bits
    whatever the backend's reduction order.  ``group`` None: nothing."""
    if group is None or not tensors:
        return
    import torch.distributed as dist
    world = dist.get_world_size(group)
    dtype, dev = tensors[0].dtype, tensors[0].device
    bucket, size = [], 0
    for t in tensors + [None]:
        if t is not None and (not bucket or size + t.numel() <= SUM_BUCKET):
            bucket.append(t)
            size += t.numel()
            continue
        flat = torch.cat([b.reshape(-1) for b in bucket])
        parts = torch.empty((world, flat.numel()), dtype=dtype, device=dev)
        dist.all_gather(list(parts.unbind(0)), flat, group=group)
        total = parts[0].clone()
        for r in range(1, world):
            total += parts[r]
        off = 0
        for b in bucket:
            b.copy_(total[off:off + b.numel()].view(b.shape))
            off += b.numel()
        del flat, parts, total
        bucket, size = ([t], t.numel()) if t is not None else ([], 0)


def _chunk_nll(h, head, t, mk):
    logits = (h @ head).float()
    logits = M.constrain(logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mk)


class _VocabNLL(torch.autograd.Function):
    """The token NLL sum of logits split over the vocab: (B, c, V/m)
    this rank's columns from vocab id ``lo``.  The row max, the sum of
    exponentials and the target's logit are combined over the model
    group in rank order; the backward is softmax - onehot on this rank's
    columns."""

    @staticmethod
    def forward(ctx, logits, t, mk, lo, tp):
        cols = logits.shape[-1]
        gmax = tp.max(logits.amax(-1))
        e = torch.exp(logits - gmax[..., None])
        se = tp.sum(e.sum(-1))
        local = t.long() - lo
        inside = (local >= 0) & (local < cols)
        idx = torch.where(inside, local, 0)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = tp.sum(torch.where(inside, gold, 0.0))
        ctx.save_for_backward(e, se, idx, inside, mk)
        return torch.sum((torch.log(se) + gmax - gold) * mk)

    @staticmethod
    def backward(ctx, g):
        e, se, idx, inside, mk = ctx.saved_tensors
        d = e / se[..., None]
        d.scatter_add_(-1, idx[..., None], -inside.to(d.dtype)[..., None])
        return d * (g * mk)[..., None], None, None, None, None


def _chunk_nll_tp(h, head, t, mk, lo, tp):
    return _VocabNLL.apply((h @ head).float(), t, mk, lo, tp)


def chunked_ce(hidden, head, targets, mask, chunk: int = 512, group=None,
               tp=None, vocab_lo=None):
    """Cross-entropy over sequence chunks.

    The (B, S, vocab) logits are never held beyond one chunk: each
    chunk's body runs under ``checkpoint`` so the backward recomputes
    its logits instead of saving them.  The token sum is divided by the
    mask count summed over ``group`` (the global batch's).  Under ``tp``
    ``hidden`` comes from the residual stream (this rank's positions
    under ``seq_parallel``) and, where ``vocab_lo`` is given, ``head``
    holds this rank's vocab columns from that id (vocab-parallel)."""
    if tp is not None:
        h = tp.enter(hidden)
        hidden = h.rep if vocab_lo is None else h.par
    B, S, d = hidden.shape
    if S % chunk or S <= chunk:
        chunk = S
    tot = hidden.new_zeros((), dtype=torch.float32)
    for s in range(0, S, chunk):
        part = (hidden[:, s:s + chunk], head, targets[:, s:s + chunk],
                mask[:, s:s + chunk])
        if vocab_lo is None:
            tot = tot + checkpoint(_chunk_nll, *part, use_reentrant=False)
        else:
            tot = tot + checkpoint(_chunk_nll_tp, *part, vocab_lo, tp,
                                   use_reentrant=False)
    count = mask.sum()
    ordered_sum([count], group)
    return tot / torch.clamp_min(count, 1.0)


def lm_loss(cfg: ModelConfig, pcfg: ParallelConfig, model, batch,
            aux_weight: float = 0.01, group=None):
    """Next-token CE in f32 (+ MoE load-balance aux).  Under ``group``
    the batch is this rank's rows and the loss its share of the global
    batch's (the shares sum to it)."""
    model = fsdp_mod.view(model, pcfg)
    hidden, _, aux = M.forward(cfg, pcfg, model, batch, want_cache=False,
                               return_hidden=True, group=group)
    cdt = hidden.dtype
    tp = tpm.active(pcfg)
    head, lo = M.vocab_head(cfg, model)
    head = head.to(cdt)
    targets = batch["labels"]
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=targets.device)
    if cfg.causal:   # predict token t+1 at position t; mask the last slot
        tgt = torch.cat([targets[:, 1:], targets[:, :1]], dim=1)
        mask[:, -1] = 0.0
    else:            # encoder: per-frame classification
        tgt = targets
    nll = chunked_ce(hidden, head, tgt, mask, group=group, tp=tp,
                     vocab_lo=lo)
    loss = nll + aux_weight * aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


def data_rows(mesh, global_batch: int, dp_over_model: bool = False):
    """The rows [lo, hi) of the global batch this rank's ``data`` index
    holds (all of them without a mesh; every model rank the same ones,
    unless ``dp_over_model`` splits them over the model axis too)."""
    if mesh is None:
        return 0, global_batch
    axes = len(mesh.ranks.shape) - (0 if dp_over_model else 1)
    batch_shape = mesh.ranks.shape[:axes]
    n = int(np.prod(batch_shape))
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} data ranks")
    per = global_batch // n
    i = int(np.ravel_multi_index(mesh.coords[:axes], batch_shape))
    return i * per, (i + 1) * per


def batch_group(mesh, pcfg):
    """The group whose ranks hold the global batch's rows: the data
    group, or under ``dp_over_model`` the whole mesh (which must then be
    the world: its group is the world's)."""
    if mesh is None:
        return None
    if not pcfg.dp_over_model or mesh.axis_sizes.get(pcfg.model_axis,
                                                     1) == 1:
        return mesh.data_group
    import torch.distributed as dist
    if mesh.group is None or dist.get_world_size(mesh.group) != mesh.size:
        raise ValueError("dp_over_model: the mesh must span the world")
    return mesh.group


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    tcfg: TrainConfig, mesh, opt_cfg: Optional[
                        opt.AdamWConfig] = None):
    """Returns (step_fn, shardings_for, jit_step).

    step_fn(model, opt_state, batch) -> metrics updates the model's
    parameters and ``opt_state`` in place; ``batch`` is this rank's rows
    (:func:`data_rows`), and under a model axis the model holds this
    rank's shards (``tensor_parallel.shard_model``; the step installs
    ``mesh`` while it runs).  ``shardings_for(model)`` returns the placements
    (param specs sanitized for the mesh; the optimizer's moments share
    them), and ``jit_step(param_sh, opt_sh, batch_sh)`` the step bound to
    the mesh (eager: nothing is compiled).
    """
    group = batch_group(mesh, pcfg)
    opt_cfg = opt_cfg or opt.AdamWConfig(
        lr=tcfg.lr, beta1=tcfg.beta1, beta2=tcfg.beta2,
        weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
        warmup=tcfg.warmup, total_steps=tcfg.steps)

    def step(model, opt_state, batch):
        if mesh is None:
            return run(model, opt_state, batch)
        prev = sharding.current_mesh()
        sharding.set_mesh(mesh)
        try:
            return run(model, opt_state, batch)
        finally:
            sharding.set_mesh(prev)

    def run(model, opt_state, batch):
        tp = tpm.active(pcfg)
        tpm.check_sharded(model, tp)
        fs = None
        if getattr(model, "fsdp_shards", None) is not None:
            fs = fsdp_mod.of_mesh(mesh, pcfg)
            fsdp_mod.check(model, fs)
        nmicro = tcfg.microbatch or 1
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        rows = next(iter(batch.values())).shape[0]
        if rows % nmicro:
            raise ValueError(f"{rows} rows do not split into {nmicro} "
                             f"microbatches")
        per = rows // nmicro
        for i in range(nmicro):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, metrics = lm_loss(cfg, pcfg, model, mb, group=group)
            loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if nmicro > 1:
            for g in grads.values():
                g.div_(nmicro)
        metrics = {k: v.detach().reshape(1) for k, v in metrics.items()}
        # an FSDP-split leaf's gradient arrives reduce-scattered
        ordered_sum([g for n, g in grads.items()
                     if tpm.fsdp_dim(params[n]) is None], group)
        ordered_sum(list(metrics.values()), group)
        metrics = {k: v[0] for k, v in metrics.items()}
        kw = {} if tp is None else {"model_group": tp}
        if fs is not None:
            kw["data_group"] = fs
        om = opt.adamw_update(opt_cfg, params, grads, opt_state, **kw)
        for p in params.values():
            p.grad = None
        return dict(metrics, **om)

    def shardings_for(model):
        axis_sizes = mesh.axis_sizes if mesh is not None else {}
        if getattr(model, "fsdp_shards", None) is not None:
            param_sh = sharding.fsdp_specs(cfg, pcfg, M.empty_model(cfg),
                                           mesh)
            return param_sh, {"mu": param_sh, "nu": param_sh,
                              "step": sharding.P()}
        specs = M.param_specs(cfg, pcfg, model)
        param_sh = sharding.sanitize_tree(
            specs, dict(model.named_parameters()), axis_sizes)
        opt_sh = {"mu": param_sh, "nu": param_sh, "step": sharding.P()}
        return param_sh, opt_sh

    def jit_step(param_sh, opt_sh, batch_sh):
        del param_sh, opt_sh, batch_sh
        return step

    return step, shardings_for, jit_step
