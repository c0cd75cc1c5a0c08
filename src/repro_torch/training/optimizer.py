"""AdamW with decoupled weight decay, cosine schedule, global grad clip.

Port of ``repro.training.optimizer``, the same formula: the global-norm
clip, bias corrections in float32 and weight decay on every leaf, norms
included.  Parameters and gradients are ``{name: tensor}`` (a model's
``named_parameters()``); the state is ``{"mu": {name: float32 tensor},
"nu": ..., "step": int32 tensor}`` on the parameters' device.  The
update runs in place under ``torch.no_grad()``, its scalars (clip
scale, learning rate, bias corrections) on the device, so a step reads
nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 1000


def _named(params) -> dict:
    """``{name: tensor}`` of a model (its parameters) or a dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params):
    """Zero moments in float32 beside each parameter, step 0."""
    named = _named(params)
    dev = next(iter(named.values())).device
    return {"mu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (an int tensor): linear warmup, then a
    cosine from lr to 0.1 lr, in float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads, params=None, model_group=None,
                data_group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32.  Under
    tensor parallelism (``model_group``, a ``tensor_parallel.TP``) the
    leaves of ``params`` that are shards (``tp_dim``) add their squares
    over the group in rank order, and under FSDP (``data_group``) those
    split over the data axis (``fsdp_dim``) over that group (a leaf
    split over both: the data group's sum, then the model group's); each
    replicated leaf counts once, so every rank gets the one-rank norm's
    sum."""
    if model_group is None and data_group is None:
        leaves = [torch.sum(torch.square(g.float())) for g in grads.values()]
        return torch.sqrt(sum(leaves))
    from repro_torch.distributed.tensor_parallel import fsdp_dim, shard_dim

    def split(p):
        return (model_group is not None and shard_dim(p) is not None,
                data_group is not None and fsdp_dim(p) is not None)
    kind = {n: split(p) for n, p in params.items()}
    sq = {n: torch.sum(torch.square(g.float())) for n, g in grads.items()}
    whole = sum(v for n, v in sq.items() if kind[n] == (False, False))
    for key, over in (((True, False), (model_group,)),
                      ((False, True), (data_group,)),
                      ((True, True), (data_group, model_group))):
        part = [v for n, v in sq.items() if kind[n] == key]
        if part:
            total = sum(part)
            for grp in over:
                total = grp.sum(total)
            whole = whole + total
    return torch.sqrt(whole)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, model_group=None,
                 data_group=None):
    """One AdamW step on ``params`` and ``state`` in place; returns the
    metrics ``{"grad_norm", "lr"}`` (device scalars).  ``model_group``,
    ``data_group``: see :func:`global_norm` (the moments are shards like
    their leaves)."""
    params = _named(params)
    step = state["step"] + 1
    gnorm = global_norm(grads, params, model_group, data_group)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=sf.device), sf)
    for name, p in params.items():
        g = grads[name].float() * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(torch.square(g) * (1 - b2))
        del g
        delta = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
