"""Mamba2 block via the SSD (state-space duality) chunked algorithm.

Port of ``repro.models.ssm``.  Prefill computes the sequence in chunks:
a quadratic attention-like intra-chunk term plus an inter-chunk state
recurrence (a loop over the chunks where the reference scans) -- the
chunked SSD formulation of Dao & Gu (arXiv:2405.21060) as batched
matmuls.  Decode keeps a recurrent state (B, H, P, N) and a small conv
window, updated in O(1) per token.

Shapes: d_inner = expand*d_model, H = d_inner/head_dim heads, state N.
Single B/C group (G=1), scalar A per head (Mamba2 simplification).

The block's math is written once, on the leaves' shards under a model
group (``mamba2_tp``); ``mamba2`` is that body on the group of one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models.layers import Init, rms_norm


class Mamba2(nn.Module):
    """Weights of a Mamba2 block; in_proj emits [z (gate), x, B, C, dt]."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d = cfg.d_model
        din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = din + 2 * N
        self.in_proj = init.normal((d, 2 * din + 2 * N + H), 0.02)
        self.conv_w = init.normal((cfg.ssm_conv, conv_dim), 0.2)
        self.conv_b = init.full((conv_dim,), 0.0)
        self.A_log = init.full((H,), 0.0)        # A = -exp(A_log) in (-1,0]
        self.D = init.full((H,), 1.0)
        self.dt_bias = init.full((H,), -2.0)     # softplus(-2) ~ 0.13
        self.out_proj = init.normal((din, d), 0.02)
        self.norm = init.full((din,), 1.0)


def init_mamba2(init: Init, cfg) -> Mamba2:
    return Mamba2(init, cfg)


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv, kernel K: xBC (B, S, C).  state: (B, K-1, C)."""
    K = w.shape[0]
    pad = torch.zeros_like(xBC[:, :K - 1]) if state is None else state
    xp = torch.cat([pad, xBC], dim=1)                    # (B, S+K-1, C)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu((out + b[None, None, :]).float()).to(xBC.dtype), new_state


def _ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) positive, A (H,) negative, Bm/Cm (B,S,N).
    Returns y (B,S,H,P), final state (B,H,P,N).
    """
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"_ssd_chunked: chunk={chunk} does not divide "
                         f"S={S}")
    nc = S // chunk
    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = Bm.reshape(Bb, nc, chunk, N)
    Cc = Cm.reshape(Bb, nc, chunk, N)

    dA = dtc * A[None, None, None, :]                   # (B,nc,Q,H) negative
    cum = torch.cumsum(dA, dim=2)                       # within-chunk cumsum
    total = cum[:, :, -1]                               # (B,nc,H)

    # intra-chunk (quadratic) term: attention-like with decay kernel
    # L[q1,q2] = exp(cum[q1]-cum[q2]) for q1 >= q2, as explicit batched
    # matmuls (NOTE at the reference's ssm.py:73: one 4-operand einsum
    # would materialise 6-D float32 intermediates)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(decay), 0.0)
    scores = Cc @ Bc.transpose(-1, -2)                      # (B,nc,Q,Q)
    W = scores[..., None] * L * dtc[:, :, None, :, :]       # (B,nc,Q,K,H)
    Wt = torch.movedim(W, -1, 2)                            # (B,nc,H,Q,K)
    xt = torch.movedim(xc, 3, 2)                            # (B,nc,H,K,P)
    y_intra = torch.movedim(Wt @ xt, 2, 3)                  # (B,nc,Q,H,P)

    # chunk summaries -> inter-chunk recurrence
    # state_c = sum_q exp(total - cum[q]) * dt[q] * B[q] (x) x[q], with q
    # contracted first (NOTE at ssm.py:87): intermediates stay (B,nc,H,P,N)
    w_end = torch.exp(total[:, :, None, :] - cum)           # (B,nc,Q,H)
    xw = xc * (w_end * dtc)[..., None]                      # (B,nc,Q,H,P)
    summary = torch.einsum("bcqn,bcqhp->bchpn", Bc, xw)     # (B,nc,H,P,N)

    state = torch.zeros((Bb, H, P, N), dtype=x.dtype, device=x.device)
    states = []
    for c in range(nc):
        states.append(state)                                # state BEFORE
        state = state * torch.exp(total[:, c])[:, :, None, None] \
            + summary[:, c]
    states = torch.stack(states, dim=1)                     # (B,nc,H,P,N)

    # inter-chunk contribution: y[q] += C[q] . state_begin * exp(cum[q])
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y, state


def mamba2(cfg, pcfg, p, x, batch, cache=None, layer_id=0):
    """Returns (out, new_cache).

    cache: dict(conv (B,K-1,C), ssm (B,H,P,N), pos (B,)).
    :func:`mamba2_tp` on a group of one."""
    del batch, layer_id
    one = tpm.ONE
    (part, rep), new = mamba2_tp(cfg, pcfg, p, one.enter(x), one, cache,
                                 want_cache=True)
    return one.exit(part, rep), new


def mamba2_tp(cfg, pcfg, p, h, tp, cache=None, want_cache=False):
    """Mamba2 on the leaves' shards under ``tp`` (``h`` an ``Entry``).
    ``in_proj``'s column split cuts across the sections of ``[z, x, B, C,
    dt]``, so its product is gathered whole; the row-parallel
    ``out_proj`` takes this rank's part of the gated, normed ``y``.
    Returns ``(partial, replicated)``, and with ``want_cache``
    ``((partial, replicated), new cache entry)``.

    A sequence (training, prefill) runs the convolution and the chunked
    SSD the same on every rank; its cache entry keeps this rank's
    channels of the ``conv`` window and heads of the ``ssm`` state where
    they split over the group (``cache_specs``).  A decode step on such a
    cache convolves this rank's channels and runs the recurrence on its
    heads, each gathered whole after (the gated norm spans all of
    ``d_inner``)."""
    del pcfg
    w = p.in_proj
    if tpm.shard_dim(w) == 1:
        proj = tp.gather(h.par @ w.to(h.par.dtype), -1)
    else:
        proj = h.rep @ w.to(h.rep.dtype)
    y, new = _mix(cfg, p, proj, cache, tp)
    if tpm.shard_dim(p.out_proj) == 0:
        res = tp.split(y, -1) @ p.out_proj.to(y.dtype), None
    else:
        res = None, y @ p.out_proj.to(y.dtype)
    return (res, new) if want_cache else res


def _part(tp, n):
    """(first, count) of this rank's share of ``n`` channels or heads
    that split over ``tp`` (``sanitize_spec``'s rule); None where they
    stay whole."""
    if tp.size == 1 or n % tp.size:
        return None
    return tp.rank * (n // tp.size), n // tp.size


def _mix(cfg, p, proj, cache, tp):
    """From the input projection to the gated, normed ``y`` (B, S, din)
    and the new cache entry (:func:`mamba2_tp`)."""
    B, S, _ = proj.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, Bm, Cm, dt = torch.split(proj, [din, din, N, N, H], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :].float())
    A = -torch.exp(p.A_log.float())

    xBC = torch.cat([xr, Bm, Cm], dim=-1)
    conv_w, conv_b = p.conv_w.to(proj.dtype), p.conv_b.to(proj.dtype)
    chans = _part(tp, xBC.shape[-1])
    if cache is not None and tpm.shard_dim(cache["conv"]) == 2:
        c0, nc = chans
        out, new_conv = _causal_conv(xBC[..., c0:c0 + nc],
                                     conv_w[:, c0:c0 + nc],
                                     conv_b[c0:c0 + nc], cache["conv"])
        xBC = tp.cat(out, -1)
        new_conv = tpm.placed(new_conv, 2)
    else:
        xBC, new_conv = _causal_conv(
            xBC, conv_w, conv_b, None if cache is None else cache["conv"])
        if cache is None and chans is not None:
            new_conv = tpm.placed(new_conv[..., chans[0]:chans[0] + chans[1]]
                                  .contiguous(), 2)
    xr, Bm, Cm = torch.split(xBC, [din, N, N], dim=-1)
    xh = xr.reshape(B, S, H, P)
    heads = _part(tp, H)

    if cache is None:
        chunk = min(cfg.ssm_chunk, S)
        y, final = _ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                                chunk)
        if heads is not None:
            final = final[:, heads[0]:heads[0] + heads[1]].contiguous()
        new_cache = {"conv": new_conv,
                     "ssm": tpm.placed(final, None if heads is None else 1),
                     "pos": torch.full((B,), S, dtype=torch.int32,
                                       device=proj.device)}
    else:
        # O(1) recurrent update: s = s*exp(dt*A) + dt * B (x) x ; y = C.s
        # on this rank's heads where the state splits
        split = tpm.shard_dim(cache["ssm"]) == 1
        h0, nh = heads if split else (0, H)
        dtl, xl = dt[:, 0, h0:h0 + nh], xh[:, 0, h0:h0 + nh]
        s = cache["ssm"].float()                            # (B,h,P,N)
        dA = torch.exp(dtl * A[None, h0:h0 + nh])           # (B,h)
        upd = torch.einsum("bh,bn,bhp->bhpn", dtl, Bm[:, 0].float(),
                           xl.float())
        s = s * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), s)[:, None]
        if split:
            y = tp.cat(y, 2)
        new_cache = {"conv": new_conv,
                     "ssm": tpm.placed(s.to(cache["ssm"].dtype),
                                       1 if split else None),
                     "pos": cache["pos"] + 1}

    y = y + xh.float() * p.D.float()[None, None, :, None]
    y = y.reshape(B, S, din).to(proj.dtype)
    # gated RMSNorm (Mamba2's norm-then-gate)
    y = rms_norm(y * F.silu(z.float()).to(proj.dtype), p.norm,
                 cfg.norm_eps)
    return y, new_cache


def init_mamba2_cache(cfg, B, dtype=torch.bfloat16, device=None):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((B, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=device),
        "pos": torch.zeros((B,), dtype=torch.int32, device=device),
    }
