"""Attention variants: GQA (optional qk_norm), MLA, flash-style chunking.

Port of ``repro.models.attention``.  Prefill attention is an online
softmax over KV blocks written as torch ops (a loop over the blocks
where the reference scans), so its memory is O(S * block) instead of
O(S^2).  Decode attends one query against the cache with a fill mask;
the new token is written at ``cache["pos"]`` by an index write where the
reference writes through a one-hot mask (the same values).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import Init, apply_mrope, apply_rope, rms_norm

NEG_INF = -1e30


def _positions(cfg, batch, B, S, offset=None, device=None):
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + (
            0 if offset is None else offset)
        pos = pos.expand(B, S)
        if cfg.pos_dims == 3:
            pos = pos[..., None].expand(B, S, 3)
    return pos


def _rope(cfg, x, pos):
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        half = x.shape[-1] // 2
        t = half - 2 * (half // 3)
        return apply_mrope(x, pos, cfg.rope_theta,
                           sections=(t, half // 3, half // 3))
    return apply_rope(x, pos, cfg.rope_theta)


def plain_decode_attention(q, k, v, kv_len):
    """Single-query attention without the KV-block loop (the decode
    path): scores over the whole cache, masked past ``kv_len`` (B,)."""
    B, Sq, H, hd = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    rep = H // KvH
    qf = (q.float() * hd ** -0.5).reshape(B, Sq, KvH, rep, hd)
    s = torch.einsum("bqgrh,bkgh->bqgrk", qf, k.float())
    mask = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqgrk,bkgh->bqgrh", p, v.float())
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool, block: int, q_offset=0,
                    kv_len=None):
    """Online-softmax attention over KV blocks.

    q: (B, Sq, H, hd)   k: (B, Sk, KvH, hd)   v: (B, Sk, KvH, hd_v), with
    H % KvH == 0 (hd_v may differ from hd: MLA).  The blocks are the
    reference's: ``nblk = max(Sk // block, 1)`` blocks of ``Sk // nblk``
    keys, and a length they do not divide is refused.
    kv_len: optional (B,) valid-length mask for cached decode.
    """
    B, Sq, H, hd = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    rep = H // KvH
    qf = (q.float() * hd ** -0.5).reshape(B, Sq, KvH, rep, hd)
    nblk = max(Sk // block, 1)
    block = Sk // nblk
    if nblk * block != Sk:
        raise ValueError(f"flash_attention: {nblk} blocks of {block} keys "
                         f"do not cover Sk={Sk}")
    kb = k.float().reshape(B, nblk, block, KvH, hd)
    vb = v.float().reshape(B, nblk, block, KvH, hd_v)
    dev = q.device
    q_idx = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, Sq, KvH, rep), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Sq, KvH, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KvH, rep, hd_v), dtype=torch.float32,
                      device=dev)
    for i in range(nblk):
        s = torch.einsum("bqgrh,bkgh->bqgrk", qf, kb[:, i])
        k_idx = i * block + torch.arange(block, device=dev)
        mask = torch.ones((Sq, block), dtype=torch.bool, device=dev)
        if causal:
            mask = q_idx[:, None] >= k_idx[None, :]
        if kv_len is not None:
            mask = mask[None] & (k_idx[None, None, :] < kv_len[:, None, None])
            s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        else:
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqgrk,bkgh->bqgrh", p,
                                                   vb[:, i])
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)


def _write_at(cache, new, fill):
    """``cache`` (B, S, ...) with ``new`` (B, 1, ...) at row fill[b] of
    each batch entry b (out of place)."""
    b = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put((b, fill.long()), new[:, 0].to(cache.dtype))


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Weights of grouped-query attention (``q_norm``/``k_norm`` with
    qk_norm)."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = init.normal((d, H * hd), 0.02)
        self.wk = init.normal((d, Kv * hd), 0.02)
        self.wv = init.normal((d, Kv * hd), 0.02)
        self.wo = init.normal((H * hd, d), 0.02)
        if cfg.qk_norm:
            self.q_norm = init.full((hd,), 1.0)
            self.k_norm = init.full((hd,), 1.0)


def init_gqa(init: Init, cfg) -> GQA:
    return GQA(init, cfg)


def gqa(cfg, pcfg, p, x, batch, cache=None, layer_id=0):
    """Returns (out, new_cache_entry).  cache entry: dict(k, v, pos)."""
    del layer_id
    B, S, d = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq.to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p.wk.to(x.dtype)).reshape(B, S, Kv, hd)
    v = (x @ p.wv.to(x.dtype)).reshape(B, S, Kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)

    if cache is None:                      # train / full prefill
        pos = _positions(cfg, batch, B, S, device=x.device)
        q = _rope(cfg, q, pos)
        k = _rope(cfg, k, pos)
        out = flash_attention(q, k, v, causal=cfg.causal,
                              block=pcfg.flash_block)
        new_cache = {"k": k, "v": v,
                     "pos": torch.full((B,), S, dtype=torch.int32,
                                       device=x.device)}
    else:                                  # single-token decode
        fill = cache["pos"]                # (B,)
        pos = fill[:, None]
        if cfg.pos_dims == 3:
            pos = pos[..., None].expand(B, S, 3)
        q = _rope(cfg, q, pos)
        k = _rope(cfg, k, pos)
        ck = _write_at(cache["k"], k, fill)
        cv = _write_at(cache["v"], v, fill)
        out = plain_decode_attention(q, ck, cv, fill + 1)
        new_cache = {"k": ck, "v": cv, "pos": fill + 1}

    out = out.reshape(B, S, H * hd)
    return out @ p.wo.to(x.dtype), new_cache


def init_gqa_cache(cfg, B, S, dtype=torch.bfloat16, device=None):
    return {"k": torch.zeros((B, S, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((B, S, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                             device=device),
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV cache
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """Weights of multi-head latent attention."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        kvl, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
        self.wq = init.normal((d, H * (hd + rd)), 0.02)
        self.wdkv = init.normal((d, kvl), 0.02)
        self.wkpe = init.normal((d, rd), 0.02)
        self.wuk = init.normal((kvl, H * hd), 0.02)
        self.wuv = init.normal((kvl, H * hd), 0.02)
        self.wo = init.normal((H * hd, d), 0.02)


def init_mla(init: Init, cfg) -> MLA:
    return MLA(init, cfg)


def mla(cfg, pcfg, p, x, batch, cache=None, layer_id=0):
    """Multi-head Latent Attention.  Cache holds only (c_kv, k_pe) --
    (kv_lora + rope_dim) floats per token instead of 2*Kv*hd.  k_pe is
    shared by the heads; the score scale is (hd + rd)**-0.5."""
    del layer_id
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    rd = cfg.mla_rope_dim
    q = (x @ p.wq.to(x.dtype)).reshape(B, S, H, hd + rd)
    q_nope, q_pe = q[..., :hd], q[..., hd:]
    c_kv = x @ p.wdkv.to(x.dtype)
    k_pe = x @ p.wkpe.to(x.dtype)

    if cache is None:
        pos = _positions(cfg, batch, B, S, device=x.device)
        fill = torch.full((B,), S, dtype=torch.int32, device=x.device)
        kv_len = None
    else:
        fill = cache["pos"]
        pos = fill[:, None]
        c_kv = _write_at(cache["c_kv"], c_kv, fill)
        kv_len = fill + 1

    q_pe = _rope(cfg, q_pe, pos)
    k_pe = _rope(cfg, k_pe[:, :, None, :], pos)[:, :, 0]
    if cache is None:
        new_cache = {"c_kv": c_kv, "k_pe": k_pe, "pos": fill}
        pe_c = k_pe
    else:
        pe_c = _write_at(cache["k_pe"], k_pe, fill)
        new_cache = {"c_kv": c_kv, "k_pe": pe_c, "pos": fill + 1}

    # decompress K/V from the latent cache
    k_nope = (c_kv @ p.wuk.to(x.dtype)).reshape(B, -1, H, hd)
    v = (c_kv @ p.wuv.to(x.dtype)).reshape(B, -1, H, hd)
    k = torch.cat([k_nope, pe_c[:, :, None, :].expand(
        *k_nope.shape[:3], rd)], -1)
    qf = torch.cat([q_nope, q_pe], -1)
    if kv_len is None:
        out = flash_attention(qf, k, v, causal=cfg.causal,
                              block=pcfg.flash_block)
    else:
        out = plain_decode_attention(qf, k, v, kv_len)
    out = out.reshape(B, S, H * hd)
    return out @ p.wo.to(x.dtype), new_cache


def init_mla_cache(cfg, B, S, dtype=torch.bfloat16, device=None):
    return {"c_kv": torch.zeros((B, S, cfg.mla_kv_lora), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros((B, S, cfg.mla_rope_dim), dtype=dtype,
                                device=device),
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# tensor parallelism (training: no cache)
# ---------------------------------------------------------------------------

def _tp_heads(tp, h, w, nh, width):
    """A head projection of ``Entry`` ``h`` under ``tp``: ``(y (B, S, n,
    width), first)``, this rank's ``nh / m`` heads from ``first`` where
    ``w``'s column split falls on head boundaries, else all ``nh`` heads
    computed the same on every rank (``first`` None; a split inside a
    head is gathered whole, as GSPMD's resharding does)."""
    from repro_torch.distributed.tensor_parallel import shard_dim
    B, S = h.rep.shape[:2]
    if shard_dim(w) != 1:
        return (h.rep @ w.to(h.rep.dtype)).reshape(B, S, nh, width), None
    y = h.par @ w.to(h.par.dtype)
    if nh % tp.size == 0:
        n = nh // tp.size
        return y.reshape(B, S, n, width), tp.rank * n
    return tp.gather(y, -1).reshape(B, S, nh, width), None


def _all_heads(tp, y, first):
    """Every head of ``y`` on every rank (gathered if it holds this
    rank's)."""
    return y if first is None else tp.gather(y, 2)


def _heads_for(tp, y, first, q0, nq, rep):
    """The KV heads that this rank's query heads ``[q0, q0 + nq)`` read
    (query head ``h`` reads KV head ``h // rep``): ``y`` itself where it
    is split on the same head boundaries, else one KV head a query head
    taken from the replicated ``y``."""
    if first is not None:
        return y
    idx = (q0 + torch.arange(nq, device=y.device)) // rep
    return tp.copy(y).index_select(2, idx)


def _norm_param(tp, w, first):
    """A replicated norm scale, *f* applied where it meets this rank's
    heads only."""
    return w if first is None else tp.copy(w)


def _tp_out(tp, p, out, q0):
    """``(partial, replicated)``: this rank's heads through its rows of
    the row-parallel ``wo``, or all heads (this rank's part where ``wo``
    is split)."""
    from repro_torch.distributed.tensor_parallel import shard_dim
    wo = p.wo
    if q0 is not None:
        return out @ wo.to(out.dtype), None
    if shard_dim(wo) == 0:
        return tp.split(out, -1) @ wo.to(out.dtype), None
    return None, out @ wo.to(out.dtype)


def gqa_tp(cfg, pcfg, p, h, batch, tp):
    """GQA on the leaves' shards under ``tp`` (``h`` an ``Entry``):
    column-parallel ``wq``/``wk``/``wv``, each rank its own heads, and
    row-parallel ``wo``.  Returns ``(partial, replicated)``."""
    B, S, _ = h.rep.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, q0 = _tp_heads(tp, h, p.wq, H, hd)
    k, k0 = _tp_heads(tp, h, p.wk, Kv, hd)
    v, v0 = _tp_heads(tp, h, p.wv, Kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, _norm_param(tp, p.q_norm, q0), cfg.norm_eps)
        k = rms_norm(k, _norm_param(tp, p.k_norm, k0), cfg.norm_eps)
    pos = _positions(cfg, batch, B, S, device=h.rep.device)
    q = _rope(cfg, q, pos)
    k = _rope(cfg, k, pos)
    if q0 is None:
        k, v = _all_heads(tp, k, k0), _all_heads(tp, v, v0)
    else:
        nq, rep = q.shape[2], H // Kv
        k = _heads_for(tp, k, k0, q0, nq, rep)
        v = _heads_for(tp, v, v0, q0, nq, rep)
    out = flash_attention(q, k, v, causal=cfg.causal, block=pcfg.flash_block)
    return _tp_out(tp, p, out.reshape(B, S, -1), q0)


def mla_tp(cfg, pcfg, p, h, batch, tp):
    """MLA on the leaves' shards under ``tp``: column-parallel ``wq``,
    ``wuk`` and ``wuv`` (each rank its own heads), the latent projections
    ``wdkv``/``wkpe`` replicated, row-parallel ``wo``.  Returns
    ``(partial, replicated)``."""
    from repro_torch.distributed.tensor_parallel import Entry
    B, S, _ = h.rep.shape
    H, hd, rd = cfg.n_heads, cfg.hd, cfg.mla_rope_dim
    q, q0 = _tp_heads(tp, h, p.wq, H, hd + rd)
    q_nope, q_pe = q[..., :hd], q[..., hd:]
    c_kv = h.rep @ p.wdkv.to(h.rep.dtype)
    k_pe = h.rep @ p.wkpe.to(h.rep.dtype)
    pos = _positions(cfg, batch, B, S, device=h.rep.device)
    q_pe = _rope(cfg, q_pe, pos)
    k_pe = _rope(cfg, k_pe[:, :, None, :], pos)[:, :, 0]
    ckv = Entry(c_kv, tp.copy(c_kv))
    k_nope, k0 = _tp_heads(tp, ckv, p.wuk, H, hd)
    v, v0 = _tp_heads(tp, ckv, p.wuv, H, hd)
    if q0 is None:
        k_nope, v = _all_heads(tp, k_nope, k0), _all_heads(tp, v, v0)
    else:
        nq = q.shape[2]
        k_nope = _heads_for(tp, k_nope, k0, q0, nq, 1)
        v = _heads_for(tp, v, v0, q0, nq, 1)
        k_pe = tp.copy(k_pe)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        *k_nope.shape[:3], rd)], -1)
    qf = torch.cat([q_nope, q_pe], -1)
    out = flash_attention(qf, k, v, causal=cfg.causal,
                          block=pcfg.flash_block)
    return _tp_out(tp, p, out.reshape(B, S, -1), q0)
