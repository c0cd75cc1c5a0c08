"""Attention variants: GQA (optional qk_norm), MLA, flash-style chunking.

Port of ``repro.models.attention``.  Prefill attention is an online
softmax over KV blocks written as torch ops (a loop over the blocks
where the reference scans), so its memory is O(S * block) instead of
O(S^2).  Decode attends one query against the cache with a fill mask;
the new token is written at ``cache["pos"]`` by an index write where the
reference writes through a one-hot mask (the same values).

Each layer's math is written once, on the leaves' shards under a model
group (``gqa_tp``, ``mla_tp``; ``distributed/tensor_parallel.py``):
``gqa`` and ``mla`` are those bodies on the group of one.  A cache leaf
split over the group carries the dimension it splits (``tp_dim``, read
by ``tensor_parallel.shard_dim``): positions under ``seq_shard_decode``,
else a GQA cache's KV heads.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import tensor_parallel as tpm
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




def decode_partial(q, k, v, valid, scale):
    """One rank's share of single-query attention over its block of
    cached positions: ``(m, l, acc)``, the row max of the scores, the sum
    of their exponentials and the exponential-weighted values, each
    (B, Sq, H[, hd_v]) in float32.  ``valid`` (B, Sk) masks the block's
    positions past the fill; a block with none has m = NEG_INF and l =
    acc = 0.  ``TP.softmax_combine`` adds the ranks' shares."""
    B, Sq, H, hd = q.shape
    KvH, hd_v = k.shape[2], v.shape[-1]
    rep = H // KvH
    qf = (q.float() * scale).reshape(B, Sq, KvH, rep, hd)
    s = torch.einsum("bqgrh,bkgh->bqgrk", qf, k.float())
    mask = valid[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bqgrk,bkgh->bqgrh", p, v.float())
    return (m.reshape(B, Sq, H), p.sum(-1).reshape(B, Sq, H),
            acc.reshape(B, Sq, H, hd_v))


def _write_block(cache, new, fill, lo=0):
    """``cache`` (B, S_block, ...), the positions ``[lo, lo + S_block)``
    of a cache, with ``new`` (B, 1, ...) at position fill[b] of each batch
    entry b whose fill falls in the block (out of place; a fill outside
    it writes nothing, as the reference's one-hot write does past the
    end).  Keeps ``cache``'s placement (``tensor_parallel.placed``)."""
    B, Sb = cache.shape[:2]
    local = fill.long() - lo if lo else fill.long()
    at = local.clamp(0, Sb - 1)
    idx = (torch.arange(B, device=cache.device), at)
    keep = (at == local).reshape((B,) + (1,) * (new.dim() - 2))
    val = torch.where(keep, new[:, 0].to(cache.dtype), cache[idx])
    return tpm.placed(cache.index_put(idx, val), tpm.shard_dim(cache))


def _decode_positions(cfg, fill, B, S):
    """The rotary positions of a decode step: the fill (the reference's
    decode ignores ``batch["positions"]``)."""
    pos = fill[:, None]
    if cfg.pos_dims == 3:
        pos = pos[..., None].expand(B, S, 3)
    return pos


def _seq_split(pcfg, tp, S: int) -> bool:
    """Whether a cache of ``S`` positions holds one block of them on each
    rank of ``tp``: ``seq_shard_decode``'s split, kept where ``S``
    divides (``sharding.sanitize_spec``)."""
    return bool(pcfg.seq_shard_decode) and tp.size > 1 and S % tp.size == 0


def _block(tp, y):
    """This rank's block of positions (dimension 1) of a replicated
    ``y``, placed."""
    return tpm.placed(tp.chunk(y, 1).contiguous(), 1)


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
    """Returns (out, new_cache_entry).  cache entry: dict(k, v, pos).
    :func:`gqa_tp` on a group of one."""
    del layer_id
    one = tpm.ONE
    (part, rep), new = gqa_tp(cfg, pcfg, p, one.enter(x), batch, one, cache,
                              want_cache=True)
    return one.exit(part, rep), new


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
    shared by the heads; the score scale is (hd + rd)**-0.5.
    :func:`mla_tp` on a group of one."""
    del layer_id
    one = tpm.ONE
    (part, rep), new = mla_tp(cfg, pcfg, p, one.enter(x), batch, one, cache,
                              want_cache=True)
    return one.exit(part, rep), new


def init_mla_cache(cfg, B, S, dtype=torch.bfloat16, device=None):
    return {"c_kv": torch.zeros((B, S, cfg.mla_kv_lora), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros((B, S, cfg.mla_rope_dim), dtype=dtype,
                                device=device),
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# the layers under tensor parallelism (a group of one: the whole layer)
# ---------------------------------------------------------------------------

def _tp_heads(tp, h, w, nh, width):
    """A head projection of ``Entry`` ``h`` under ``tp``: ``(y (B, S, n,
    width), first)``, this rank's ``nh / m`` heads from ``first`` where
    ``w``'s column split falls on head boundaries, else all ``nh`` heads
    computed the same on every rank (``first`` None; a split inside a
    head is gathered whole, as GSPMD's resharding does)."""
    B, S = h.rep.shape[:2]
    if tpm.shard_dim(w) != 1:
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


def _kv_for(tp, y, first, q0, nq, rep):
    """The KV heads the attention of this rank's query heads reads: all
    of them where the rank computes every query head (``q0`` None)."""
    if q0 is None:
        return _all_heads(tp, y, first)
    return _heads_for(tp, y, first, q0, nq, rep)


def _norm_param(tp, w, first):
    """A replicated norm scale, *f* applied where it meets this rank's
    heads only."""
    return w if first is None else tp.copy(w)


def _tp_out(tp, p, out, q0):
    """``(partial, replicated)``: this rank's heads through its rows of
    the row-parallel ``wo``, or all heads (this rank's part where ``wo``
    is split)."""
    wo = p.wo
    if q0 is not None:
        return out @ wo.to(out.dtype), None
    if tpm.shard_dim(wo) == 0:
        return tp.split(out, -1) @ wo.to(out.dtype), None
    return None, out @ wo.to(out.dtype)


def _kv_entry(pcfg, tp, y, first, S):
    """A prefill's cached K or V (rotated K), placed as the cache is
    (``models.model.init_cache``): under ``seq_shard_decode`` where ``S``
    splits, this rank's block of positions of every head (one all-to-all
    where the rank holds its heads); else this rank's heads where it
    computes them, unless ``seq_shard_decode`` keeps the cache whole;
    else every head."""
    if _seq_split(pcfg, tp, S):
        if first is None:
            return _block(tp, y)
        return tpm.placed(tp.all_to_all(y, 1, 2), 1)
    if first is None:
        return y
    if pcfg.seq_shard_decode:
        return tp.cat(y, 2)
    return tpm.placed(y, 2)


def _combined(tp, q, k, v, valid, scale):
    """Single-query attention of ``q`` over the group's blocks of
    positions: each rank's share (:func:`decode_partial`) added in rank
    order (``TP.softmax_combine``)."""
    m, l, acc = decode_partial(q, k, v, valid, scale)
    return tp.softmax_combine(m, l, acc).to(q.dtype)


def _block_valid(cache, fill, lo):
    """(B, S_block): the block's positions ``[lo, lo + S_block)`` below
    the new fill ``fill + 1``."""
    idx = lo + torch.arange(cache.shape[1], device=cache.device)
    return idx[None, :] <= fill[:, None].long()


def gqa_tp(cfg, pcfg, p, h, batch, tp, cache=None, want_cache=False):
    """GQA on the leaves' shards under ``tp`` (``h`` an ``Entry``):
    column-parallel ``wq``/``wk``/``wv``, each rank its own heads, and
    row-parallel ``wo``.  Returns ``(partial, replicated)``, and with
    ``want_cache`` ``((partial, replicated), new cache entry)``.

    Without ``cache`` (training, prefill) causal flash attention over the
    sequence; the entry keeps the rotated K and V as :func:`_kv_entry`
    places them.  With one (decode, one token at ``cache["pos"]``): where
    the cache holds this rank's block of positions, every rank scores
    all query heads (gathered: a few KB a step) against its block, the
    new token's K/V go to the rank owning its position, and the ranks'
    softmax shares are combined in rank order; else this rank's query
    heads attend over the whole cache (its KV heads, or all)."""
    B, S, _ = h.rep.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, q0 = _tp_heads(tp, h, p.wq, H, hd)
    k, k0 = _tp_heads(tp, h, p.wk, Kv, hd)
    v, v0 = _tp_heads(tp, h, p.wv, Kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, _norm_param(tp, p.q_norm, q0), cfg.norm_eps)
        k = rms_norm(k, _norm_param(tp, p.k_norm, k0), cfg.norm_eps)
    if cache is None:
        pos = _positions(cfg, batch, B, S, device=h.rep.device)
    else:
        fill = cache["pos"]
        pos = _decode_positions(cfg, fill, B, S)
    q = _rope(cfg, q, pos)
    k = _rope(cfg, k, pos)
    nq, rep = q.shape[2], H // Kv
    if cache is None:
        out = flash_attention(q, _kv_for(tp, k, k0, q0, nq, rep),
                              _kv_for(tp, v, v0, q0, nq, rep),
                              causal=cfg.causal, block=pcfg.flash_block)
        res = _tp_out(tp, p, out.reshape(B, S, -1), q0)
        new = None if not want_cache else {
            "k": _kv_entry(pcfg, tp, k, k0, S),
            "v": _kv_entry(pcfg, tp, v, v0, S),
            "pos": torch.full((B,), S, dtype=torch.int32,
                              device=h.rep.device)}
    elif tpm.shard_dim(cache["k"]) == 1:      # this rank's positions
        lo = tp.rank * cache["k"].shape[1]
        ck = _write_block(cache["k"], _all_heads(tp, k, k0), fill, lo)
        cv = _write_block(cache["v"], _all_heads(tp, v, v0), fill, lo)
        out = _combined(tp, _all_heads(tp, q, q0), ck, cv,
                        _block_valid(ck, fill, lo), hd ** -0.5)
        res = _tp_out(tp, p, out.reshape(B, S, -1), None)
        new = {"k": ck, "v": cv, "pos": fill + 1}
    else:
        kf = k0 if tpm.shard_dim(cache["k"]) == 2 else None
        ck = _write_block(cache["k"], k if kf is not None
                          else _all_heads(tp, k, k0), fill)
        cv = _write_block(cache["v"], v if kf is not None
                          else _all_heads(tp, v, v0), fill)
        out = plain_decode_attention(q, _kv_for(tp, ck, kf, q0, nq, rep),
                                     _kv_for(tp, cv, kf, q0, nq, rep),
                                     fill + 1)
        res = _tp_out(tp, p, out.reshape(B, S, -1), q0)
        new = {"k": ck, "v": cv, "pos": fill + 1}
    return (res, new) if want_cache else res


def _latent_queries(cfg, tp, p, q_nope, q0):
    """Every head's no-rope query in latent space, q_nope_h @ wuk_h^T
    (B, S, H, kv_lora): this rank's heads through its columns of ``wuk``,
    gathered, where both split on the same heads; else from the whole
    queries and ``wuk``."""
    B, S = q_nope.shape[:2]
    kvl, hd = cfg.mla_kv_lora, cfg.hd
    if q0 is not None and tpm.shard_dim(p.wuk) == 1:
        w = p.wuk.to(q_nope.dtype).reshape(kvl, q_nope.shape[2], hd)
        return tp.gather(torch.einsum("bshd,lhd->bshl", q_nope, w), 2)
    w = tp.weight(p.wuk).to(q_nope.dtype).reshape(kvl, cfg.n_heads, hd)
    return torch.einsum("bshd,lhd->bshl", _all_heads(tp, q_nope, q0), w)


def _latent_values(cfg, tp, p, lat, q0):
    """Attention over the latents ``lat`` (B, S, H, kv_lora) through each
    head's ``wuv`` columns, then ``wo``: ``(partial, replicated)``."""
    B, S = lat.shape[:2]
    kvl, hd = cfg.mla_kv_lora, cfg.hd
    if q0 is not None and tpm.shard_dim(p.wuv) == 1:
        n = p.wuv.shape[1] // hd
        w = p.wuv.to(lat.dtype).reshape(kvl, n, hd)
        out = torch.einsum("bshl,lhd->bshd", lat[:, :, q0:q0 + n], w)
        return _tp_out(tp, p, out.reshape(B, S, -1), q0)
    w = tp.weight(p.wuv).to(lat.dtype).reshape(kvl, cfg.n_heads, hd)
    out = torch.einsum("bshl,lhd->bshd", lat, w)
    return _tp_out(tp, p, out.reshape(B, S, -1), None)


def mla_tp(cfg, pcfg, p, h, batch, tp, cache=None, want_cache=False):
    """MLA on the leaves' shards under ``tp``: column-parallel ``wq``,
    ``wuk`` and ``wuv`` (each rank its own heads), the latent projections
    ``wdkv``/``wkpe`` replicated, row-parallel ``wo``.  Returns
    ``(partial, replicated)``, and with ``want_cache`` ``((partial,
    replicated), new cache entry)``.

    The latents ``c_kv``/``k_pe`` are computed the same on every rank.
    Where the cache holds this rank's block of positions of them
    (``seq_shard_decode``), a decode step runs in the absorbed form: every
    head's query enters latent space (:func:`_latent_queries`), each rank
    scores every head against its block, the softmax shares are combined
    in rank order over the latents, and each rank projects its heads'
    latent mix through its ``wuv`` columns.  Else K and V are decompressed
    from the whole latents, this rank's heads."""
    B, S, _ = h.rep.shape
    H, hd, rd = cfg.n_heads, cfg.hd, cfg.mla_rope_dim
    q, q0 = _tp_heads(tp, h, p.wq, H, hd + rd)
    q_nope, q_pe = q[..., :hd], q[..., hd:]
    c_kv = h.rep @ p.wdkv.to(h.rep.dtype)
    k_pe = h.rep @ p.wkpe.to(h.rep.dtype)
    if cache is None:
        pos = _positions(cfg, batch, B, S, device=h.rep.device)
    else:
        fill = cache["pos"]
        pos = _decode_positions(cfg, fill, B, S)
    q_pe = _rope(cfg, q_pe, pos)
    k_pe = _rope(cfg, k_pe[:, :, None, :], pos)[:, :, 0]
    if cache is not None and tpm.shard_dim(cache["c_kv"]) == 1:
        lo = tp.rank * cache["c_kv"].shape[1]
        ckv = _write_block(cache["c_kv"], c_kv, fill, lo)
        pe = _write_block(cache["k_pe"], k_pe, fill, lo)
        qc = torch.cat([_latent_queries(cfg, tp, p, q_nope, q0),
                        _all_heads(tp, q_pe, q0)], -1)
        kc = torch.cat([ckv, pe], -1)[:, :, None, :]
        lat = _combined(tp, qc, kc, ckv[:, :, None, :],
                        _block_valid(ckv, fill, lo), (hd + rd) ** -0.5)
        res = _latent_values(cfg, tp, p, lat, q0)
        new = {"c_kv": ckv, "k_pe": pe, "pos": fill + 1}
        return (res, new) if want_cache else res
    if cache is None:
        kv_len = None
        split = _seq_split(pcfg, tp, S)
        new = None if not want_cache else {
            "c_kv": _block(tp, c_kv) if split else c_kv,
            "k_pe": _block(tp, k_pe) if split else k_pe,
            "pos": torch.full((B,), S, dtype=torch.int32,
                              device=h.rep.device)}
    else:
        c_kv = _write_block(cache["c_kv"], c_kv, fill)
        k_pe = _write_block(cache["k_pe"], k_pe, fill)
        kv_len = fill + 1
        new = {"c_kv": c_kv, "k_pe": k_pe, "pos": kv_len}
    # decompress K/V from the latent cache
    ckv = tpm.Entry(c_kv, tp.copy(c_kv))
    k_nope, k0 = _tp_heads(tp, ckv, p.wuk, H, hd)
    v, v0 = _tp_heads(tp, ckv, p.wuv, H, hd)
    nq = q.shape[2]
    k_nope = _kv_for(tp, k_nope, k0, q0, nq, 1)
    v = _kv_for(tp, v, v0, q0, nq, 1)
    if q0 is not None:
        k_pe = tp.copy(k_pe)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        *k_nope.shape[:3], rd)], -1)
    qf = torch.cat([q_nope, q_pe], -1)
    if kv_len is None:
        out = flash_attention(qf, k, v, causal=cfg.causal,
                              block=pcfg.flash_block)
    else:
        out = plain_decode_attention(qf, k, v, kv_len)
    res = _tp_out(tp, p, out.reshape(B, S, -1), q0)
    return (res, new) if want_cache else res
