"""Common layers: RMSNorm, RoPE / M-RoPE, SwiGLU MLP.

Port of ``repro.models.layers``.  Parameters are made by an
:class:`Init` (a seeded normal or a constant, on a chosen device), so a
model can also be built empty and filled from the reference's weights
(``convert.lm_params_from_numpy``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Init:
    """Makes parameters: ``normal`` draws N(0, std) in float32 from
    ``generator`` (on the generator's device) and casts to ``dtype`` on
    ``device``; ``full`` fills a constant.  ``device="meta"`` with no
    generator makes shapes only, to be filled by ``load_state_dict``.
    ``keep``, if given, is called once a leaf, in the order the leaves
    are made, with the whole leaf, and returns what the parameter holds
    (a sharded init keeps this rank's shard and lets the whole go)."""

    def __init__(self, generator, dtype, device, keep=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.keep = keep

    def _param(self, x) -> nn.Parameter:
        return nn.Parameter(x if self.keep is None else self.keep(x))

    def normal(self, shape, std: float) -> nn.Parameter:
        if self.device.type == "meta":
            return self.full(shape, 0.0)
        g = self.generator
        x = torch.randn(shape, generator=g, device=g.device,
                        dtype=torch.float32).mul_(std)
        return self._param(x.to(device=self.device, dtype=self.dtype))

    def full(self, shape, value: float) -> nn.Parameter:
        return self._param(torch.full(shape, value, dtype=self.dtype,
                                      device=self.device))


def rms_normalize(x, eps=1e-5):
    """``x`` over its root mean square, in float32 (RMSNorm before its
    scale)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return xf * torch.rsqrt(var + eps)


def rms_norm(x, scale, eps=1e-5):
    return (rms_normalize(x, eps) * scale.float()).to(x.dtype)


def init_rms(init: Init, d):
    return init.full((d,), 1.0)


def _rope_angles(positions, dim, theta):
    """positions (...,) -> cos/sin (..., dim/2)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """NeoX rotation: the halves of the last axis, not interleaved pairs."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta=1e4):
    """x (B, S, H, hd), positions (B, S) -> rotated x."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, S, hd/2)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def apply_mrope(x, positions3, theta=1e4, sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE: positions3 (B, S, 3) = (t, h, w) ids.

    The hd/2 frequency slots are split into ``sections`` (t/h/w); each
    section rotates by its own position stream.  sections must sum to hd/2.
    """
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    dev = positions3.device
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=dev) / hd))
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=dev),
        torch.tensor(sections, device=dev))                 # (half,)
    pos = positions3.float()[..., sec_id]                   # (B, S, half)
    ang = pos * freqs[None, None, :]
    return _rotate(x, torch.cos(ang)[:, :, None, :],
                   torch.sin(ang)[:, :, None, :])


def swiglu(x, w1, w3, w2):
    """SwiGLU MLP: (x@w1 * silu(x@w3)) @ w2 (silu on the w3 branch)."""
    h = x @ w1.to(x.dtype)
    g = x @ w3.to(x.dtype)
    h = h * F.silu(g.float()).to(x.dtype)
    return h @ w2.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU weights w1, w3 (d, ff) and w2 (ff, d)."""

    def __init__(self, init: Init, d, ff):
        super().__init__()
        self.w1 = init.normal((d, ff), 0.02)
        self.w3 = init.normal((d, ff), 0.02)
        self.w2 = init.normal((ff, d), 0.02)

    def forward(self, x):
        return swiglu(x, self.w1, self.w3, self.w2)


def init_mlp(init: Init, d, ff) -> MLP:
    return MLP(init, d, ff)


def swiglu_tp(h, w1, w3, w2):
    """The SwiGLU MLP under tensor parallelism on an ``Entry`` ``h``:
    column-parallel ``w1``/``w3`` and row-parallel ``w2`` give ``(partial,
    None)``, this rank's share of the output; whole leaves (``d_ff`` does
    not split) give ``(None, replicated)``."""
    from repro_torch.distributed.tensor_parallel import shard_dim
    if shard_dim(w1) == 1:
        return swiglu(h.par, w1, w3, w2), None
    return None, swiglu(h.rep, w1, w3, w2)
