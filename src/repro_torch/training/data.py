"""Deterministic synthetic data pipeline.

A copy of ``repro.training.data`` (numpy only), so both packages draw
the same batches bit for bit.  Generates a reproducible mixture of
Zipf-distributed tokens with local n-gram structure (so an LM can
actually reduce loss on it), sharded by (host, step) -- every host
computes only its slice, the paper-standard random-permutation load
balancing applied to LM data.  Also provides the frontend-stub streams
for the audio/vlm architectures.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch(self, step: int, lo: int = 0, hi: int | None = None):
        """Token batch rows [lo, hi) of the global batch at `step`.

        The FULL global batch is always generated then sliced, so every
        host sees identical rows for its slice regardless of shard width
        (host-count-independent determinism)."""
        hi = hi if hi is not None else self.global_batch
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) % (2 ** 63))
        # Zipf body truncated to vocab; order-2 structure via a random
        # linear-congruential mixing so next-token is partially predictable
        base = rng.zipf(self.zipf_a, size=(self.global_batch, self.seq_len))
        base = np.minimum(base, self.vocab - 1)
        mult = 6364136223846793005
        mixed = base.copy()
        mixed[:, 1:] = (base[:, 1:] + (mixed[:, :-1] * mult >> 33)) \
            % self.vocab
        # every 4th token copies its predecessor -> learnable structure
        mixed[:, 3::4] = mixed[:, 2::4]
        tok = mixed[lo:hi].astype(np.int32)
        return {"tokens": tok, "labels": tok}


def embeds_batch(step: int, batch: int, seq: int, d: int, seed: int = 0,
                 pos3: bool = False):
    """Frontend-stub batch for audio (frames) / vlm (patches)."""
    rng = np.random.default_rng((seed * 7_777_777 + step) % (2 ** 63))
    out = {"embeds": rng.standard_normal((batch, seq, d)).astype(np.float32)}
    if pos3:
        t = np.arange(seq, dtype=np.int32)
        grid = np.stack([t, t // 16, t % 16], axis=-1)
        out["positions"] = np.broadcast_to(grid, (batch, seq, 3)).copy()
    return out
