"""hubert-xlarge [audio]: 48L d=1280 16H (MHA kv=16) ff=5120 V=504.

Encoder-only (bidirectional, no causal mask, no decode step — decode/long
shapes are skipped per the assignment).  The conv feature extractor is a
STUB: input_specs() provides precomputed frame embeddings.
[arXiv:2106.07447; unverified]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

A = LayerSpec("attn", "dense")

CONFIG = register(ModelConfig(
    name="hubert-xlarge", family="audio",
    d_model=1280, vocab=504,
    segments=(((A,), 48),),
    n_heads=16, n_kv_heads=16, d_ff=5120,
    rope="none", causal=False,
    embed_inputs=False,     # frame-embedding frontend stub
))


def reduced():
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        d_model=128, vocab=64,
        segments=(((A,), 2),),
        n_heads=4, n_kv_heads=4, d_ff=256,
        rope="none", causal=False, embed_inputs=False)
