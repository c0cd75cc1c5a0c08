"""llama3.2-1b [dense]: 16L d=2048 32H (GQA kv=8) ff=8192 V=128256.

Tied embeddings, rope theta 500k.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

A = LayerSpec("attn", "dense")

CONFIG = register(ModelConfig(
    name="llama3.2-1b", family="dense",
    d_model=2048, vocab=128256,
    segments=(((A,), 16),),
    n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192,
    rope="rope", rope_theta=5e5, tie_embeddings=True,
))


def reduced():
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense",
        d_model=128, vocab=512,
        segments=(((A,), 2),),
        n_heads=4, n_kv_heads=2, d_ff=512,
        rope="rope", tie_embeddings=True)
