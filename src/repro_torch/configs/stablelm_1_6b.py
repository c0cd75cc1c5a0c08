"""stablelm-1.6b [dense]: 24L d=2048 32H (kv=32, i.e. MHA) ff=5632 V=100352.

[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

A = LayerSpec("attn", "dense")

CONFIG = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    d_model=2048, vocab=100352,
    segments=(((A,), 24),),
    n_heads=32, n_kv_heads=32, d_ff=5632,
    rope="rope", rope_theta=1e4,
))


def reduced():
    return ModelConfig(
        name="stablelm-1.6b-smoke", family="dense",
        d_model=128, vocab=512,
        segments=(((A,), 2),),
        n_heads=4, n_kv_heads=4, d_ff=352,
        rope="rope")
