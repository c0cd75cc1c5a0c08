"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) ff=6144 V=151936, qk_norm.

[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

A = LayerSpec("attn", "dense")

CONFIG = register(ModelConfig(
    name="qwen3-1.7b", family="dense",
    d_model=2048, vocab=151936,
    segments=(((A,), 28),),
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=6144,
    qk_norm=True, rope="rope", rope_theta=1e6,
))


def reduced():
    return ModelConfig(
        name="qwen3-1.7b-smoke", family="dense",
        d_model=128, vocab=512,
        segments=(((A,), 2),),
        n_heads=4, n_kv_heads=2, d_ff=384,
        qk_norm=True, rope="rope")
