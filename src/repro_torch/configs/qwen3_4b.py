"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) ff=9728 V=151936, qk_norm.

[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

A = LayerSpec("attn", "dense")

CONFIG = register(ModelConfig(
    name="qwen3-4b", family="dense",
    d_model=2560, vocab=151936,
    segments=(((A,), 36),),
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728,
    qk_norm=True, rope="rope", rope_theta=1e6,
))


def reduced():
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        d_model=160, vocab=512,
        segments=(((A,), 2),),
        n_heads=4, n_kv_heads=2, head_dim=40, d_ff=480,
        qk_norm=True, rope="rope")
