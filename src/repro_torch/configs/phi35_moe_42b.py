"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) V=32064,
MoE 16 experts top-2, expert ff=6400.  [hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

E = LayerSpec("attn", "moe")

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    d_model=4096, vocab=32064,
    segments=(((E,), 32),),
    n_heads=32, n_kv_heads=8, head_dim=128,
    moe_experts=16, moe_top_k=2, moe_d_ff=6400,
    rope="rope", rope_theta=1e4,
))


def reduced():
    return ModelConfig(
        name="phi3.5-moe-smoke", family="moe",
        d_model=128, vocab=512,
        segments=(((E,), 2),),
        n_heads=4, n_kv_heads=2, head_dim=32,
        moe_experts=4, moe_top_k=2, moe_d_ff=160,
        rope="rope",
        capacity_factor=8.0)
