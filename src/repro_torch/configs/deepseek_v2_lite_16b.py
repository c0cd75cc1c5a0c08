"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H, MLA kv_lora=512,
MoE 64 routed top-6 + 2 shared, expert ff=1408; layer 0 dense ff=10944.

Assignment note: the spec line reads both "64e top-6" and "2 shared+160
routed"; the published DeepSeek-V2-Lite config is 64 routed + 2 shared,
top-6, which is what we implement (see DESIGN.md deviations).
[arXiv:2405.04434; hf]
"""
import dataclasses

from repro_torch.config import LayerSpec, ModelConfig, register

DENSE0 = LayerSpec("attn", "dense")
MOE = LayerSpec("attn", "moe")

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    d_model=2048, vocab=102400,
    segments=(((DENSE0,), 1), ((MOE,), 26)),
    n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,
    mla_kv_lora=512, mla_rope_dim=64,
    moe_experts=64, moe_top_k=6, moe_shared=2, moe_d_ff=1408,
    rope="rope", rope_theta=1e4,
))


def reduced():
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        d_model=128, vocab=512,
        segments=(((DENSE0,), 1), ((MOE,), 2)),
        n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=384, mla_kv_lora=64, mla_rope_dim=16,
        moe_experts=8, moe_top_k=2, moe_shared=1, moe_d_ff=96,
        rope="rope",
        capacity_factor=8.0)
