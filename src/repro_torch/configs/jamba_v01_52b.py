"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) ff=14336 V=65536,
Mamba:attention 7:1 interleave, MoE 16 experts top-2 on alternate layers.

Super-block of 8 layers (attention at in-block index 4, per the released
model), MoE on odd in-block indices; scanned over 4 repetitions.
[arXiv:2403.19887; hf]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

def _sb(moe_ff):
    sb = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        sb.append(LayerSpec(mixer, ffn))
    return tuple(sb)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, vocab=65536,
    segments=((_sb(None), 4),),
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
    moe_experts=16, moe_top_k=2, moe_d_ff=14336,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    rope="none",          # Jamba uses no positional encoding
))


def reduced():
    sb = (LayerSpec("mamba", "dense"), LayerSpec("attn", "moe"),
          LayerSpec("mamba", "moe"))
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        d_model=128, vocab=512,
        segments=((sb, 2),),
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        moe_experts=4, moe_top_k=2, moe_d_ff=256,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_conv=4,
        rope="none",
        capacity_factor=8.0)
