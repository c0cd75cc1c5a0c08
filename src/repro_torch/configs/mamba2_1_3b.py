"""mamba2-1.3b [ssm]: 48L d=2048, attention-free, ssm_state=128, no FFN.

SSD (state-space duality) blocks only.  The paper's SDDMM/SpMM attention
technique is INAPPLICABLE to this family (no sampled-dense-dense product
anywhere) — noted in DESIGN.md; the arch runs without it.
[arXiv:2405.21060; unverified]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

M = LayerSpec("mamba", "none")

CONFIG = register(ModelConfig(
    name="mamba2-1.3b", family="ssm",
    d_model=2048, vocab=50280,
    segments=(((M,), 48),),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    rope="none", d_ff=0,
))


def reduced():
    return ModelConfig(
        name="mamba2-1.3b-smoke", family="ssm",
        d_model=128, vocab=512,
        segments=(((M,), 2),),
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_conv=4,
        rope="none", d_ff=0)
