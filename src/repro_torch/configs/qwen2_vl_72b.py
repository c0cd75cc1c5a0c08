"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) ff=29568 V=152064, M-RoPE.

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings + (t,h,w) position triples; this config is the
transformer backbone only.  [arXiv:2409.12191; hf]
"""
from repro_torch.config import LayerSpec, ModelConfig, register

A = LayerSpec("attn", "dense")

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    d_model=8192, vocab=152064,
    segments=(((A,), 80),),
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568,
    rope="mrope", rope_theta=1e6, pos_dims=3,
    embed_inputs=False,     # frontend stub feeds embeddings
))


def reduced():
    return ModelConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        d_model=128, vocab=512,
        segments=(((A,), 2),),
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=384,
        rope="mrope", pos_dims=3, embed_inputs=False)
