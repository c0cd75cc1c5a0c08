"""A ~100M-parameter dense LM for the end-to-end training example."""
from repro_torch.config import LayerSpec, ModelConfig, register

A = LayerSpec("attn", "dense")

CONFIG = register(ModelConfig(
    name="lm-100m", family="dense",
    d_model=768, vocab=32768,
    segments=(((A,), 12),),
    n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
    rope="rope",
))
