"""Assigned-architecture configs (a copy of ``repro.configs``).  Importing
this package registers all."""
from repro_torch.configs import (  # noqa: F401
    jamba_v01_52b,
    stablelm_1_6b,
    llama32_1b,
    qwen3_1_7b,
    qwen3_4b,
    qwen2_vl_72b,
    mamba2_1_3b,
    deepseek_v2_lite_16b,
    phi35_moe_42b,
    hubert_xlarge,
    paper_gnn,
    lm_100m,
)

ARCH_IDS = [
    "jamba-v0.1-52b",
    "stablelm-1.6b",
    "llama3.2-1b",
    "qwen3-1.7b",
    "qwen3-4b",
    "qwen2-vl-72b",
    "mamba2-1.3b",
    "deepseek-v2-lite-16b",
    "phi3.5-moe-42b-a6.6b",
    "hubert-xlarge",
]
