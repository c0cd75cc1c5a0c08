"""Config resolution of the training driver.

Port of the part of ``repro.launch.train`` that the serve driver shares:
``SMOKE_MODULES`` and :func:`resolve_config`.  ``--smoke`` swaps in the
reduced config of the same family.  The training driver itself (its data
pipeline, train step, checkpoints and mesh) is not ported yet.
"""
from __future__ import annotations

import importlib

from repro_torch.config import get_config

SMOKE_MODULES = {
    "jamba-v0.1-52b": "jamba_v01_52b", "stablelm-1.6b": "stablelm_1_6b",
    "llama3.2-1b": "llama32_1b", "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-4b": "qwen3_4b", "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "hubert-xlarge": "hubert_xlarge",
}


def resolve_config(arch: str, smoke: bool):
    if smoke:
        mod = importlib.import_module("repro_torch.configs."
                                      + SMOKE_MODULES[arch])
        return mod.reduced()
    return get_config(arch)
