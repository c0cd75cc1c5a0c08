"""Configuration system: model, parallelism, training, serving.

Port of ``repro.config``, a copy: the same classes, fields, defaults and
analytic parameter counts.  Every assigned architecture is a
``ModelConfig`` built in ``repro_torch/configs/<arch>.py`` and registered
under its id.  Layer stacks are expressed as repeated SEGMENTS of
heterogeneous super-blocks; the port's model (``models/model.py``) keeps
each repeat as one entry of a ``ModuleList`` and loops over them, while
hybrids like Jamba keep their exact interleave.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str           # "attn" | "mamba"
    ffn: str             # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    vocab: int
    # segments: ((layerspecs_in_superblock, repeat_count), ...)
    segments: Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope: str = "rope"              # "rope" | "mrope" | "none"
    rope_theta: float = 1e4
    causal: bool = True
    # dense ffn
    d_ff: int = 0
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    mla_kv_lora: int = 0
    mla_rope_dim: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # embeddings / io
    tie_embeddings: bool = False
    embed_inputs: bool = True       # False: frontend stub feeds embeddings
    pos_dims: int = 1               # 3 for M-RoPE
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_layers(self) -> int:
        return sum(len(sb) * cnt for sb, cnt in self.segments)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        total += d                                           # final norm
        for sb, cnt in self.segments:
            seg = 0
            for spec in sb:
                if spec.mixer == "attn":
                    if self.mla_kv_lora:
                        kvl, rd = self.mla_kv_lora, self.mla_rope_dim
                        seg += d * self.n_heads * (hd + rd)      # W_q
                        seg += d * (kvl + rd)                    # W_dkv, W_kpe
                        seg += kvl * self.n_heads * hd * 2       # W_uk, W_uv
                        seg += self.n_heads * hd * d             # W_o
                    else:
                        seg += d * self.n_heads * hd             # W_q
                        seg += 2 * d * self.n_kv_heads * hd      # W_k, W_v
                        seg += self.n_heads * hd * d             # W_o
                else:   # mamba2
                    din = self.d_inner
                    g = 2 * self.ssm_state                       # B and C
                    seg += d * (2 * din + g + self.ssm_heads)    # in_proj
                    seg += (din + g) * (self.ssm_conv + 1)       # conv w+b
                    seg += din * d                               # out_proj
                    seg += 3 * self.ssm_heads                    # A, D, dt_b
                    seg += din                                   # gated norm
                if spec.ffn == "dense":
                    seg += 3 * d * self.d_ff
                elif spec.ffn == "moe":
                    seg += d * self.moe_experts                  # router
                    seg += self.moe_experts * 3 * d * self.moe_d_ff
                    seg += self.moe_shared * 3 * d * self.moe_d_ff
                seg += d * (2 if spec.ffn != "none" else 1)      # norms
            total += seg * cnt
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe_experts:
            return self.param_count()
        full_e = self.moe_experts
        active_e = self.moe_top_k
        diff = 0
        for sb, cnt in self.segments:
            for spec in sb:
                if spec.ffn == "moe":
                    diff += cnt * (full_e - active_e) * 3 * \
                        self.d_model * self.moe_d_ff
        return self.param_count() - diff


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Parallelism and numerics of a run.

    The port's forward reads ``compute_dtype`` and ``flash_block``;
    ``init_params`` takes ``param_dtype`` as its own argument.  The
    partition specs (``models.model.param_specs``, ``cache_specs``,
    ``batch_axes``) read ``data_axis``, ``model_axis``, ``pod_axis``,
    ``dp_over_model`` and ``seq_shard_decode``, as the reference's do.
    The port executes a mesh's data axis and, for training, its model
    axis (``distributed/tensor_parallel.py``, which also reads
    ``seq_parallel``; ``dp_over_model`` turns that axis into data
    parallelism) and FSDP over the data axis (``distributed/fsdp.py``).
    The training forward (``models.model._forward_tp``) reads ``remat``:
    "full" and "dots" alike run each block under
    ``torch.utils.checkpoint``.  ``scan_layers`` and
    ``shard_embed_data`` are kept with the reference's defaults, and
    nothing reads them.
    """
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None      # set for the multi-pod mesh
    remat: str = "none"                 # "none" | "full" | "dots"
    scan_layers: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # beyond-paper knobs (exercised in §Perf)
    shard_embed_data: bool = False      # activation-sharded embeddings
    dp_over_model: bool = False         # TP off: model axis becomes extra
                                        # data parallelism (right mapping
                                        # for small models on big meshes)
    seq_parallel: bool = False          # Megatron-SP: residual stream
                                        # sequence-sharded over model axis
                                        # between TP regions (AR -> RS+AG)
    flash_block: int = 512              # flash-attention KV block
    seq_shard_decode: bool = False      # shard long KV caches along seq


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 4096
    global_batch: int = 256
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup: int = 100
    steps: int = 1000
    microbatch: int = 0                 # 0 = no accumulation
    grad_compress: str = "none"         # "none" | "int8"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    seq_len: int = 32768                # KV cache length
    batch: int = 128
    prefill_chunk: int = 2048


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
