"""The paper's own workloads: GAT forward pass + ALS collaborative
filtering, parameterized for the benchmark harness (not an LM config)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    n_nodes: int = 1 << 14
    nnz_per_row: int = 16
    r: int = 128            # embedding width
    n_heads: int = 4
    n_layers: int = 2
    algorithm: str = "auto"   # costmodel-driven selection


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    m: int = 1 << 14
    n: int = 1 << 14
    nnz_per_row: int = 16
    r: int = 128
    cg_iters: int = 10
    reg: float = 0.1
