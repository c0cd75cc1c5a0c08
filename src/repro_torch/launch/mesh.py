"""Mesh construction.

Port of ``repro.launch.mesh``.  A :class:`Mesh` is the world's ranks
(one process, one card each, over ``torch.distributed``) reshaped
(data, model) in rank order, with this process's coordinates and a
process group along each axis: ``data_group`` holds the ranks that share
this rank's ``model`` index (they split the batch), ``model_group`` the
ranks that share its ``data`` index.  Every process of the parent group
makes every axis group, in one order, after they agree on torch's count
of groups (``grid.new_group``).  A mesh of one rank has no groups, and
without ``torch.distributed`` the world is this process alone.
Functions, never module-level constants: importing this module touches
no device or process group.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    #: the mesh's global ranks, shaped by ``axis_names``
    ranks: np.ndarray
    #: this process's coordinates in ``ranks``
    coords: Tuple[int, ...]
    device: torch.device
    #: the process group the mesh was made in (None: one process)
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


def _world():
    """(world size, this process's rank, the default group or None)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, None
    return dist.get_world_size(), dist.get_rank(), dist.group.WORLD


def _device_of(device) -> torch.device:
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _axis_groups(ranks: np.ndarray, coords, parent, device):
    """(data group, model group) of the process at ``coords``: every
    process of ``parent`` makes each data column's group, then each
    model row's, in one order.  None where an axis has one rank."""
    from repro_torch.core import grid as _grid
    among = types.SimpleNamespace(group=parent, device=device)
    data_g = model_g = None
    if ranks.shape[0] > 1:
        for j in range(ranks.shape[1]):
            g = _grid.new_group([int(r) for r in ranks[:, j]], among)
            if coords is not None and j == coords[1]:
                data_g = g
    if ranks.shape[1] > 1:
        for i in range(ranks.shape[0]):
            g = _grid.new_group([int(r) for r in ranks[i, :]], among)
            if coords is not None and i == coords[0]:
                model_g = g
    return data_g, model_g


def mesh_over(n: int, data: int, model: int, device=None) -> Mesh:
    """A (data, model) mesh over the first ``n`` = data * model ranks of
    the world.  Every process of the world must call it (the axis groups
    are made by all); a process beyond the first ``n`` raises
    ``api.RankRetired`` once the groups exist."""
    world, rank, parent = _world()
    if data * model != n or n > world or n < 1:
        raise ValueError(f"a ({data}, {model}) mesh over {n} of {world} "
                         f"ranks")
    dev = _device_of(device)
    ranks = np.arange(n).reshape(data, model)
    coords = (tuple(int(c) for c in np.argwhere(ranks == rank)[0])
              if rank < n else None)
    data_g, model_g = ((None, None) if parent is None
                       else _axis_groups(ranks, coords, parent, dev))
    if coords is None:
        from repro_torch.core.api import RankRetired
        raise RankRetired(f"rank {rank} holds no rank of the ({data}, "
                          f"{model}) mesh over {n} ranks", rank, n, None)
    return Mesh(("data", "model"), ranks, coords, dev, parent, data_g,
                model_g)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The target deployment mesh: 16 x 16 = 256 ranks ("data",
    "model"); multi-pod = 2 x 16 x 16 = 512 ranks with a leading "pod"
    axis for hierarchical data parallelism.  Raises unless the world has
    that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world, rank, parent = _world()
    if world != n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {n} ranks, the world has {world}")
    dev = _device_of(device)
    ranks = np.arange(n).reshape(shape)
    flat = ranks.reshape(-1, shape[-1])
    coords2 = tuple(int(c) for c in np.argwhere(flat == rank)[0])
    data_g, model_g = _axis_groups(flat, coords2, parent, dev)
    coords = tuple(int(c) for c in np.argwhere(ranks == rank)[0])
    return Mesh(axes, ranks, coords, dev, parent, data_g, model_g)


def make_local_mesh(data: int | None = None, model: int = 1,
                    device=None) -> Mesh:
    """Development mesh over the world's ranks (tests, examples): data
    defaults to world // model."""
    world, _, _ = _world()
    data = data if data is not None else world // model
    return mesh_over(data * model, data, model, device)


def sparse_grid_from_production(mesh: Mesh, c: int):
    """Reinterpret the mesh for the paper's sparse kernels: its ranks,
    flattened in order, as a (p/c, c) (layer, fiber) ``Grid15`` on the
    mesh's process group (the mesh must cover the whole world)."""
    from repro_torch.core import grid as _grid
    p = mesh.size
    if p % c:
        raise ValueError(f"c={c} must divide the mesh's {p} ranks")
    if mesh.group is None:
        return _grid.make_grid15(c, devices=[mesh.device])
    if p != _world()[0]:
        raise ValueError(f"the mesh holds {p} of the world's "
                         f"{_world()[0]} ranks; a sparse grid is made "
                         f"over the whole world")
    return _grid.make_grid15(c, devices=[mesh.device] * p,
                             group=mesh.group)
