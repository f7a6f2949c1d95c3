"""Process groups as device meshes: one process per device, SPMD.

Counterpart of ``nonstationary_precip_tpu/parallel/mesh.py``.  JAX lays a
``jax.sharding.Mesh`` over the devices of one program; here each device
is driven by a process of its own, and a :class:`Mesh` is this process's
view of the group: its rank, the group's size, the axis names, and the
device it computes on.  An array JAX shards over the mesh's axis is, in
a process, its rank's rows (:func:`data_sharding`); an array JAX
replicates is held whole by every rank (:func:`replicated`).

``init_world`` starts the default group from a store (a ``FileStore``
path needs no network): NCCL for CUDA, gloo for the CPU, never gloo for
CUDA tensors (``collectives`` refuses them).  Every group waits at most
``GROUP_TIMEOUT`` in a collective, so a rank that never arrives fails its
peers instead of hanging them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from nonstationary_precip_tpu_torch.utils.config import device as _device

DATA_AXIS = "data"
ROW_AXIS = "rows"
COL_AXIS = "cols"

#: How long a collective waits for the other ranks before it raises.
GROUP_TIMEOUT = timedelta(seconds=60)


@dataclass
class Mesh:
    """This process's place in a 1-D or 2-D mesh of ranks.

    ``group`` spans the whole mesh; ``groups`` maps each axis to the
    subgroup of the ranks that differ only along it (for a 1-D mesh, the
    whole mesh); ``coords`` maps each axis to this rank's index along it.
    Ranks are laid out row-major, as ``np.reshape`` lays JAX's devices."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    axis: tuple
    shape: dict
    device: torch.device
    groups: dict = field(default_factory=dict)
    coords: dict = field(default_factory=dict)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def rows(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """This rank's block of x's leading axis along ``axis`` (default:
        the mesh's first), the rows JAX's ``P(axis)`` gives its device."""
        axis = axis or self.axis[0]
        p, i = self.shape[axis], self.coords[axis]
        n = x.shape[0]
        if n % p:
            raise ValueError(f"{n} rows do not divide over the {p} ranks of mesh axis {axis!r}")
        return x[i * (n // p):(i + 1) * (n // p)]


def init_world(world: int, rank: int, store, device: str = "cuda",
               timeout: timedelta = GROUP_TIMEOUT) -> torch.device:
    """Start the default process group of ``world`` ranks from ``store`` (a
    ``dist.Store`` or the path of a ``FileStore``) and return this rank's
    device: ``cuda:{rank % device_count}`` on NCCL, or the CPU on gloo
    (``device="cpu"``).  Asking for CUDA where there is none raises."""
    dev = _device(device)
    if isinstance(store, (str, os.PathLike)):
        store = dist.FileStore(os.fspath(store), world)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_world: device must be cuda or cpu, got {device!r}")
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)
    return dev


def _world_device() -> torch.device:
    """The device the default group computes on: the current CUDA device
    under NCCL, the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_world (or torch.distributed."
                           "init_process_group) first")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` ranks (all by default).  Asking
    for more ranks than the group has raises: a silently smaller mesh would
    fail far away (split counts, shard shapes) with the cause misattributed.
    Every rank of the default group must call it; a rank outside the first
    ``n_devices`` gets None."""
    dev = _world_device()
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"make_mesh: need {n} devices, have {world} — a silently smaller mesh would fail far "
                         "away (split counts, shard shapes) with the cause misattributed")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)), timeout=GROUP_TIMEOUT)
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(group=group, rank=rank, size=n, axis=(axis,), shape={axis: n}, device=dev,
                groups={axis: group}, coords={axis: rank})


def make_mesh_2d(n_rows: int, n_cols: int, row_axis: str = ROW_AXIS, col_axis: str = COL_AXIS) -> Optional[Mesh]:
    """2-D (n_rows × n_cols) mesh over the first n_rows·n_cols ranks, row
    major: rank = row·n_cols + col.  The ``col_axis`` subgroup of a rank is
    its row of the mesh (the ranks that differ in their column), the
    ``row_axis`` subgroup its column.  Every rank of the default group must
    call it (the subgroups are made on all of them); a rank outside the
    mesh gets None."""
    dev = _world_device()
    world = dist.get_world_size()
    need = n_rows * n_cols
    if need > world:
        raise ValueError(f"make_mesh_2d: need {need} devices, have {world}")
    group = dist.group.WORLD if need == world else dist.new_group(list(range(need)), timeout=GROUP_TIMEOUT)
    rank = dist.get_rank()
    ri, ci = divmod(rank, n_cols)
    along_cols = along_rows = None
    for r in range(n_rows):  # every rank makes every subgroup, in one order
        g = dist.new_group([r * n_cols + c for c in range(n_cols)], timeout=GROUP_TIMEOUT)
        if r == ri:
            along_cols = g
    for c in range(n_cols):
        g = dist.new_group([r * n_cols + c for r in range(n_rows)], timeout=GROUP_TIMEOUT)
        if c == ci:
            along_rows = g
    if rank >= need:
        return None
    return Mesh(group=group, rank=rank, size=need, axis=(row_axis, col_axis),
                shape={row_axis: n_rows, col_axis: n_cols}, device=dev,
                groups={row_axis: along_rows, col_axis: along_cols}, coords={row_axis: ri, col_axis: ci})


def data_sharding(mesh: Mesh, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
    """This rank's rows of x (JAX: the shard ``NamedSharding(mesh, P(axis))``
    places on this device)."""
    return mesh.rows(x, axis)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x whole, on this rank's device (JAX: ``NamedSharding(mesh, P())``)."""
    return x.to(mesh.device)


def tile(mesh: Mesh, a: torch.Tensor) -> torch.Tensor:
    """This rank's (N/R, N/C) tile of a on a 2-D mesh (JAX:
    ``P(ROW_AXIS, COL_AXIS)``)."""
    row_axis, col_axis = mesh.axis
    return mesh.rows(mesh.rows(a, row_axis).mT, col_axis).mT
