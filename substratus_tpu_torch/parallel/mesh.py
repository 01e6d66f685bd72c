"""The mesh of a gang's ranks (port of substratus_tpu/parallel/mesh.py).

The JAX mesh lays devices out on named axes and lets XLA insert the
collectives; the port's mesh lays the gang's ranks out on the same named
axes, in the same order, and holds what a rank needs to issue collectives
itself: the axis sizes, this rank's coordinate on each axis, and a process
group per axis larger than 1 (the ranks that differ only on that axis).

  axis        parallelism
  ----        -----------
  "data"      pure data parallelism (replicated params)
  "fsdp"      ZeRO-3 style data parallelism (params sharded over this axis)
  "sequence"  context/sequence parallelism (ring attention shards seq here)
  "tensor"    megatron-style tensor parallelism (heads / mlp sharded)
  "expert"    expert parallelism for MoE layers

The port serves the tensor axis (models/llama.py's tensor-parallel
forward); the others carry their sizes and groups for the slices that
will use them.
"""
from __future__ import annotations

import datetime
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from substratus_tpu_torch.parallel import distributed

# Outer to inner, the JAX package's registry, literal and in its order:
# ranks are laid out row-major over these sizes.
MESH_AXES = ("data", "stage", "fsdp", "sequence", "tensor", "expert")

KNOWN_AXES = frozenset(MESH_AXES)


def axis_names(axis) -> tuple:
    """Flatten one spec entry (an axis name, a tuple of names, or None) to
    a tuple of axis names."""
    if axis is None:
        return ()
    if isinstance(axis, (tuple, list)):
        return tuple(axis)
    return (axis,)


@dataclass
class Mesh:
    """Axis sizes over `MESH_AXES` (`shape`, in that order), this rank's
    coordinate on each (`coords`) and, for each axis larger than 1 once
    the groups are made, the process group of the ranks that differ from
    this one only on it (`groups`)."""

    shape: Dict[str, int]
    rank: int = 0
    coords: Dict[str, int] = field(default_factory=dict)
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of `axis`; raises when the mesh has none."""
        if axis not in self.groups:
            raise ValueError(f"mesh axis {axis!r} (size {self.shape.get(axis)}) has no process group")
        return self.groups[axis]

    def describe(self) -> str:
        return " ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1) or "one rank"


def build_mesh(
    data: int = 1,
    fsdp: int = 1,
    sequence: int = 1,
    tensor: int = 1,
    expert: int = 1,
    stage: int = 1,
    *,
    dcn_data: int = 1,
    world: Optional[int] = None,
    rank: Optional[int] = None,
) -> Mesh:
    """A mesh over `world` ranks (default: the initialized process group's,
    else 1), this one `rank` (default: the group's, else 0). Any axis may
    be -1 exactly once, meaning "all remaining ranks"; sizes that do not
    fit raise the JAX package's errors. With dcn_data > 1, `data` must be
    divisible by it (the ranks are slice-ordered, so the row-major layout
    already keeps every other axis within a slice). With an initialized
    process group, every rank must call this with the same sizes: each
    axis larger than 1 gets its process groups, made in the same order on
    every rank, on the gang's data backend (parallel/distributed.py)."""
    initialized = dist.is_available() and dist.is_initialized()
    n = world if world is not None else (dist.get_world_size() if initialized else 1)
    sizes = [data, stage, fsdp, sequence, tensor, expert]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh sizes {sizes} != device count {n}")
    if dcn_data > 1 and sizes[0] % dcn_data:
        raise ValueError(f"data axis {sizes[0]} not divisible by dcn slices {dcn_data}")
    me = rank if rank is not None else (dist.get_rank() if initialized else 0)
    layout = np.arange(n).reshape(sizes)
    where = np.argwhere(layout == me)[0]
    mesh = Mesh(shape=dict(zip(MESH_AXES, sizes)), rank=me, coords=dict(zip(MESH_AXES, map(int, where))))
    if initialized and world is None:
        gang = distributed.current()
        backend = gang.backend if gang is not None else dist.get_backend()
        timeout = None if gang is None else datetime.timedelta(seconds=gang.timeout_s)
        for i, axis in enumerate(MESH_AXES):
            if sizes[i] == 1:
                continue
            # Every line of ranks along this axis is one group; all ranks
            # make all groups, in the same order.
            lines = np.moveaxis(layout, i, -1).reshape(-1, sizes[i])
            for line in lines:
                group = dist.new_group([int(r) for r in line], backend=backend, timeout=timeout)
                if me in line:
                    mesh.groups[axis] = group
    return mesh


def local_mesh() -> Mesh:
    """The trivial mesh of one process."""
    return build_mesh(world=1, rank=0)
