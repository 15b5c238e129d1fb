"""The process mesh: the counterpart of ``bitorch_engine_tpu/parallel/mesh.py``.

One process is one rank.  The ranks of the world are laid out as the JAX
package lays out its devices, ``arange(world).reshape(dp, fsdp, tp)`` with
tp fastest, under the same axis names:

* ``dp``   data parallel (slots of the serving batch);
* ``fsdp`` parameter and optimizer sharding (training);
* ``tp``   tensor parallel (heads, the MLP's intermediate features, the
  head's vocabulary).

:func:`make_mesh` makes one ``torch.distributed`` group per axis line, on
every rank and in the same order (``new_group`` is collective), and keeps
this rank's group of each axis.  Without a process group the mesh is the
one-process world: every axis of size 1, no group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a ``(dp, fsdp, tp)`` layout of the world.

    ``shape`` maps each axis to its size; ``rank`` is this process's global
    rank; ``groups[axis]`` is the process group of the ranks that differ
    from this one along ``axis`` only (``None`` for an axis of size 1), and
    ``ranks[axis]`` their global ranks in axis order.  ``comm_counts`` is
    filled by ``parallel.comm`` (calls, bytes, ms and staged calls per kind
    of collective)."""

    shape: Dict[str, int]
    rank: int
    groups: Dict[str, Optional[dist.ProcessGroup]]
    ranks: Dict[str, Tuple[int, ...]]
    backend: Optional[str] = None
    comm_counts: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.ranks[axis].index(self.rank)


def make_mesh(dp: int = 1, fsdp: int = 1, tp: Optional[int] = None) -> Mesh:
    """Lay the world out as ``(dp, fsdp, tp)``; ``tp`` defaults to what the
    world leaves.  Every rank must call it with the same arguments."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if tp is None:
        tp = n // (dp * fsdp)
    if dp * fsdp * tp != n:
        raise ValueError(f"dp*fsdp*tp = {dp * fsdp * tp} != {n} devices")
    grid = np.arange(n).reshape(dp, fsdp, tp)
    shape = dict(zip(AXES, (dp, fsdp, tp)))
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    ranks: Dict[str, Tuple[int, ...]] = {}
    for i, axis in enumerate(AXES):
        # every line of the grid along this axis, in a fixed order
        lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        groups[axis] = None
        for line in lines:
            members = tuple(int(r) for r in line)
            group = dist.new_group(list(members)) if len(members) > 1 else None
            if rank in members:
                groups[axis], ranks[axis] = group, members
    backend = dist.get_backend() if initialized else None
    return Mesh(shape=shape, rank=rank, groups=groups, ranks=ranks, backend=backend)


def multihost_initialize(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``, a no-op when a
    process group already exists.  Unlike the JAX package's version, which
    swallows every ``RuntimeError`` and ``ValueError``, a failed
    initialisation raises: it must not pass for a one-process world."""
    if dist.is_initialized():
        return
    dist.init_process_group(**kwargs)
