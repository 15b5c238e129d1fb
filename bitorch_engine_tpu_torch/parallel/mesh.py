"""The process mesh: the counterpart of ``bitorch_engine_tpu/parallel/mesh.py``.

One process is one rank.  The ranks of the world are laid out as the JAX
package lays out its devices, ``arange(world).reshape(*sizes)`` with the
last axis fastest.  :func:`make_mesh` gives the package's training and
serving layout under its axis names:

* ``dp``   data parallel (slots of the serving batch, rows of the train batch);
* ``fsdp`` optimizer sharding (training: each rank updates its rows);
* ``tp``   tensor parallel (heads, the MLP's intermediate features, the
  head's vocabulary).

:func:`make_axes_mesh` lays out any named axes, as the JAX tests' ``Mesh(devices,
("sp",))``, ``("pp",)`` and ``("ep",)`` do: ``sp`` sequence parallel
(``parallel/ring_attention.py``, ``parallel/ulysses.py``), ``pp`` pipeline
stages (``parallel/pipeline.py``), ``ep`` experts (``ops/moe.py``).

Both make one ``torch.distributed`` group per axis line, on every rank and
in the same order (``new_group`` is collective), and keep this rank's group
of each axis.  Without a process group the mesh is the one-process world:
every axis of size 1, no group.  An axis the mesh does not name raises
``KeyError``, as the JAX ``mesh.shape[axis]`` does: a misnamed axis must
not read as a world of one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a layout of the world over named axes.

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

    def __deepcopy__(self, memo) -> "Mesh":
        return self  # a process's view of the world: a copied model shares it

    def _named(self, axis: str) -> str:
        if axis not in self.shape:
            raise KeyError(f"the mesh has no axis {axis!r} (its axes: {tuple(self.shape)})")
        return axis

    def size(self, axis: str) -> int:
        return self.shape[self._named(axis)]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.ranks[self._named(axis)].index(self.rank)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The group of ``axis`` (``None`` for an axis of size 1)."""
        return self.groups[self._named(axis)]


def _world():
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    return n, rank, dist.get_backend() if initialized else None


def make_mesh(dp: int = 1, fsdp: int = 1, tp: Optional[int] = None) -> Mesh:
    """Lay the world out as ``(dp, fsdp, tp)``; ``tp`` defaults to what the
    world leaves.  Every rank must call it with the same arguments."""
    n = _world()[0]
    if tp is None:
        tp = n // (dp * fsdp)
    if dp * fsdp * tp != n:
        raise ValueError(f"dp*fsdp*tp = {dp * fsdp * tp} != {n} devices")
    return make_axes_mesh(**dict(zip(AXES, (dp, fsdp, tp))))


def make_axes_mesh(**sizes: int) -> Mesh:
    """Lay the world out over the named axes ``sizes`` (in order, the last
    fastest), e.g. ``make_axes_mesh(sp=4)`` or ``make_axes_mesh(dp=2,
    sp=2)``; their product must be the world size.  Every rank must call it
    with the same arguments."""
    n, rank, backend = _world()
    if int(np.prod(list(sizes.values()), dtype=np.int64)) != n:
        raise ValueError(f"axes {sizes} do not lay out {n} devices")
    grid = np.arange(n).reshape(*sizes.values())
    shape = dict(sizes)
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    ranks: Dict[str, Tuple[int, ...]] = {}
    for i, axis in enumerate(sizes):
        # every line of the grid along this axis, in a fixed order
        lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        groups[axis] = None
        for line in lines:
            members = tuple(int(r) for r in line)
            group = dist.new_group(list(members)) if len(members) > 1 else None
            if rank in members:
                groups[axis], ranks[axis] = group, members
    return Mesh(shape=shape, rank=rank, groups=groups, ranks=ranks, backend=backend)


def multihost_initialize(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``, a no-op when a
    process group already exists.  Unlike the JAX package's version, which
    swallows every ``RuntimeError`` and ``ValueError``, a failed
    initialisation raises: it must not pass for a one-process world."""
    if dist.is_initialized():
        return
    dist.init_process_group(**kwargs)
