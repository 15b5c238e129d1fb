"""The collectives of the parallel serving path, over ``torch.distributed``.

The JAX package has no such module: under GSPMD, XLA inserts the
collectives itself.  Here the model calls them where GSPMD put them:

* :func:`all_reduce`: the f32 sum of a row-parallel projection's partials
  (after o and after down);
* :func:`all_gather`: concatenation along an axis, the column-parallel
  head's logits along the vocabulary, the dp groups' tokens along the slots;
* :func:`ring_exchange`: the ring's send of the accumulator to the next
  rank and receive from the previous one (``parallel/overlap.py``).

Each call adds to ``mesh.comm_counts[kind]``: ``calls``, the ``bytes`` this
rank sends, host ``ms`` (the call blocks until its data is in place, except
the ring's, whose wait is counted under ``ring_wait``) and ``staged``.

A backend that does not take CUDA tensors for a kind of collective
(:data:`CUDA_DIRECT`) gets them through pinned host memory: copied out,
exchanged on the host, copied back, and counted under ``staged``.  No call
falls back quietly from one form to the other; the table decides.
"""

from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

from .mesh import Mesh

KINDS = ("all_reduce", "all_gather", "ring_send", "ring_wait")

# the kinds each backend takes on CUDA tensors as they are: gloo's
# all_reduce and all_gather take them (chip_smoke.py phase 19 probes them on
# the card; gloo copies through the host itself), its point-to-point sends
# do not (they would read a device pointer as host memory)
CUDA_DIRECT = {
    "nccl": frozenset(KINDS),
    "gloo": frozenset({"all_reduce", "all_gather"}),
}


def _count(mesh: Mesh, kind: str, nbytes: int, ms: float, staged: bool) -> None:
    c = mesh.comm_counts.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0, "staged": 0})
    c["calls"] += 1
    c["bytes"] += nbytes
    c["ms"] += ms
    c["staged"] += int(staged)


def reset_comm_counts(mesh: Mesh) -> None:
    mesh.comm_counts.clear()


def _staged(mesh: Mesh, kind: str, t: torch.Tensor) -> bool:
    """Whether ``kind`` on ``t`` goes through host memory."""
    if t.device.type != "cuda":
        return False
    direct = CUDA_DIRECT.get(mesh.backend)
    if direct is None:
        raise ValueError(f"no CUDA collective table for backend {mesh.backend!r}")
    return kind not in direct


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place; returns ``t``."""
    group = mesh.groups[axis]
    if group is None:
        return t
    t0 = time.perf_counter()
    staged = _staged(mesh, "all_reduce", t)
    if staged:
        host = _to_host(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    _count(mesh, "all_reduce", t.nbytes, (time.perf_counter() - t0) * 1e3, staged)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in the
    axis's rank order."""
    group = mesh.groups[axis]
    if group is None:
        return t
    t0 = time.perf_counter()
    staged = _staged(mesh, "all_gather", t)
    src = _to_host(t) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in mesh.ranks[axis]]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(t.device)
    _count(mesh, "all_gather", t.nbytes, (time.perf_counter() - t0) * 1e3, staged)
    return out


class RingRecv:
    """A posted ring exchange: :meth:`wait` returns the tensor received
    from the previous rank (on the device of the one sent)."""

    def __init__(self, mesh: Mesh, works: List, src: torch.Tensor, buf: torch.Tensor,
                 device: torch.device, staged: bool):
        # the sent tensor stays referenced until the exchange completes
        self._mesh, self._works, self._src, self._buf = mesh, works, src, buf
        self._device, self._staged = device, staged

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        out = self._buf.to(self._device) if self._staged else self._buf
        _count(self._mesh, "ring_wait", 0, (time.perf_counter() - t0) * 1e3, self._staged)
        return out


def ring_exchange(mesh: Mesh, t: torch.Tensor, axis: str = "tp") -> RingRecv:
    """Post the send of ``t`` to the next rank along ``axis`` and the
    receive of the previous rank's, and return at once (the caller's work
    meanwhile overlaps the exchange)."""
    ranks, group = mesh.ranks[axis], mesh.groups[axis]
    i, d = ranks.index(mesh.rank), len(ranks)
    t0 = time.perf_counter()
    staged = _staged(mesh, "ring_send", t)
    src = _to_host(t) if staged else t.contiguous()
    buf = torch.empty_like(src)
    works = [
        dist.isend(src, dst=ranks[(i + 1) % d], group=group),
        dist.irecv(buf, src=ranks[(i - 1) % d], group=group),
    ]
    _count(mesh, "ring_send", t.nbytes, (time.perf_counter() - t0) * 1e3, staged)
    return RingRecv(mesh, works, src, buf, t.device, staged)
