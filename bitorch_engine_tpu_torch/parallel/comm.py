"""The collectives of the parallel paths, over ``torch.distributed``.

The JAX package has no such module: under GSPMD and ``shard_map``, XLA
inserts the collectives itself.  Here the model calls them where GSPMD put
them:

* :func:`all_reduce`: the f32 sum of a row-parallel projection's partials
  (after o and after down), of the gradients over dp and sp;
* :func:`all_gather`: concatenation along an axis, the column-parallel
  head's logits along the vocabulary, the dp groups' tokens along the
  slots, the fsdp ranks' updated rows, the ep ranks' expert outputs;
* :func:`all_to_all`: split along one dimension and concatenated along
  another, as ``lax.all_to_all(..., tiled=True)`` (Ulysses);
* :func:`ring_exchange`: the ring's send to the next rank and receive
  from the previous one, as ``lax.ppermute`` (the overlapped row-parallel
  product; ring attention, whose autograd Function runs its backward's
  exchanges itself);
* :func:`send` / :func:`recv`: one tensor to a neighbour (the pipeline).

Each call adds to ``mesh.comm_counts[kind]``: ``calls``, the ``bytes`` this
rank sends, host ``ms`` (the call blocks until its data is in place, except
the ring's, whose wait is counted under ``ring_wait``, and ``send``, which
returns at once) and ``staged``.

The kinds a backward needs are differentiable through their autograd
Functions: :func:`all_to_all_diff` (backward: the inverse all-to-all),
:func:`all_gather_diff` (backward: this rank's slice, for an output every
rank holds whole and reads alike; with ``reduce=True`` the cotangent is
summed over the axis first, for an output each rank reads only in part)
and :func:`all_reduce_diff` (backward: the cotangent as it is, Megatron's
"g" after a row-parallel product); :func:`sum_grad` is the identity whose
backward sums the cotangent over an axis (a replicated tensor that each
rank uses for its own part of the work: Megatron's "f" before a
column-parallel product).

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

KINDS = ("all_reduce", "all_gather", "all_to_all", "ring_send", "ring_wait", "send", "recv")

# the kinds each backend takes on CUDA tensors as they are: gloo's
# all_reduce, all_gather and all_to_all take them (chip_smoke.py phases 19
# and 20 probe them on the card; gloo copies through the host itself), its
# point-to-point sends do not (they would read a device pointer as host
# memory)
CUDA_DIRECT = {
    "nccl": frozenset(KINDS),
    "gloo": frozenset({"all_reduce", "all_gather", "all_to_all"}),
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


def _like(src: torch.Tensor, staged: bool) -> torch.Tensor:
    """An empty tensor like ``src``; pinned host memory when staged (a
    pageable buffer would make the copy back to the device a slow,
    synchronous one)."""
    if staged:
        return torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    return torch.empty_like(src)


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place; returns ``t``."""
    group = mesh.group(axis)
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
    group = mesh.group(axis)
    if group is None:
        return t
    t0 = time.perf_counter()
    staged = _staged(mesh, "all_gather", t)
    src = _to_host(t) if staged else t.contiguous()
    parts = [_like(src, staged) for _ in mesh.ranks[axis]]
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
    ranks, group = mesh.ranks[axis], mesh.group(axis)
    i, d = ranks.index(mesh.rank), len(ranks)
    t0 = time.perf_counter()
    staged = _staged(mesh, "ring_send", t)
    src = _to_host(t) if staged else t.contiguous()
    buf = _like(src, staged)
    works = [
        dist.isend(src, dst=ranks[(i + 1) % d], group=group),
        dist.irecv(buf, src=ranks[(i - 1) % d], group=group),
    ]
    _count(mesh, "ring_send", t.nbytes, (time.perf_counter() - t0) * 1e3, staged)
    return RingRecv(mesh, works, src, buf, t.device, staged)


def all_to_all(mesh: Mesh, t: torch.Tensor, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True)``: ``t``
    cut into ``n`` equal chunks along ``split_dim``, chunk ``j`` sent to the
    ``j``-th rank of ``axis``; the chunks received concatenated along
    ``concat_dim`` in rank order."""
    group = mesh.group(axis)
    if group is None:
        return t
    n = mesh.size(axis)
    if t.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(t.shape)} does not split over {axis}={n}")
    t0 = time.perf_counter()
    staged = _staged(mesh, "all_to_all", t)
    parts = torch.stack(t.chunk(n, dim=split_dim))  # (n, ...): chunk j for rank j
    src = _to_host(parts) if staged else parts
    got = _like(src, staged)
    dist.all_to_all_single(got, src, group=group)
    if staged:
        got = got.to(t.device)
    out = torch.cat(got.unbind(0), dim=concat_dim)
    _count(mesh, "all_to_all", t.nbytes, (time.perf_counter() - t0) * 1e3, staged)
    return out


class PendingSend:
    """A posted :func:`send`: :meth:`wait` until the receiver has it (the
    tensor sent stays referenced until then)."""

    def __init__(self, work, src: torch.Tensor):
        self._work, self._src = work, src

    def wait(self) -> None:
        self._work.wait()


def send(mesh: Mesh, t: torch.Tensor, axis: str, to: int) -> PendingSend:
    """Post the send of ``t`` to the rank at coordinate ``to`` along
    ``axis``; returns at once."""
    t0 = time.perf_counter()
    staged = _staged(mesh, "send", t)
    src = _to_host(t) if staged else t.contiguous()
    work = dist.isend(src, dst=mesh.ranks[axis][to], group=mesh.group(axis))
    _count(mesh, "send", t.nbytes, (time.perf_counter() - t0) * 1e3, staged)
    return PendingSend(work, src)


def recv(mesh: Mesh, like: torch.Tensor, axis: str, frm: int) -> torch.Tensor:
    """The tensor the rank at coordinate ``frm`` along ``axis`` sends, of
    ``like``'s shape, dtype and device (waits for it)."""
    t0 = time.perf_counter()
    staged = _staged(mesh, "recv", like)
    buf = _like(like, staged)
    dist.recv(buf, src=mesh.ranks[axis][frm], group=mesh.group(axis))
    out = buf.to(like.device) if staged else buf
    _count(mesh, "recv", 0, (time.perf_counter() - t0) * 1e3, staged)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all(mesh, t, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return all_to_all(mesh, g.contiguous(), axis, concat_dim, split_dim), None, None, None, None


def all_to_all_diff(mesh: Mesh, t: torch.Tensor, axis: str, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all`, differentiable: its backward is the inverse
    all-to-all (``concat_dim`` split, ``split_dim`` concatenated)."""
    return _AllToAll.apply(t, mesh, axis, split_dim, concat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim, reduce):
        ctx.args = (mesh, axis, dim, t.shape[dim], reduce)
        return all_gather(mesh, t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, size, reduce = ctx.args
        if reduce:
            g = all_reduce(mesh, g.contiguous().clone(), axis)
        return g.narrow(dim, mesh.coord(axis) * size, size), None, None, None, None


def all_gather_diff(mesh: Mesh, t: torch.Tensor, axis: str, dim: int,
                    reduce: bool = False) -> torch.Tensor:
    """:func:`all_gather`, differentiable.  For an output that every rank
    holds whole and reads alike (one loss, replicated) the backward keeps
    this rank's slice of the cotangent and sums nothing; with ``reduce``,
    for an output each rank reads only in part (its own rows of it), the
    cotangent is summed over ``axis`` before the slice is kept (a
    reduce-scatter)."""
    return _AllGather.apply(t, mesh, axis, dim, reduce)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(mesh, t.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_diff(mesh: Mesh, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (a new tensor), differentiable for a
    sum that every rank then reads alike (a row-parallel product's
    partials): the backward passes the cotangent through unchanged, each
    rank's partial having the whole sum's.  Without autograd it is
    :func:`all_reduce` in place."""
    if mesh.group(axis) is None:
        return t
    if not (torch.is_grad_enabled() and t.requires_grad):
        return all_reduce(mesh, t, axis)
    return _AllReduce.apply(t, mesh, axis)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return all_reduce(mesh, g.contiguous().clone(), axis), None, None


def sum_grad(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t``, whose cotangent the backward sums over ``axis``: for a tensor
    every rank holds alike and reads only in part (its own experts' rows),
    so that each rank's gradient is the whole one."""
    if mesh.group(axis) is None or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _SumGrad.apply(t, mesh, axis)
