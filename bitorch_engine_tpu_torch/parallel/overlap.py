"""The ring-overlapped row-parallel MPQ product: the counterpart of
``bitorch_engine_tpu/parallel/overlap.py``.

The JAX package builds a ring under ``shard_map``: the output accumulator
rotates with ``lax.ppermute`` while each device runs the dequant matmul of
the next column chunk, and XLA's scheduler overlaps the two.  Here the ring
is explicit: at each step the accumulator's send to the next rank (and the
receive from the previous one) is posted first, then the next chunk's
product is launched (kernel 1 on the card at decode rows), then the
receive is awaited and added.  The order is recorded in ``trace`` when one
is given (the CPU tests read it, as the JAX tests read the jaxpr).

Numbers match the unsharded product to f32 reduction-reorder tolerance:
each rank's partials are f32, added across ranks in ring order, and cast
once at the end.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..ops.mpq_linear import mpq_linear
from ..ops.quant import slice_mpq_n
from ..qtensor import MPQTensor
from .comm import all_gather, ring_exchange
from .mesh import Mesh
from .sharding import mpq_row_parallel_spec, shard_record


@dataclasses.dataclass(frozen=True)
class RingShards:
    """This rank's K rows ``[k0, k1)`` of a tensor, cut once into the
    ring's D contiguous column chunks."""

    chunks: Tuple[MPQTensor, ...]
    k0: int
    k1: int


def ring_shards(qt: MPQTensor, mesh: Mesh, axis: str = "tp") -> RingShards:
    """Cut this rank's shard of ``qt`` for :func:`ring_row_parallel_mpq`.
    Act-order tensors, a K that does not split into whole groups per rank
    and an N that does not split over the ring raise ``ValueError``."""
    if qt.g_idx is not None or qt.q_perm is not None:
        raise ValueError(
            "ring_row_parallel_mpq: act-order tensors (g_idx/q_perm) cannot shard along K")
    d, i = mesh.size(axis), mesh.coord(axis)
    k, n = qt.logical_shape
    if k % (d * qt.group_size):
        raise ValueError("K must split into whole groups per device")
    if n % d:
        raise ValueError(f"N={n} not divisible by ring size {d}")
    qt = qt.replace(grad_shadow=None)
    rows = shard_record(qt, mpq_row_parallel_spec(qt, axis, n_shards=d), mesh)
    n_per = n // d
    chunks = tuple(slice_mpq_n(rows, c * n_per, n_per) for c in range(d))
    return RingShards(chunks, i * (k // d), (i + 1) * (k // d))


def ring_reduce_scatter_mpq(x_local: torch.Tensor, chunks, mesh: Mesh, axis: str = "tp",
                            trace: Optional[List] = None) -> torch.Tensor:
    """Row-parallel product with a ring reduce-scatter epilogue.

    ``x_local``: ``(m, K/D)``, this rank's slice of the activations;
    ``chunks``: this rank's K rows cut into D column chunks.  Returns
    ``(m, N/D)`` f32: column chunk ``i`` (this rank's index) of the summed
    output.  At step ``s`` rank ``i`` computes its partial of chunk ``(i - s
    - 1) mod D`` and adds the accumulator arriving from rank ``i - 1``,
    which holds the same chunk's partials of the ranks upstream."""
    d, i = mesh.size(axis), mesh.coord(axis)
    acc = None
    for s in range(d):
        chunk = chunks[(i - s - 1) % d]
        if acc is None:
            acc = mpq_linear(x_local, chunk, out_dtype=torch.float32)
            if trace is not None:
                trace.append(("product", s))
            continue
        pending = ring_exchange(mesh, acc, axis)
        if trace is not None:
            trace.append(("send", s))
        part = mpq_linear(x_local, chunk, out_dtype=torch.float32)
        if trace is not None:
            trace.append(("product", s))
        acc = pending.wait() + part
        if trace is not None:
            trace.append(("recv", s))
    return acc


def ring_row_parallel_mpq(x: torch.Tensor, qt: MPQTensor, mesh: Mesh, axis: str = "tp",
                          shards: Optional[RingShards] = None,
                          trace: Optional[List] = None) -> torch.Tensor:
    """``mpq_linear(x, qt)`` with K split over ``axis``: each rank takes its
    K slice of the (replicated) ``x``, runs :func:`ring_reduce_scatter_mpq`
    and gathers the column chunks back (the second collective), cast to
    ``x.dtype``.  ``shards`` (:func:`ring_shards`) are cut on every call
    when not given; a caller that calls again passes them."""
    if shards is None:
        shards = ring_shards(qt, mesh, axis)
    lead, k = x.shape[:-1], x.shape[-1]
    x_local = x.reshape(-1, k)[:, shards.k0 : shards.k1].contiguous()
    out = ring_reduce_scatter_mpq(x_local, shards.chunks, mesh, axis, trace)
    return all_gather(mesh, out, axis, dim=-1).to(x.dtype).reshape(*lead, -1)
