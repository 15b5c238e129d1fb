"""Ulysses sequence parallelism: all-to-all head redistribution.  The
counterpart of ``bitorch_engine_tpu/parallel/ulysses.py``.

Every rank holds ``(b, h, L/n, d)`` of q, k and v.  One all-to-all each
(``comm.all_to_all_diff``: heads split, sequence shards concatenated) gives
every rank all ``L`` positions of ``h/n`` heads; it runs ordinary causal
flash attention on them (``FlashAttention``: kernel 3 forward, kernel 4
backward on the card; their plain versions on the CPU), and one all-to-all
back restores the sequence sharding.  The backward of each all-to-all is
the inverse one.  Each head sees its whole sequence, so the result is the
unsharded attention's, head for head.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.cuda.flash_attention import flash_attention_diff
from .comm import all_to_all_diff
from .mesh import Mesh
from .ring_attention import block_k


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    sm_scale: Optional[float] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``.

    ``q``: this rank's ``(b, h, L/n, d)`` shard, ``k`` / ``v`` its ``(b,
    hkv, L/n, d)`` shards; ``h`` (and ``hkv``) must divide by the axis
    size.  Returns this rank's ``(b, h, L/n, d)`` shard of the output,
    differentiable in q, k and v.  Every rank of ``axis`` calls it
    together.  ``causal=False`` attends to every position (the JAX
    function masks causally whatever it is given)."""
    n = mesh.size(axis)
    h, hkv = q.shape[1], k.shape[1]
    if h % n != 0 or hkv % n != 0:
        raise ValueError(f"heads {h} (KV {hkv}) not divisible by axis size {n}")

    def scatter_heads(t):  # (b, h, L/n, d) → (b, h/n, L, d)
        return all_to_all_diff(mesh, t.contiguous(), axis, split_dim=1, concat_dim=2)

    qh, kh, vh = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    ctx = flash_attention_diff(qh.contiguous(), kh.contiguous(), vh.contiguous(), causal,
                               sm_scale, block_k(qh.shape[2]))
    return all_to_all_diff(mesh, ctx, axis, split_dim=2, concat_dim=1)
