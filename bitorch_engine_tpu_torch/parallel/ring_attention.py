"""Ring attention: exact attention with the sequence sharded over a ring of
ranks.  The counterpart of ``bitorch_engine_tpu/parallel/ring_attention.py``.

Every rank holds ``(b, h, L/n, d)`` of q, k and v: its shard of the
sequence.  The K/V shards rotate around the ring (``comm.ring_exchange``,
posted before each block so the transfer overlaps it); each rank attends
its q shard to every K/V shard in turn and combines the partial results.
Positions are absolute (shard ``i`` holds ``i·L/n + arange(L/n)``), so the
order of rotation does not matter.

Where the JAX package computes each (q-shard, kv-shard) block as an einsum
with running-softmax statistics (``_block_attn``) and combines them by
their max and sum (``_combine``), here each block is one call of the flash
attention wrapper (kernel 3 on the card, its plain version on the CPU),
which returns the block's output and its lse rows; the blocks combine
through their lse: ``out = Σ exp(lse_b − lse) · out_b`` with ``lse =
logaddexp`` over the blocks, in f32, cast once.  Under the causal mask:

* the diagonal block (a rank's own K/V) runs causal;
* a block from an earlier shard runs without a mask;
* a block from a later shard is fully masked.  The JAX package computes it
  (``out = 0, l = 0``, a finite ``m``) and adds nothing; here it is skipped.
  Its K/V still travel on, since the ranks behind need them.

The backward (one ``torch.autograd.Function`` over the whole ring) runs
kernel 4 on each visible block with the *combined* output and lse, so each
block's dq, dk and dv are exactly its share of the gradient.  dq sums on
the rank; dk and dv sum in f32 into accumulators that travel the ring with
their K/V shard and, one step after the last block, arrive back at the
shard's owner.

The wrappers are looked up in their module at call time, so a caller may
route them to their plain versions.
"""

from __future__ import annotations

import importlib
import math
from typing import Optional

import torch

from .comm import ring_exchange
from .mesh import Mesh

# the module (the package attribute of the same name is the wrapper function)
_fa = importlib.import_module("..ops.cuda.flash_attention", __package__)


def block_k(s: int) -> int:
    """The key tile of a block of ``s`` keys: the reference's
    ``pick_block(s)`` where ``s`` is a multiple of 128, else the whole
    block (the plain version takes any; the kernel takes multiples of 64)."""
    return _fa.pick_block(s) if s % 128 == 0 else s


def _visible(src: int, idx: int, causal: bool) -> bool:
    return not causal or src <= idx


def _exchange(mesh: Mesh, t: torch.Tensor, axis: str, post: bool):
    return ring_exchange(mesh, t, axis) if post else None


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh: Mesh, axis: str, sm_scale: float, causal: bool):
        n, idx = mesh.size(axis), mesh.coord(axis)
        bk = block_k(q.shape[2])
        kv = torch.stack((k, v))
        acc = lse = None
        for step in range(n):
            src = (idx - step) % n
            pending = _exchange(mesh, kv, axis, step < n - 1)
            if _visible(src, idx, causal):
                out_b, lse_b = _fa.flash_attention(q, kv[0], kv[1], causal and src == idx,
                                                   sm_scale, bk)
                if acc is None:  # step 0: the diagonal block, always visible
                    acc, lse = out_b.float(), lse_b
                else:
                    new = torch.logaddexp(lse, lse_b)
                    acc = (acc * torch.exp(lse - new)[..., None]
                           + out_b.float() * torch.exp(lse_b - new)[..., None])
                    lse = new
            if pending is not None:
                kv = pending.wait()
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, sm_scale, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, sm_scale, causal = ctx.args
        n, idx = mesh.size(axis), mesh.coord(axis)
        do = dout.contiguous()
        kv = torch.stack((k, v))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # the dk / dv accumulator of the K/V shard this rank holds
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for step in range(n):
            src = (idx - step) % n
            pending = _exchange(mesh, kv, axis, step < n - 1)
            if _visible(src, idx, causal):
                dq_b, dk_b, dv_b = _fa.flash_attention_bwd(
                    q, kv[0], kv[1], out, lse, do, causal and src == idx, sm_scale)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            # the accumulator follows its shard (after the last block, to its owner)
            dkv = ring_exchange(mesh, dkv, axis).wait() if n > 1 else dkv
            if pending is not None:
                kv = pending.wait()
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    sm_scale: Optional[float] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``.

    ``q``: this rank's ``(b, h, L/n, d)`` shard, ``k`` / ``v``: its ``(b,
    hkv, L/n, d)`` shards (``h`` a multiple of ``hkv``); returns this rank's
    ``(b, h, L/n, d)`` shard of the output, differentiable in q, k and v.
    Every rank of ``axis`` calls it together.  ``causal=False`` attends to
    every position (the JAX function masks causally whatever it is given).
    On the card the blocks run kernels 3 and 4, which take bf16 operands
    and ``L/n`` a multiple of 64."""
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), mesh, axis, sm, causal)
