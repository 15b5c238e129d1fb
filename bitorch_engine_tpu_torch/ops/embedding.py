"""Binary embedding: a sign-packed table with a per-row scale, looked up
with a dense straight-through gradient, in PyTorch (the counterpart of
``bitorch_engine_tpu/ops/embedding.py``).  The backward writes the f32
``(vocab, dim)`` table gradient into the grad shadow; rows not looked up
are exactly 0, which DiodeMix reads as the rows to leave alone."""

from __future__ import annotations

import torch

from ..qtensor import BinaryEmbeddingQTensor
from . import packing


def quantize_binary_embedding(weight: torch.Tensor) -> BinaryEmbeddingQTensor:
    """fp table ``(vocab, dim)`` → packed signs + per-row mean |w| scale."""
    w = weight.float()
    padded, _ = packing.pad_to_multiple(w, 1, 32, value=-1.0)
    return BinaryEmbeddingQTensor(data=packing.pack_signs(padded),
                                  scale=w.abs().mean(dim=1, keepdim=True), dim=weight.shape[1])


def _lookup(indices: torch.Tensor, qt: BinaryEmbeddingQTensor) -> torch.Tensor:
    dim = qt.logical_shape[1]
    idx = indices.long()
    return packing.unpack_signs(qt.data[idx])[..., :dim] * qt.scale[idx]


class _BinaryEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, indices, shadow, qt):
        ctx.save_for_backward(indices)
        ctx.qt = qt
        return _lookup(indices, qt)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        vocab, dim = ctx.qt.logical_shape
        dense = torch.zeros((vocab, dim), dtype=torch.float32, device=g.device)
        dense.index_add_(0, indices.reshape(-1).long(), g.reshape(-1, dim).float())
        return None, dense, None


def binary_embedding(indices: torch.Tensor, qt: BinaryEmbeddingQTensor) -> torch.Tensor:
    """``(...)`` integer indices → ``(..., dim)`` f32 ``±scale`` rows;
    differentiable in ``qt.grad_shadow``."""
    shadow = qt.grad_shadow
    if torch.is_grad_enabled() and shadow is not None and shadow.requires_grad:
        return _BinaryEmbedding.apply(indices, shadow, qt)
    return _lookup(indices, qt)


def binary_embedding_bag(indices: torch.Tensor, qt: BinaryEmbeddingQTensor,
                         mode: str = "mean") -> torch.Tensor:
    """Pool the embeddings of each bag, ``indices (batch, bag)``: ``"mean"``
    of the scaled rows, or ``"majority"``, the sign of the vote (ties +1)."""
    emb = binary_embedding(indices, qt)
    if mode == "mean":
        return emb.mean(dim=1)
    if mode == "majority":
        return torch.sign(torch.sign(emb).sum(dim=1) + 0.5)
    raise ValueError(f"unknown mode {mode}")
