"""Binary embedding layers (the counterpart of ``layers/embedding.py``):
``BinaryEmbedding`` and ``BinaryEmbeddingBag`` hold a
``BinaryEmbeddingQTensor`` (buffers ``data``, ``scale``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..ops.embedding import binary_embedding, binary_embedding_bag, quantize_binary_embedding
from ..qtensor import BinaryEmbeddingQTensor
from .linear import QuantLayer


class BinaryEmbedding(QuantLayer):
    """Sign-packed embedding table with a per-row scale.  Without
    ``qweight`` the constructor packs a random ``N(0, 0.02²)`` table on
    ``device`` (default ``cuda``)."""

    _RECORD = BinaryEmbeddingQTensor
    _BUFFERS = ("data", "scale")
    _STATIC = ("dim",)

    def __init__(self, vocab_size: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 qweight: Optional[BinaryEmbeddingQTensor] = None):
        super().__init__()
        if qweight is not None and device is None:
            device = qweight.device
        device = resolve_device(device)
        if qweight is None:
            w = torch.randn((vocab_size, features), generator=generator, device=device) * 0.02
            qweight = quantize_binary_embedding(w)
        self.set_qweight(qweight)

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        return binary_embedding(indices, self.qweight)


class BinaryEmbeddingBag(BinaryEmbedding):
    """Pooled binary embedding of ``(batch, bag)`` indices: ``mode`` "mean"
    or "majority"."""

    def __init__(self, vocab_size: int, features: int, mode: str = "mean", device=None,
                 generator: Optional[torch.Generator] = None,
                 qweight: Optional[BinaryEmbeddingQTensor] = None):
        super().__init__(vocab_size, features, device, generator, qweight)
        self.mode = mode

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        return binary_embedding_bag(indices, self.qweight, self.mode)
