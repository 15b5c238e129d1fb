"""Attention layers of the QAT family (the counterpart of
``layers/attention.py``): ``Q4MatMul`` (4-bit batched matmul with
learnable clips), ``LearnableBias`` (a per-channel shift) and ``BMHA``
(binary multi-head attention: binary q/k/v/out projections, each after a
learnable shift, an f32 softmax, and fp, binarized or 4-bit score and
context products).  Submodules carry the flax names (``move_q``,
``q_proj``, ..., ``score_matmul``, ``context_matmul``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.binary_linear import binary_matmul
from ..ops.qat_matmul import init_clip_scale, q4_matmul
from .linear import BinaryLinear, DataInit


class Q4MatMul(DataInit, nn.Module):
    """``q4_matmul(x, y, x_clip, y_clip)``, contraction ``(…, M, K) × (…, N,
    K) → (…, M, N)``; the clips start at 1 until
    ``init_activation_scales`` sets them to ``2 E|·| / 11.269``."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.x_clip = nn.Parameter(torch.ones((), dtype=dtype, device=device))
        self.y_clip = nn.Parameter(torch.ones((), dtype=dtype, device=device))

    def init_from_input(self, x: torch.Tensor, y: torch.Tensor) -> None:
        self.x_clip.copy_(init_clip_scale(x))
        self.y_clip.copy_(init_clip_scale(y))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self._data_init(x, y)
        return q4_matmul(x, y, self.x_clip, self.y_clip)


class LearnableBias(nn.Module):
    """``x + bias``, a per-channel learnable shift (zeros at first)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype, device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias


class BMHA(nn.Module):
    """Binary multi-head attention over ``x (b, s, in_features)``;
    ``hidden`` divisible by ``num_heads``; at most one of
    ``binary_attention`` / ``q4_attention``."""

    def __init__(self, hidden: int, num_heads: int, in_features: Optional[int] = None,
                 binary_attention: bool = False, q4_attention: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if binary_attention and q4_attention:
            raise ValueError("choose at most one of binary_attention / q4_attention")
        device = resolve_device(device)
        self.hidden, self.num_heads = hidden, num_heads
        self.binary_attention, self.q4_attention = binary_attention, q4_attention
        k_in = in_features or hidden
        for name, k in (("q", k_in), ("k", k_in), ("v", k_in), ("out", hidden)):
            self.add_module(f"move_{name}", LearnableBias(k, device=device))
            self.add_module(f"{name}_proj", BinaryLinear(k, hidden, device=device,
                                                         generator=generator))
        if q4_attention:
            self.score_matmul = Q4MatMul(device=device)
            self.context_matmul = Q4MatMul(device=device)

    def _proj(self, name: str, y: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_proj")(getattr(self, f"move_{name}")(y))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        d = self.hidden // self.num_heads

        def heads(t):
            return t.reshape(b, s, self.num_heads, d).transpose(1, 2)

        q, k, v = (heads(self._proj(n, x)) for n in ("q", "k", "v"))
        if self.binary_attention:
            scores = binary_matmul(q, k.transpose(-1, -2))
        elif self.q4_attention:
            scores = self.score_matmul(q, k)
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
        scores = scores / math.sqrt(d)
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        if self.binary_attention:
            ctx = binary_matmul(probs, v)
        elif self.q4_attention:
            ctx = self.context_matmul(probs, v.transpose(-1, -2))
        else:
            ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self._proj("out", ctx.transpose(1, 2).reshape(b, s, self.hidden))
