"""The flax layers the QAT models use, with flax's parameter names and
layouts, so that the JAX package's parameter trees load one to one:
``Dense`` (``kernel`` (in, out), ``bias``), ``Conv`` (``kernel`` HWIO on
NHWC activations) and ``LayerNorm`` (``scale``, ``bias``, epsilon 1e-6 and
flax's variance ``E[x²] − E[x]²``).  Random weights come from an explicit
``torch.Generator``: flax's default ``lecun_normal`` (a truncated normal)
for the kernels, zeros for the biases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops.conv import conv2d_nhwc

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape: Tuple[int, ...], fan_in: int, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated to ±2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel ``(in, out)``; with
    ``dtype`` (flax's computation dtype) the input, kernel and bias are cast
    to it first, the parameters stay f32."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal((in_features, features), in_features, generator,
                                                device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.kernel, self.bias
        if self.dtype is not None:
            x, kernel = x.to(self.dtype), kernel.to(self.dtype)
            bias = None if bias is None else bias.to(self.dtype)
        y = x @ kernel
        return y if bias is None else y + bias


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC activations, kernel ``(KH, KW, C, O)``."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding: str = "SAME", use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kh, kw = kernel_size
        self.strides, self.padding = tuple(strides), padding
        self.kernel = nn.Parameter(lecun_normal((kh, kw, in_channels, features),
                                                kh * kw * in_channels, generator, device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(x, self.kernel, self.strides, self.padding).to(x.dtype)
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``(x − μ) · (rsqrt(σ² + ε) ·
    scale) + bias`` with ``σ² = max(E[x²] − μ², 0)`` in f32."""

    def __init__(self, features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)
