"""``q4_matmul``: a 4-bit quantized batched matmul with learnable clip
scales and LSQ straight-through gradients, in PyTorch (the counterpart of
``bitorch_engine_tpu/ops/qat_matmul.py``).  Both operands are quantized to
[-8, 7] with their clip scales (clamped at 1e-5), multiplied as exact
integers, and rescaled by the product of the scales; the backward runs in
f32 on the dequantized operands."""

from __future__ import annotations

import math

import torch

from .quant import Q8_DIVISOR, _recip

_Q4_LOW, _Q4_HIGH = -8.0, 7.0


def init_clip_scale(x: torch.Tensor) -> torch.Tensor:
    """Data-dependent clip-scale init ``2 E|x| / 11.269`` (0-d f32)."""
    return 2.0 * (x.float().abs().sum() / x.numel()) / Q8_DIVISOR


def _quantize(x: torch.Tensor, clip: torch.Tensor):
    scale = torch.clamp_min(clip.float(), 1e-5)
    return torch.clamp(torch.round(x.float() / scale), _Q4_LOW, _Q4_HIGH), scale


def _lsq_terms(x, scale, grad):
    q = x.float() / scale
    small = (q < _Q4_LOW).float()
    large = (q > _Q4_HIGH).float()
    middle = 1.0 - small - large
    masked = grad * middle
    lsq = small * _Q4_LOW + large * _Q4_HIGH + middle * (torch.round(q) - q)
    return masked, (lsq * masked).sum() * _recip(math.sqrt(x.numel() * _Q4_HIGH))


class _Q4MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, x_clip, y_clip):
        q_x, sx = _quantize(x, x_clip)
        q_y, sy = _quantize(y, y_clip)
        # |codes| <= 8: every partial sum is an exact integer in f64
        acc = torch.matmul(q_x.double(), q_y.double().transpose(-1, -2)).float()
        ctx.save_for_backward(x, y, q_x, q_y, sx, sy, x_clip, y_clip)
        return (acc * (sx * sy)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, y, q_x, q_y, sx, sy, x_clip, y_clip = ctx.saved_tensors
        g32 = g.float()
        grad_x = torch.matmul(g32, q_y * sy)
        grad_y = torch.matmul(g32.transpose(-1, -2), q_x * sx)
        grad_x, grad_xc = _lsq_terms(x, sx, grad_x)
        grad_y, grad_yc = _lsq_terms(y, sy, grad_y)
        return (grad_x.to(x.dtype), grad_y.to(y.dtype),
                grad_xc.to(x_clip.dtype).reshape(x_clip.shape),
                grad_yc.to(y_clip.dtype).reshape(y_clip.shape))


def q4_matmul(x: torch.Tensor, y: torch.Tensor, x_clip: torch.Tensor,
              y_clip: torch.Tensor) -> torch.Tensor:
    """``quant4(x) @ quant4(y)ᵀ · (sx · sy)`` ≈ ``x @ yᵀ``: ``x (..., M, K)``,
    ``y (..., N, K)``, batched (ndim > 2), scalar clips."""
    if x.dim() < 3 or y.dim() < 3:
        raise ValueError(f"q4_matmul expects batched operands (ndim > 2), got {x.dim()}/{y.dim()}")
    return _Q4MatMul.apply(x, y, x_clip, y_clip)
