"""Quantized 2-D convolutions (binary, and int4 / int8 QAT) with
straight-through backwards, in PyTorch.

The counterpart of ``bitorch_engine_tpu/ops/conv.py``: NHWC activations and
HWIO weights at the interface.  As in the JAX package the convolution
itself is the framework's (``F.conv2d`` here, ``lax.conv_general_dilated``
there) on ±1 or integer values, exact in f32; no TPU kernel stands behind
it.  The input gradient is the JAX package's ``lax.conv_transpose(g, W,
strides, padding, transpose_kernel=True)`` (its padding rule and all), the
weight gradient the VJP of the f32 convolution.

``"SAME"`` pads as flax does, the smaller half first (asymmetric at stride
> 1); ``"VALID"`` does not pad.  cuDNN would run an f32 convolution in TF32
by default on the card; every convolution here runs with TF32 off,
whatever the caller's flag.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..qtensor import BinaryQTensor, IntQTensor
from .binary_linear import sign_pm1
from .quant import _recip

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


@contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _pads(in_hw, k_hw, strides, padding: str) -> Pads:
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    out = []
    for size, k, s in zip(in_hw, k_hw, strides):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int] = (1, 1),
                padding: str = "SAME") -> torch.Tensor:
    """``x (N, H, W, C)`` ⊛ ``w (KH, KW, C, O)`` → ``(N, H', W', O)``, f32."""
    (ph, pw) = _pads(x.shape[1:3], w.shape[:2], strides, padding)
    xn = F.pad(x.float().permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    with _no_tf32():
        y = F.conv2d(xn, w.float().permute(3, 2, 0, 1), stride=tuple(strides))
    return y.permute(0, 2, 3, 1)


def _transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax._conv_transpose_padding`` for a string padding."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return pad_a, pad_len - pad_a


def conv_transpose_nhwc(g: torch.Tensor, w: torch.Tensor, strides: Sequence[int] = (1, 1),
                        padding: str = "SAME") -> torch.Tensor:
    """``lax.conv_transpose(g, w, strides, padding, dimension_numbers=(NHWC,
    HWIO, NHWC), transpose_kernel=True)``: ``g (N, H', W', O)`` against the
    flipped, I/O-swapped ``w (KH, KW, C, O)`` with ``g`` dilated by the
    strides → ``(N, H, W, C)``, f32."""
    sh, sw = strides
    kh, kw = w.shape[:2]
    gn = g.float().permute(0, 3, 1, 2)
    if sh > 1 or sw > 1:
        n, o, h, wd = gn.shape
        dil = gn.new_zeros((n, o, (h - 1) * sh + 1, (wd - 1) * sw + 1))
        dil[:, :, ::sh, ::sw] = gn
        gn = dil
    (pha, phb), (pwa, pwb) = _transpose_pads(kh, sh, padding), _transpose_pads(kw, sw, padding)
    gn = F.pad(gn, (pwa, pwb, pha, phb))
    w_t = w.float().flip(0, 1).permute(2, 3, 0, 1)  # (C, O, KH, KW): O in, C out
    with _no_tf32():
        y = F.conv2d(gn, w_t)
    return y.permute(0, 2, 3, 1)


def conv_weight_grad(x: torch.Tensor, g: torch.Tensor, w_shape, strides, padding) -> torch.Tensor:
    """dL/dW of :func:`conv2d_nhwc` at ``x`` for the output cotangent ``g``
    (the JAX package's VJP of its f32 convolution)."""
    w0 = torch.zeros(w_shape, dtype=torch.float32, device=x.device, requires_grad=True)
    with torch.enable_grad():
        (gw,) = torch.autograd.grad(conv2d_nhwc(x, w0, strides, padding), w0, g)
    return gw


def _inv_sqrt_numel(x: torch.Tensor) -> float:
    return _recip(float(np.sqrt(np.float32(x.numel()))))


class _BinaryConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shadow, scale_a, qt, strides, padding):
        ctx.save_for_backward(x, scale_a)
        ctx.qt, ctx.strides, ctx.padding = qt, strides, padding
        y = conv2d_nhwc(sign_pm1(x), sign_pm1(qt.data), strides, padding)
        return (y * scale_a * qt.scale_w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale_a = ctx.saved_tensors
        qt, strides, padding = ctx.qt, ctx.strides, ctx.padding
        g32 = g.float()
        grad_x = conv_transpose_nhwc(g32 * qt.scale_w, sign_pm1(qt.data), strides, padding)
        grad_x = grad_x * ((x / scale_a).abs() <= 1.0).float()
        grad_scale_a = (grad_x * sign_pm1(x)).sum() * _inv_sqrt_numel(x)
        gw = None
        if ctx.needs_input_grad[1]:
            gw = conv_weight_grad(sign_pm1(x) * scale_a, g32, qt.data.shape, strides, padding)
        return grad_x.to(x.dtype), gw, grad_scale_a.to(scale_a.dtype), None, None, None


def binary_conv2d(x: torch.Tensor, qt: BinaryQTensor, scale_a: torch.Tensor,
                  strides: Sequence[int] = (1, 1), padding: str = "SAME") -> torch.Tensor:
    """``conv(sign(x), sign(W)) · scale_a · scale_w``: ``x (N, H, W, C)``,
    ``qt.data`` int8 ``(KH, KW, C, O)``; differentiable in ``x``,
    ``scale_a`` and ``qt.grad_shadow`` (the conv weight's full shape)."""
    return _BinaryConv.apply(x, qt.grad_shadow, scale_a, qt, tuple(strides), padding)


class _QATConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shadow, scale_a, qt, strides, padding):
        qlow, qhigh = -(2.0 ** (qt.w_bit - 1)), 2.0 ** (qt.w_bit - 1) - 1.0
        scale = torch.clamp_min(scale_a.float(), 1e-5)
        q_a = torch.clamp(torch.round(x.float() / scale), qlow, qhigh)
        ctx.save_for_backward(x, q_a, scale_a)
        ctx.qt, ctx.strides, ctx.padding = qt, strides, padding
        y = conv2d_nhwc(q_a, qt.data.float(), strides, padding)
        return (y * scale * qt.scale_w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, q_a, scale_a = ctx.saved_tensors
        qt, strides, padding = ctx.qt, ctx.strides, ctx.padding
        qlow, qhigh = -(2.0 ** (qt.w_bit - 1)), 2.0 ** (qt.w_bit - 1) - 1.0
        g32 = g.float()
        scale = torch.clamp_min(scale_a.float(), 1e-5)
        grad_x = conv_transpose_nhwc(g32, qt.data.float() * qt.scale_w, strides, padding)
        q_x = x.float() / scale
        small = (q_x < qlow).float()
        large = (q_x > qhigh).float()
        middle = 1.0 - small - large
        grad_x = grad_x * middle
        lsq = small * qlow + large * qhigh + middle * (torch.round(q_x) - q_x)
        grad_scale_a = (lsq * grad_x).sum() * _recip(math.sqrt(x.numel() * qhigh))
        gw = None
        if ctx.needs_input_grad[1]:
            gw = conv_weight_grad(q_a * scale, g32, qt.data.shape, strides, padding)
        return grad_x.to(x.dtype), gw, grad_scale_a.to(scale_a.dtype), None, None, None


def qat_conv2d(x: torch.Tensor, qt: IntQTensor, scale_a: torch.Tensor,
               strides: Sequence[int] = (1, 1), padding: str = "SAME") -> torch.Tensor:
    """n-bit QAT conv: activations quantized to ``qt.w_bit`` bits with
    ``scale_a``, an integer-valued conv with the int8 codes, rescaled by
    ``scale_a · scale_w``; differentiable in ``x``, ``scale_a`` and
    ``qt.grad_shadow``."""
    return _QATConv.apply(x, qt.grad_shadow, scale_a, qt, tuple(strides), padding)
