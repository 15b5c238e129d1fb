"""Q4 / Q8 QAT linear (integer activations × integer weights) with the LSQ
straight-through backward, in PyTorch.

The counterpart of ``bitorch_engine_tpu/ops/qat_linear.py``.  Forward:
the activations are quantized with the learnable ``scale_a`` (clamped at
1e-5) to 4 bits for a 4-bit weight and 8 bits otherwise, multiplied with
the int8 codes as an exact int32 product (:func:`int_matmul`), and
rescaled by ``scale_a · scale_w``.  Backward: ``grad_input = (g @ W)`` with
``W = codes · scale_w``, masked to the activations the forward did not
clip; the LSQ gradient of ``scale_a``; the weight gradient ``gᵀ @ (q_a ·
scale_a)`` in f32 into the grad shadow.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..qtensor import IntQTensor
from .mpq_linear import needs_grad
from .quant import _recip


def qrange(w_bit: int) -> Tuple[float, float]:
    """Signed code range ``[-2^(b-1), 2^(b-1) - 1]``."""
    return (-(2.0 ** (w_bit - 1)), 2.0 ** (w_bit - 1) - 1.0)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def int_matmul(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``q_a (M, K) @ q_wᵀ`` for int8 ``q_w (N, K)``, the JAX
    package's int8 ``dot_general`` (XLA's, not a Pallas kernel).

    On the card ``torch._int_mm`` (cuBLASLt), which wants more than 16 rows
    and K, N multiples of 8: the operands are zero-padded to that and the
    result sliced.  On the CPU an f64 product, exact (every partial sum is
    an integer below 2^53; f32 would not be past K ≈ 1040 at 8 bits)."""
    m, k = q_a.shape
    n = q_w.shape[0]
    if q_a.device.type != "cuda":
        return (q_a.double() @ q_w.double().T).to(torch.int32)
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    a = F.pad(q_a, (0, kp - k, 0, mp - m))
    b = F.pad(q_w, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a, b.t())[:m, :n]


def _forward(x, qt: IntQTensor, scale_a):
    qlow, qhigh = qrange(8 if qt.w_bit == 8 else qt.w_bit)
    k = x.shape[-1]
    x2d = x.reshape(-1, k).float()
    scale = torch.clamp_min(scale_a.float(), 1e-5)
    q_a = torch.clamp(torch.round(x2d / scale), qlow, qhigh)
    acc = int_matmul(q_a.to(torch.int8), qt.data)
    out = acc.float() * scale * qt.scale_w.float()
    return out.reshape(*x.shape[:-1], -1).to(x.dtype), q_a


class _QATLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shadow, scale_a, qt):
        out, q_a = _forward(x, qt, scale_a)
        ctx.save_for_backward(x, q_a, scale_a)
        ctx.qt = qt
        return out

    @staticmethod
    def backward(ctx, g):
        x, q_a, scale_a = ctx.saved_tensors
        qt = ctx.qt
        qlow, qhigh = qrange(8 if qt.w_bit == 8 else qt.w_bit)
        k = x.shape[-1]
        g2d = g.reshape(-1, g.shape[-1]).float()
        x2d = x.reshape(-1, k).float()
        scale = torch.clamp_min(scale_a.float(), 1e-5)
        grad_input = g2d @ (qt.data.float() * qt.scale_w.float())
        q_x = x2d / scale
        small = (q_x < qlow).float()
        large = (q_x > qhigh).float()
        middle = 1.0 - small - large
        grad_input = grad_input * middle
        lsq = small * qlow + large * qhigh + middle * (torch.round(q_x) - q_x)
        grad_scale_a = (lsq * grad_input).sum() * _recip(math.sqrt(x2d.numel() * qhigh))
        gw = g2d.T @ (q_a * scale) if ctx.needs_input_grad[1] else None
        return grad_input.reshape(x.shape).to(x.dtype), gw, grad_scale_a.to(scale_a.dtype), None


def qat_linear(x: torch.Tensor, qt: IntQTensor, scale_a: torch.Tensor) -> torch.Tensor:
    """n-bit QAT linear: ``x`` fp ``(..., K)``, ``qt.data`` int8 ``(N, K)`` →
    ``(..., N)`` in ``x.dtype``; differentiable in ``x``, ``scale_a`` and
    ``qt.grad_shadow``."""
    if needs_grad(x, qt.grad_shadow) or (torch.is_grad_enabled() and scale_a.requires_grad):
        return _QATLinear.apply(x, qt.grad_shadow, scale_a, qt)
    return _forward(x, qt, scale_a)[0]
