"""Binary (1-bit) linear with its straight-through backward, in PyTorch.

The counterpart of ``bitorch_engine_tpu/ops/binary_linear.py``:
``out = (sign(x + bias_a) ⊛ sign(W)ᵀ) · scale_a · scale_w`` (sign(0) = +1).

Forward, by the weight's form:

* QAT (int8 ``(N, K)``): an f32 product of the ±1 matrices (exact
  integers);
* packed (int32 sign words): on the card, where ``xnor_route`` says
  ``"kernel"``, kernel 8's fused entry (``binary_packed_linear``: the sign
  of ``x + bias_a``, the ±1 dot on the tensor cores' 1-bit products and
  the scales in one launch), else the JAX package's TPU branch (the signs unpacked to
  bf16 and one ``torch.mm`` with f32 output); on the CPU the fused entry's
  plain version, ``xnor_popcount_mm`` as the JAX package's CPU branch.
  All give the same integers and the same scaled outputs.

Backward (``_binary_linear_bwd`` of the JAX package): ``grad_input = g @
sign(W) · scale_w``, masked to ``|x / scale_a| <= 1``; ``grad_scale_a =
Σ grad_input · sign(x) / sqrt(numel)``; the weight gradient ``gᵀ @ sign(x)
· scale_a``, requantized by ``nv_tensor_quant`` (integer values in f32),
into the grad shadow; ``grad_bias_a = Σ_rows grad_input``.  The division
by the constant ``sqrt(numel)`` is a multiplication by its f32 reciprocal,
as XLA folds it under the JAX package's jitted train step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..qtensor import BinaryQTensor
from . import packing
from .cuda.binary_gemm import DTYPES, binary_packed_linear, fits
from .mpq_linear import needs_grad
from .quant import _recip, nv_tensor_quant


def xnor_route(m: int, k: int, n: int, dtypes=(torch.float32,)) -> str:
    """The packed forward's branch on the card at ``m`` rows of ``k``
    features and ``n`` outputs, with x, bias_a and the scales of
    ``dtypes``: ``"kernel"`` (kernel 8's fused entry) wherever its shared
    memory holds the rows' sign words and it reads every dtype (f32, bf16,
    f16), else ``"unpack"`` (the signs unpacked to bf16 and ``torch.mm``).  No row
    limit: the fused kernel was faster than the unpack branch at every m
    chip_smoke.py phase 14 measures (1024^2 and 4096^2, m 1-2048) on
    "NVIDIA H100 80GB HBM3, 700.00 W", where the JAX package's TPU branch
    switches above 16 rows."""
    return "kernel" if fits(m, -(-k // 32)) and set(dtypes) <= DTYPES.keys() else "unpack"


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """±1 in f32 with sign(0) = +1 (the packers' ``>= 0`` convention)."""
    return torch.where(x >= 0, 1.0, -1.0).float()


def _sign_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 ±1 operands with f32 output (exact integers)."""
    return torch.mm(a, b, out_dtype=torch.float32)


def _forward(x, qt: BinaryQTensor, scale_a, bias_a, save_xs: bool = False):
    """The forward's output, and ``(x + bias_a).float()`` where the
    backward saves it (``save_xs``) or the unpack branch computes it."""
    k = x.shape[-1]
    dtypes = (x.dtype, bias_a.dtype, scale_a.dtype, qt.scale_w.dtype)
    if qt.packed and (x.device.type == "cpu"
                      or xnor_route(x.numel() // max(1, k), k, qt.data.shape[0], dtypes) == "kernel"):
        out = binary_packed_linear(x.contiguous(), qt.data, scale_a, bias_a, qt.scale_w, k)
        return out, ((x + bias_a).float() if save_xs else None)
    xs = (x + bias_a).float()
    x2d = xs.reshape(-1, k)
    if qt.packed:
        w_sign = packing.unpack_signs(qt.data, torch.bfloat16)[:, :k]
        y = _sign_mm_f32(sign_pm1(x2d).to(torch.bfloat16), w_sign.T)
    else:
        y = sign_pm1(x2d) @ sign_pm1(qt.data).T
    y = y.reshape(*xs.shape[:-1], -1)
    return (y * scale_a * qt.scale_w).to(x.dtype), xs


class _BinaryLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shadow, scale_a, bias_a, qt):
        out, xs = _forward(x, qt, scale_a, bias_a, save_xs=True)
        ctx.save_for_backward(xs, scale_a)
        ctx.qt = qt
        ctx.x_dtype = x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        xs, scale_a = ctx.saved_tensors
        qt = ctx.qt
        k = xs.shape[-1]
        g2d = g.float().reshape(-1, g.shape[-1])
        if qt.packed:
            w_sign = packing.unpack_signs(qt.data)[:, :k]
        else:
            w_sign = sign_pm1(qt.data)
        x2d = xs.reshape(-1, k)
        grad_input = g2d @ (w_sign * qt.scale_w)
        q_w = x2d / scale_a
        grad_input = grad_input * ((q_w >= -1.0) & (q_w <= 1.0)).float()
        x_sign = sign_pm1(x2d)
        inv_sqrt = _recip(float(np.sqrt(np.float32(x2d.numel()))))
        grad_scale_a = (grad_input * x_sign).sum() * inv_sqrt
        gw = None
        if ctx.needs_input_grad[1]:
            gw = nv_tensor_quant(g2d.T @ (x_sign * scale_a))[0]
        grad_bias_a = grad_input.sum(dim=0)
        return (grad_input.reshape(xs.shape).to(ctx.x_dtype), gw,
                grad_scale_a.to(scale_a.dtype), grad_bias_a.to(xs.dtype), None)


def binary_linear(x: torch.Tensor, qt: BinaryQTensor, scale_a: torch.Tensor,
                  bias_a: torch.Tensor) -> torch.Tensor:
    """``(x + bias_a) ⊛ sign(W)ᵀ · scale_a · scale_w``: ``x`` fp ``(..., K)``,
    ``qt.data`` int8 ``(N, K)`` or packed int32 ``(N, ceil(K / 32))`` →
    ``(..., N)`` in ``x.dtype``; differentiable in ``x``, ``scale_a``,
    ``bias_a`` and ``qt.grad_shadow``."""
    if needs_grad(x, qt.grad_shadow) or (
            torch.is_grad_enabled() and (scale_a.requires_grad or bias_a.requires_grad)):
        return _BinaryLinear.apply(x, qt.grad_shadow, scale_a, bias_a, qt)
    return _forward(x, qt, scale_a, bias_a)[0]


class _BinaryMatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return torch.matmul(sign_pm1(x), sign_pm1(y)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g32 = g.float()
        gx = torch.matmul(g32, sign_pm1(y).transpose(-1, -2)) * (x.abs() <= 1.0)
        gy = torch.matmul(sign_pm1(x).transpose(-1, -2), g32) * (y.abs() <= 1.0)
        return gx.to(x.dtype), gy.to(y.dtype)


def binary_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched ``sign(x) @ sign(y)`` with straight-through gradients masked
    to ``|·| <= 1`` (the JAX package's ``binary_matmul``, BMHA's binarized
    score and context products)."""
    return _BinaryMatMul.apply(x, y)
