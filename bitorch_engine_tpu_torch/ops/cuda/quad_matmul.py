"""Kernel 5: the A8 dequant-matmul (per-token int8 activations × 1/2/4-bit
codes), the counterpart of the ``tpu_quad`` branch of
``bitorch_engine_tpu/ops/pallas/dequant_matmul.py`` (entry
``mpq_matmul_pallas``, ``:738-764``).

The function is the JAX package's: ``sx = max(max|x| / 127, 1e-12)`` per
row (as its jitted code computes it, a multiply by the f32 reciprocal of
127), ``qx = round(x / sx)``, the product of ``qx`` with the dequantized
weight in f32, ``× sx``, cast.  The kernel (``csrc/quad_matmul.cu``) takes
A8 tensors in the port's kernel form (:func:`.dequant_matmul.prepare_for_kernel`
with ``act_bits=8``: gptq row order, symmetric zeros), quantizes the rows
itself and dots integer codes exactly, on one of two bodies that
:func:`quad_route` picks from the shape: ``quad_mma_kernel`` (the int8
tensor cores) where :func:`chunk_words` tiles the group, else
``quad_matmul_kernel`` (CUDA-core ``dp4a``).

The wrapper launches the kernel for CUDA tensors and raises on what it does
not take; it runs the plain PyTorch version only for CPU tensors.
``mpq_matmul_a8.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...qtensor import MPQTensor
from .. import packing
from ..quant import dequantize_mpq
from . import _build
from .dequant_matmul import _DTYPE_CODE, _check_weight, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int


def _mid(qt: MPQTensor) -> int:
    """The zeros_mid kernel's code midpoint, 0 for affine zeros."""
    return 2 ** ((qt.code_bits or qt.w_bit) - 1) if qt.zeros_mid else 0


# f32(1 / 127): under jit (the JAX package's serving path and bench) XLA
# folds its ``amax / 127.0`` into a multiply by this reciprocal
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_activations_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain per-token quantization: ``(qx, sx)`` with ``qx`` f32 integers
    in [-127, 127] and ``sx = max(max|x| * f32(1/127), 1e-12)`` f32 ``(m, 1)``,
    the JAX package's jitted ``max(max|x| / 127.0, 1e-12)``; ``qx`` rounds
    half to even after a true division by ``sx``."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) * _INV_127, 1e-12)
    return torch.round(xf / sx), sx


def kernel_order(qx: torch.Tensor, w_bit: int) -> torch.Tensor:
    """Codes ``(m, K)`` in the kernel's dot order (see ``csrc/quad_matmul.cu``):
    within each packed row's ``32 / w_bit`` codes, code ``b * S + t`` moves
    to ``4 t + b`` (``S = 8 / w_bit``)."""
    m, k = qx.shape
    s = 8 // w_bit
    return qx.reshape(m, k // (4 * s), 4, s).transpose(2, 3).reshape(m, k)


def chunk_words(w_bit: int, group_size: int) -> Optional[int]:
    """Packed rows a chunk of the tensor-core body: the largest of 4, 2, 1
    that divides a group's packed rows and holds a whole k32 slab (at least
    ``w_bit`` rows), or None (groups of 16 codes at w2 / w4)."""
    rows = group_size // (32 // w_bit)
    for c in (4, 2, 1):
        if c >= w_bit and rows % c == 0:
            return c
    return None


MMA_WARPS = 8  # warps a block of the tensor-core body, one K run each


def mma_row_tiles(m: int) -> int:
    """The tensor-core body's n8 row tiles a block for ``m`` rows
    (``launch_mma`` in the source): one to m 8, two to m 16, else four."""
    return 1 if m <= 8 else (2 if m <= 16 else 4)


def quad_route(w_bit: int, group_size: int) -> str:
    """Kernel 5's body on the card: ``"mma"`` (``quad_mma_kernel``) where
    :func:`chunk_words` tiles the group (every group of 32 codes and up;
    ``chip_smoke.py`` phase 8a measured it faster than the first body at
    every m of the A8 regime, 1-512), else ``"dp4a"``
    (``quad_matmul_kernel``: groups of 16 codes at w2 and w4)."""
    return "mma" if chunk_words(w_bit, group_size) is not None else "dp4a"


def mpq_matmul_a8_ref(
    x: torch.Tensor, qt: MPQTensor, out_dtype: Optional[torch.dtype] = None,
    accumulator: bool = False,
) -> torch.Tensor:
    """Plain version of kernel 5: the JAX package's simulation of its A8
    kernel (``ops/mpq_linear.py:87-111``), an f32 product of the integer
    activations and the f32 dequantized weight, ``× sx``, cast to
    ``out_dtype`` (default ``x.dtype``); ``accumulator=True`` returns the f32
    product before ``sx`` and the cast."""
    qx, sx = quantize_activations_ref(x)
    acc = qx @ dequantize_mpq(qt, torch.float32)
    if accumulator:
        return acc
    return (acc * sx).to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _quad_fn():
    return _build.function(
        "quad_matmul", "bte_quad_matmul",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    )


@functools.lru_cache(maxsize=None)
def _mma_fn():
    return _build.function(
        "quad_matmul", "bte_quad_mma",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    )


@functools.lru_cache(maxsize=None)
def _quantize_fn():
    return _build.function("quad_matmul", "bte_quad_quantize", [_P, _P, _P, _I, _I, _I, _I, _P])


def _check_x(x: torch.Tensor, k: int, w_bit: int) -> None:
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (m, {k}), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("x must be float32 or bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if k % (32 // w_bit):
        raise ValueError(f"K={k} must be a multiple of {32 // w_bit}")


def quantize_activations(x: torch.Tensor, w_bit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5's quantization launch alone, on the card: ``(qx int8 (m, K)
    in the kernel's dot order for ``w_bit``, sx f32 (m,))``; equal to
    ``kernel_order(quantize_activations_ref(x))``.  Not counted."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_activations: unsupported device {x.device}")
    if w_bit not in packing.QUAD_BITS:
        raise ValueError(f"w_bit={w_bit} not in {packing.QUAD_BITS}")
    _check_x(x, x.shape[-1], w_bit)
    m, k = x.shape
    qx = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    err = _quantize_fn()(x.data_ptr(), qx.data_ptr(), sx.data_ptr(), m, k, w_bit,
                         _DTYPE_CODE[x.dtype], _stream(x.device))
    _build.check("quad_matmul", err, "quantize_activations launch")
    return qx, sx


def mpq_matmul_a8(
    x: torch.Tensor, qt: MPQTensor, out_dtype: Optional[torch.dtype] = None,
    accumulator: bool = False,
) -> torch.Tensor:
    """Kernel 5: ``x (m, K)`` quantized per row to int8, against the A8
    tensor ``qt`` (K, N) → ``(m, N)`` in ``out_dtype`` (default ``x.dtype``).

    ``accumulator=True`` returns the f32 accumulator before ``sx`` and the
    cast (the on-card gate compares it with :func:`mpq_matmul_a8_ref`'s).
    On the card the body is the one :func:`quad_route` names; neither falls
    back to the other."""
    if accumulator:
        out_dtype = torch.float32
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return mpq_matmul_a8_ref(x, qt, out_dtype, accumulator)
    if x.device.type != "cuda":
        raise ValueError(f"mpq_matmul_a8: unsupported device {x.device}")
    _check_weight(qt, x.device, act_bits=(8,))
    if qt.w_bit not in packing.QUAD_BITS:
        raise ValueError(f"the A8 kernel takes w_bit in {packing.QUAD_BITS}, got {qt.w_bit}")
    k, n = qt.logical_shape
    _check_x(x, k, qt.w_bit)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError("the output must be float32 or bfloat16")
    m = x.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    qx = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    head = (x.data_ptr(), qx.data_ptr(), sx.data_ptr(), qt.packed.data_ptr(),
            qt.scales.data_ptr(), qt.zeros.data_ptr(), out.data_ptr(), m, k, n, qt.w_bit,
            qt.group_size)
    tail = (_mid(qt), int(not accumulator), _DTYPE_CODE[x.dtype], _DTYPE_CODE[qt.scales.dtype],
            _DTYPE_CODE[out_dtype], _stream(x.device))
    if quad_route(qt.w_bit, qt.group_size) == "mma":
        err = _mma_fn()(*head, chunk_words(qt.w_bit, qt.group_size), *tail)
    else:
        err = _quad_fn()(*head, *tail)
    _build.check("quad_matmul", err, "mpq_matmul_a8 launch")
    mpq_matmul_a8.launches += 1
    return out


mpq_matmul_a8.launches = 0
