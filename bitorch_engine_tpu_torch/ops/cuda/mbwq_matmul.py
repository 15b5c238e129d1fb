"""Kernel 7: the fused mixed-bit (MBWQ) matmul, one launch over all segments.

The counterpart of ``bitorch_engine_tpu/ops/pallas/mbwq_matmul.py``
(``mbwq_matmul_pallas``).  ``x`` arrives channel-scaled and gathered into
segment order (``ops.mbwq_linear.gather_activations``); the kernel
(``csrc/dequant_matmul.cu``, ``mbwq_matmul_kernel``) walks every segment's
quant groups with one f32 accumulator per output and casts once.  It takes
1-8 A16 segments in the kernel form of ``prepare_for_kernel``, sharing N and
one metadata dtype.

The wrapper launches the kernel for CUDA tensors and raises on what it does
not take; it runs the plain PyTorch version only for CPU tensors.
``mbwq_matmul.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...qtensor import MBWQTensor
from ..quant import dequantize_mpq
from . import _build
from .dequant_matmul import _DTYPE_CODE, _check_weight, _stream

MAX_SEGMENTS = 8
_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)


def mbwq_matmul_ref(
    x: torch.Tensor, qt: MBWQTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Plain version of kernel 7: the f32 sum of the segments' f32 products
    ``x[:, segment's columns] @ dequantize_mpq(segment)``, cast once."""
    acc = None
    off = 0
    for seg in qt.segments:
        k = seg.in_features
        part = x[:, off : off + k].float() @ dequantize_mpq(seg, torch.float32)
        acc = part if acc is None else acc + part
        off += k
    return acc.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _mbwq_fn():
    return _build.function(
        "dequant_matmul", "bte_mbwq_matmul",
        [_P, _I, _PP, _PP, _PP, _PI, _PI, _PI, _P, _I, _I, _I, _I, _I, _I, _P],
    )


def mbwq_matmul(
    x: torch.Tensor, qt: MBWQTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Kernel 7: ``x (m, K)`` in segment order @ the stacked segments
    ``(K, N)`` → ``(m, N)`` in ``out_dtype`` (default ``x.dtype``;
    ``torch.float32`` returns the accumulator before any cast)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return mbwq_matmul_ref(x, qt, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mbwq_matmul: unsupported device {x.device}")
    segs = qt.segments
    if not 1 <= len(segs) <= MAX_SEGMENTS:
        raise ValueError(f"kernel 7 takes 1-{MAX_SEGMENTS} segments, got {len(segs)}")
    n = segs[0].out_features
    for seg in segs:
        _check_weight(seg, x.device)
        if seg.out_features != n or seg.scales.dtype != segs[0].scales.dtype:
            raise ValueError("the segments must share N and one metadata dtype")
    k = sum(seg.in_features for seg in segs)
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (m, {k}), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError("x and the output must be float32 or bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    m = x.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    ns = len(segs)

    def ptrs(name):
        return (ctypes.c_void_p * ns)(*(getattr(s, name).data_ptr() for s in segs))

    def ints(vals):
        return (ctypes.c_int * ns)(*vals)

    err = _mbwq_fn()(
        x.data_ptr(), ns, ptrs("packed"), ptrs("scales"), ptrs("zeros"),
        ints(s.w_bit for s in segs), ints(s.group_size for s in segs),
        ints(s.in_features for s in segs), out.data_ptr(), m, k, n,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[segs[0].scales.dtype], _DTYPE_CODE[out_dtype],
        _stream(x.device),
    )
    _build.check("dequant_matmul", err, "mbwq_matmul launch")
    mbwq_matmul.launches += 1
    return out


mbwq_matmul.launches = 0
