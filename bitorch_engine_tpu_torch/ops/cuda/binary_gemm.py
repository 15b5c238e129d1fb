"""Kernel 8: the XNOR-popcount GEMM of the packed 1-bit linear, the
counterpart of ``bitorch_engine_tpu/ops/pallas/binary_gemm.py``
(``_kernel``, entry ``xnor_gemm_pallas``).

``xnor_gemm(x_words, w_words, k_logical)`` takes sign-packed int32 words
(``ops/packing.pack_signs``, both operands padded with -1 so their pad bits
are 0), x ``(M, Kw)`` and w ``(N, Kw)``, and returns the f32 ±1 dot over
the first ``k_logical`` features, ``k_logical - 2 Σ popc(x ⊕ w)``: the JAX
kernel's ``32 Kw - 2 popc`` less its wrapper's pad correction.  The values
are exact integers.

The wrapper launches ``csrc/binary_gemm.cu`` for CUDA tensors and raises on
what it does not take; it runs the plain PyTorch version only for CPU
tensors.  ``xnor_gemm.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import packing
from . import _build
from .dequant_matmul import _stream

_P = ctypes.c_void_p
_I = ctypes.c_int

# (M, N, Kw) int64 elements of the plain version's popcount at a time
_REF_CHUNK = 1 << 24


def xnor_popcount_mm(x_packed: torch.Tensor, w_packed: torch.Tensor, k: int) -> torch.Tensor:
    """±1-domain GEMM over sign words, ``k - 2 popc(x ⊕ w)`` summed over the
    words, in f32 ``(M, N)``: ``sign(x) @ sign(w)ᵀ`` over ``k = 32 Kw``
    features (the JAX package's ``xnor_popcount_mm``)."""
    m, kw = x_packed.shape
    n = w_packed.shape[0]
    step = max(1, _REF_CHUNK // max(1, m * kw))
    pop = torch.cat([
        packing.popcount(x_packed[:, None, :] ^ w_packed[None, i:i + step, :]).sum(dim=-1)
        for i in range(0, n, step)
    ], dim=1) if n else torch.zeros((m, 0), dtype=torch.int64, device=x_packed.device)
    return (k - 2 * pop).to(torch.float32)


def xnor_gemm_ref(x_words: torch.Tensor, w_words: torch.Tensor, k_logical: int) -> torch.Tensor:
    """Plain version of kernel 8: the JAX kernel's arithmetic over all
    ``32 Kw`` bits, then its wrapper's subtraction of the pad bits."""
    kw = x_words.shape[1]
    return xnor_popcount_mm(x_words, w_words, kw * 32) - (kw * 32 - k_logical)


@functools.lru_cache(maxsize=None)
def _xnor_fn():
    return _build.function("binary_gemm", "bte_xnor_gemm", [_P, _P, _P, _I, _I, _I, _I, _I, _P])


@functools.lru_cache(maxsize=None)
def _rows_fn():
    return _build.function("binary_gemm", "bte_xnor_gemm_rows_per_block", [_I, _I])


def _check(x_words: torch.Tensor, w_words: torch.Tensor, k_logical: int) -> None:
    for name, t in (("x_words", x_words), ("w_words", w_words)):
        if t.dim() != 2 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x_words.device:
            raise ValueError("x_words and w_words must be on one device")
    kw = x_words.shape[1]
    if w_words.shape[1] != kw:
        raise ValueError(f"word counts differ: x {kw}, w {w_words.shape[1]}")
    if not 32 * (kw - 1) < k_logical <= 32 * kw:
        raise ValueError(f"k_logical={k_logical} does not fit {kw} words")


def xnor_gemm(x_words: torch.Tensor, w_words: torch.Tensor, k_logical: int) -> torch.Tensor:
    """Kernel 8: ``(M, Kw) × (N, Kw)`` sign words → f32 ``(M, N)`` ±1 dots
    over ``k_logical`` features."""
    _check(x_words, w_words, k_logical)
    if x_words.device.type == "cpu":
        return xnor_gemm_ref(x_words, w_words, k_logical)
    if x_words.device.type != "cuda":
        raise ValueError(f"xnor_gemm: unsupported device {x_words.device}")
    m, kw = x_words.shape
    n = w_words.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x_words.device)
    if m == 0 or n == 0:
        return out
    if _rows_fn()(m, kw) == 0:
        raise ValueError(f"xnor_gemm: K = {32 * kw} does not fit the kernel's shared memory")
    vec = kw % 4 == 0 and x_words.data_ptr() % 16 == 0 and w_words.data_ptr() % 16 == 0
    err = _xnor_fn()(x_words.data_ptr(), w_words.data_ptr(), out.data_ptr(), m, n, kw, k_logical,
                     int(vec), _stream(x_words.device))
    _build.check("binary_gemm", err, "xnor_gemm launch")
    xnor_gemm.launches += 1
    return out


xnor_gemm.launches = 0
