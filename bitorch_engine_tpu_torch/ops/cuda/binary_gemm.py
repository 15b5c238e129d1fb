"""Kernel 8: the XNOR-popcount GEMM of the packed 1-bit linear, the
counterpart of ``bitorch_engine_tpu/ops/pallas/binary_gemm.py``
(``_kernel``, entry ``xnor_gemm_pallas``), on the tensor cores' 1-bit
products.

Two entries share the kernel (``csrc/binary_gemm.cu``):

* ``xnor_gemm(x_words, w_words, k_logical)`` takes sign-packed int32 words
  (``ops/packing.pack_signs``, both operands padded with -1 so their pad
  bits are 0), x ``(M, Kw)`` and w ``(N, Kw)``, and returns the f32 ±1 dot
  over the first ``k_logical`` features, ``k_logical - 2 Σ popc(x ⊕ w)``:
  the JAX kernel's ``32 Kw - 2 popc`` less its wrapper's pad correction.
  The values are exact integers.
* ``binary_packed_linear(x, w_words, scale_a, bias_a, scale_w, k_logical)``
  is the packed binary linear's forward (``ops/binary_linear._forward``):
  the sign of ``x + bias_a`` is taken in the kernel, and the output is
  ``(dot * scale_a * scale_w).to(x.dtype)``, in one launch.

Each wrapper launches the kernel for CUDA tensors and raises on what it does
not take; it runs its plain PyTorch version only for CPU tensors.  Each
counts its launches (``.launches``).  ``xnor_plan`` is the launch shape the
wrapper picks, ``fits`` whether the kernel's shared memory holds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import packing
from . import _build
from .dequant_matmul import _stream

_P = ctypes.c_void_p
_I = ctypes.c_int

# (M, N, Kw) int64 elements of the plain version's popcount at a time
_REF_CHUNK = 1 << 24

WARPS = 8  # warps a block
DEPTH = 4  # ring stages a warp
MAX_SHARED = 227 * 1024
# the fused entry's dtypes (x, bias_a, the scales) and the kernel's codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def binary_packed_linear_ref(x: torch.Tensor, w_words: torch.Tensor, scale_a: torch.Tensor,
                             bias_a: torch.Tensor, scale_w: torch.Tensor,
                             k_logical: int) -> torch.Tensor:
    """Plain version of the fused entry: the packed binary linear's forward
    as the JAX package's CPU branch computes it (pad with -1, pack the signs
    of ``x + bias_a``, the XNOR GEMM, then the scales in that order)."""
    xs = (x + bias_a).float()
    x2d = xs.reshape(-1, k_logical)
    xp, _ = packing.pad_to_multiple(x2d, 1, 32, value=-1.0)
    y = xnor_gemm_ref(packing.pack_signs(xp), w_words, k_logical)
    y = y.reshape(*xs.shape[:-1], -1)
    return (y * scale_a * scale_w).to(x.dtype)


def row_tile(m: int) -> int:
    """Row tiles of the kernel, in units of 8 rows: the smallest of 1, 2,
    4, 8 that holds ``m`` rows (8 beyond 64 rows)."""
    for mt in (1, 2, 4):
        if m <= 8 * mt:
            return mt
    return 8


def col_tile(mt: int) -> int:
    """Columns of a warp's tile: 16 to two row tiles, else 32."""
    return 16 if mt <= 2 else 32


def smem_bytes(mt: int, kw: int) -> int:
    """Shared memory of a launch (``csrc/binary_gemm.cu`` ``smem_bytes``):
    the block's rows of x as words, rows padded to an odd multiple of 4,
    beside the larger of the warps' rings (a slab of 8 words of each
    column a stage) and their int32 partials."""
    nt = col_tile(mt) // 16
    kwp = (kw + 7) // 8 * 8 + 4
    ring = WARPS * DEPTH * 32 * nt * 16
    red = WARPS * mt * nt * 4 * 32 * 4
    return mt * 8 * kwp * 4 + max(ring, red)


def fits(m: int, kw: int) -> bool:
    """Whether the kernel's shared memory holds ``m`` rows of ``kw`` words."""
    return smem_bytes(row_tile(m), kw) <= MAX_SHARED


# words of x a block of the fused entry builds in one pass (8 warps of 8
# quads, 4 steps' loads in flight): a block needs one pass a share, so a
# cluster splits rows x Kw words beyond it (chip_smoke.py phase 14's shapes
# on the H100: alone at 1024^2 m 8, a cluster of 4 at 4096^2 m 8)
PASS_WORDS = WARPS * 8 * 4


def xnor_plan(m: int, n: int, kw: int, sms: int, fused: bool) -> Tuple[int, int, int, int]:
    """The launch shape ``(mt, wk, tpb, cluster)`` at ``(m, n, kw)`` on a
    card of ``sms`` SMs, for the words entry or the fused one: row tiles
    of ``8 mt`` rows; the fewest warps along K (1, 2, 4, 8; at most one per
    slab of 8 words) that give one block an SM (the fused entry: a third
    of the SMs, as each block builds its rows of x), else the most; with
    one warp along K, ``tpb`` column tiles a block (a power of 2) while the
    grid still gives one block an SM; for the fused entry, the fewest
    blocks in a cluster along the columns (1, 2, 4, 8) that cut each
    block's share of its rows' words to ``PASS_WORDS``."""
    mt = row_tile(m)
    cw = col_tile(mt)
    gy = -(-m // (8 * mt))
    tiles = -(-n // cw)  # warp column tiles
    slabs = -(-kw // 8)

    def gx(wk, tpb=1):
        return -(-tiles // (WARPS // wk * tpb))

    want = -(-sms // 3) if fused else sms
    wks = [wk for wk in (1, 2, 4, 8) if wk == 1 or wk <= slabs]
    wk = next((wk for wk in wks if gy * gx(wk) >= want), wks[-1])
    tpb = 1
    while wk == 1 and gy * gx(1, 2 * tpb) >= sms and 2 * tpb * WARPS <= tiles:
        tpb *= 2
    cluster = 1
    while (fused and 8 * mt * kw > cluster * PASS_WORDS and cluster < 8
           and 2 * cluster <= gx(wk, tpb)):
        cluster *= 2
    return mt, wk, tpb, cluster


@functools.lru_cache(maxsize=None)
def _words_fn():
    return _build.function("binary_gemm", "bte_xnor_gemm",
                           [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])


@functools.lru_cache(maxsize=None)
def _fused_fn():
    return _build.function("binary_gemm", "bte_binary_packed_linear",
                           [_P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P])


def _check_words(name: str, t: torch.Tensor, kw: int, device) -> None:
    if t.dim() != 2 or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.shape[1] != kw:
        raise ValueError(f"word counts differ: {name} has {t.shape[1]}, not {kw}")


def _check_k(kw: int, k_logical: int) -> None:
    if not 32 * (kw - 1) < k_logical <= 32 * kw:
        raise ValueError(f"k_logical={k_logical} does not fit {kw} words")


def _plan(m: int, n: int, kw: int, device: torch.device, fused: bool) -> Tuple[int, int, int, int]:
    if not fits(m, kw):
        raise ValueError(f"kernel 8: K = {32 * kw} does not fit the kernel's shared memory")
    return xnor_plan(m, n, kw, _build.sm_count(device.index or 0), fused)


def _vec_w(words: torch.Tensor) -> int:
    """Rows of 16-byte aligned words (the kernel's 16-byte copies)."""
    return int(words.shape[1] % 4 == 0 and words.data_ptr() % 16 == 0)


def xnor_gemm(x_words: torch.Tensor, w_words: torch.Tensor, k_logical: int) -> torch.Tensor:
    """Kernel 8: ``(M, Kw) × (N, Kw)`` sign words → f32 ``(M, N)`` ±1 dots
    over ``k_logical`` features."""
    kw = x_words.shape[-1]
    _check_words("x_words", x_words, kw, x_words.device)
    _check_words("w_words", w_words, kw, x_words.device)
    _check_k(kw, k_logical)
    if x_words.device.type == "cpu":
        return xnor_gemm_ref(x_words, w_words, k_logical)
    if x_words.device.type != "cuda":
        raise ValueError(f"xnor_gemm: unsupported device {x_words.device}")
    m, n = x_words.shape[0], w_words.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x_words.device)
    if m == 0 or n == 0:
        return out
    mt, wk, tpb, _ = _plan(m, n, kw, x_words.device, False)
    err = _words_fn()(x_words.data_ptr(), w_words.data_ptr(), out.data_ptr(), m, n, kw, k_logical,
                      mt, wk, tpb, _vec_w(x_words), _vec_w(w_words), _stream(x_words.device))
    _build.check("binary_gemm", err, "xnor_gemm launch")
    xnor_gemm.launches += 1
    return out


xnor_gemm.launches = 0


def binary_packed_linear(x: torch.Tensor, w_words: torch.Tensor, scale_a: torch.Tensor,
                         bias_a: torch.Tensor, scale_w: torch.Tensor,
                         k_logical: int) -> torch.Tensor:
    """Kernel 8 fused with the packed binary linear: ``x`` ``(..., K)``
    f32, bf16 or f16, ``bias_a`` ``(K,)``, ``scale_a`` and ``scale_w`` one
    value each, ``w_words`` ``(N, ceil(K / 32))`` → ``(sign(x + bias_a) ⊛
    sign(W)ᵀ · scale_a · scale_w)`` ``(..., N)`` in ``x.dtype``."""
    kw = w_words.shape[-1]
    if x.shape[-1] != k_logical or bias_a.shape != (k_logical,):
        raise ValueError(f"x {tuple(x.shape)} and bias_a {tuple(bias_a.shape)} must end in "
                         f"k_logical={k_logical}")
    _check_words("w_words", w_words, kw, x.device)
    _check_k(kw, k_logical)
    for name, t in (("bias_a", bias_a), ("scale_a", scale_a), ("scale_w", scale_w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, not {x.device}")
    if scale_a.numel() != 1 or scale_w.numel() != 1:
        raise ValueError("scale_a and scale_w must hold one value each")
    if x.device.type == "cpu":
        return binary_packed_linear_ref(x, w_words, scale_a, bias_a, scale_w, k_logical)
    if x.device.type != "cuda":
        raise ValueError(f"binary_packed_linear: unsupported device {x.device}")
    for name, t in (("x", x), ("bias_a", bias_a), ("scale_a", scale_a), ("scale_w", scale_w)):
        if t.dtype not in DTYPES or not t.is_contiguous():
            raise ValueError(f"binary_packed_linear: {name} must be a contiguous f32, bf16 or "
                             f"f16 tensor, got {t.dtype}")
    lead = x.shape[:-1]
    m, n = x.numel() // max(1, k_logical), w_words.shape[0]
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = _plan(m, n, kw, x.device, True)
    vec_x = int(k_logical % 8 == 0 and x.data_ptr() % 16 == 0 and bias_a.data_ptr() % 16 == 0)
    err = _fused_fn()(x.data_ptr(), DTYPES[x.dtype], bias_a.data_ptr(), DTYPES[bias_a.dtype],
                      scale_a.data_ptr(), DTYPES[scale_a.dtype], scale_w.data_ptr(),
                      DTYPES[scale_w.dtype], w_words.data_ptr(), out.data_ptr(), m, n, k_logical,
                      kw, *plan, vec_x, _vec_w(w_words), _stream(x.device))
    _build.check("binary_gemm", err, "binary_packed_linear launch")
    binary_packed_linear.launches += 1
    return out


binary_packed_linear.launches = 0
