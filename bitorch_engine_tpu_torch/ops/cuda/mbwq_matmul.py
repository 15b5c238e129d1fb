"""Kernel 7: the fused mixed-bit (MBWQ) matmul, one launch over all segments.

The counterpart of ``bitorch_engine_tpu/ops/pallas/mbwq_matmul.py``
(``mbwq_matmul_pallas``).  ``x`` arrives channel-scaled and gathered into
segment order (``ops.mbwq_linear.gather_activations``); the kernel walks
every segment's quant groups with one f32 accumulator per output and casts
once.  It takes 1-8 A16 segments in the kernel form of
``prepare_for_kernel``, sharing N and one metadata dtype.

The body is picked by ``x.dtype``: bf16 activations (every path on the card)
go to ``csrc/mbwq_matmul.cu`` (``mbwq_mma_kernel``: ``mma.sync`` on codes
converted in registers, the concatenated K cut into one equal run per warp
by :func:`warp_cuts`, the block by :func:`block_warps`); f32 activations
to ``csrc/dequant_matmul.cu``'s scalar ``mbwq_matmul_kernel``.  The wrapper launches a kernel for CUDA
tensors and raises on what it does not take; it runs the plain PyTorch
version only for CPU tensors.  ``mbwq_matmul.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

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


def chunk_words(w_bit: int, group_size: int) -> int:
    """Words of a column that the bf16 body converts as one chunk: 4, or 2 /
    1 where a group is shorter than 4 words.  A chunk holds whole k16 slabs
    and lies inside one group; raises where no chunk does."""
    ppw = 32 // w_bit
    c = 4
    while c > 1 and c * ppw > group_size:
        c //= 2
    ck = c * ppw
    if ck % 16 or group_size % ck:
        raise ValueError(
            f"kernel 7's bf16 body takes group sizes that are multiples of 16, "
            f"got w{w_bit} group_size={group_size}"
        )
    return c


def block_warps(m: int) -> int:
    """Warps of a bf16-body block for ``m`` rows, one K run each.  Decode (m
    <= 8) takes 16 warps x 64 columns a block, larger m 8 warps x 32
    columns: at m = 8 more columns a chunk and more warps an SM beat more
    blocks (measured on the card, PERF.md §6)."""
    return 16 if m <= 8 else 8


def warp_cuts(segs: Sequence[Tuple[int, int]], n_warps: int) -> List[int]:
    """The ``n_warps + 1`` bounds of the warps' K runs over the concatenated
    K of ``segs`` (each ``(rows, chunk rows)``): cut ``w`` is the chunk
    boundary nearest ``w · K / n_warps`` in the segment it falls in, so the
    runs are equal to within a chunk and may cross groups and segments."""
    total = sum(k for k, _ in segs)
    cuts = [0]
    for w in range(1, n_warps):
        target = w * total / n_warps
        off = 0
        for k, ck in segs:
            if target < off + k:
                cut = off + int((target - off) / ck + 0.5) * ck
                break
            off += k
        else:
            cut = total
        cuts.append(max(cut, cuts[-1]))
    cuts.append(total)
    return cuts


@functools.lru_cache(maxsize=None)
def _mma_fn():
    return _build.function(
        "mbwq_matmul", "bte_mbwq_matmul_mma",
        [_P, _I, _PP, _PP, _PP, _PI, _PI, _PI, _PI, _I, _PI, _P, _I, _I, _I, _I, _I, _P],
    )


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
    ``torch.float32`` returns the accumulator before any cast).

    On the card a bf16 ``x`` launches the tensor-core body
    (``csrc/mbwq_matmul.cu``; every group size a multiple of 16, see
    :func:`chunk_words`) and an f32 ``x`` the scalar body
    (``csrc/dequant_matmul.cu``); neither falls back to the other."""
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

    tables = (ptrs("packed"), ptrs("scales"), ptrs("zeros"), ints(s.w_bit for s in segs),
              ints(s.group_size for s in segs), ints(s.in_features for s in segs))
    meta, odt = _DTYPE_CODE[segs[0].scales.dtype], _DTYPE_CODE[out_dtype]
    if x.dtype == torch.bfloat16:
        chunks = [chunk_words(s.w_bit, s.group_size) for s in segs]
        n_warps = block_warps(m)
        cuts = warp_cuts([(s.in_features, c * 32 // s.w_bit) for s, c in zip(segs, chunks)], n_warps)
        err = _mma_fn()(
            x.data_ptr(), ns, *tables, ints(chunks), n_warps, (ctypes.c_int * len(cuts))(*cuts),
            out.data_ptr(), m, k, n, meta, odt, _stream(x.device),
        )
        _build.check("mbwq_matmul", err, "mbwq_matmul launch")
    else:
        err = _mbwq_fn()(
            x.data_ptr(), ns, *tables, out.data_ptr(), m, k, n,
            _DTYPE_CODE[x.dtype], meta, odt, _stream(x.device),
        )
        _build.check("dequant_matmul", err, "mbwq_matmul launch")
    mbwq_matmul.launches += 1
    return out


mbwq_matmul.launches = 0
