"""Quantization math in PyTorch: the per-tensor quantizers, the binary and
n-bit QAT initialisers, MPQ (GPTQ/GBA) quantize, dequantize,
concatenate and slice, and the GBA checkpoints' scale decompression.

The counterpart of ``bitorch_engine_tpu/ops/quant.py``, bit-exact with its
jitted functions: both sides compute in float32 with the same operations
in the same order (``torch.round`` rounds half to even, as ``jnp.round``
does), and where XLA folds a division by a constant into a multiplication
by its f32 reciprocal the port multiplies by the same reciprocal
(:func:`_recip`).  Sums are the one exception: XLA and PyTorch add in
another order, so a mean or a sum may differ in its last bits.
:func:`repack_mpq` is the training step's requantization.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..qtensor import BinaryQTensor, IntQTensor, MPQTensor
from . import packing

# the Q8 / Q4 activation-scale divisors of the reference's quantizers
Q8_DIVISOR = 11.269
Q4_DIVISOR = 5.6345


def _group_index(qt: MPQTensor, k: int) -> torch.Tensor:
    if qt.g_idx is not None:
        return qt.g_idx.long()
    return torch.arange(k, device=qt.packed.device) // qt.group_size


def _unpermute(w: torch.Tensor, q_perm: torch.Tensor) -> torch.Tensor:
    """Rows stored permuted: row i goes back to row ``q_perm[i]`` (a
    permutation), as a gather of rows by its inverse (one pass over ``w``)."""
    perm = q_perm.long()
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(perm.numel(), device=perm.device)
    return w.index_select(0, inverse)


def check_row_map(q_perm: torch.Tensor, k: int) -> None:
    """Raise unless ``q_perm`` is a permutation of ``[0, k)``.  Kernel 2
    writes stored row ``r`` to row ``q_perm[r]``, so a map that names a row
    twice leaves another unwritten.  One host sync: it runs where a map
    enters the program (a loaded record), never per call."""
    if tuple(q_perm.shape) != (k,) or not torch.equal(
        torch.sort(q_perm.long()).values, torch.arange(k, device=q_perm.device)
    ):
        raise ValueError(f"q_perm must be a permutation of the {k} input rows")


def dequantize_mpq(qt: MPQTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Reconstruct the fp weight ``(K, N)``; the three styles of the reference:

    1. asym: ``w = s[g] * (q - z[g])`` with packed zeros carrying ``+1``;
    2. sym with ``g_idx``: ``w = q * s[g] - z[g]``;
    3. sym without ``g_idx``: contiguous groups, then the optional
       ``q_perm`` scatter back to the logical row order.
    """
    k, _ = qt.logical_shape
    q = packing.unpack_rows_layout(qt.packed, qt.w_bit, qt.group_size, qt.layout)
    g = _group_index(qt, k)
    if qt.asym:
        zeros = packing.unpack_cols(qt.zeros, qt.w_bit)
        w = qt.scales[g].float() * (q - zeros[g]).float()
    else:
        # One rounding, as the JAX package's jitted dequantize does (XLA
        # contracts q * s - z into a fused multiply-add): the product of an
        # integer code below 2^8 and an f32 scale is exact in f64, so the
        # f64 difference rounded to f32 is the fused result.
        w = (q.double() * qt.scales[g].double() - qt.zeros[g].double()).float()
    if qt.g_idx is None and qt.q_perm is not None:
        w = _unpermute(w, qt.q_perm)
    return w.to(dtype)


def slice_mpq_n(qt: MPQTensor, start: int, size: int) -> MPQTensor:
    """Output columns ``[start, start + size)`` (the inverse of :func:`concat_mpq`);
    asym zeros pack along N, so both must align to codes-per-word there."""
    packed = qt.packed[:, start : start + size]
    scales = qt.scales[:, start : start + size]
    if qt.asym:
        ppw = 32 // qt.w_bit
        if start % ppw or size % ppw:
            raise ValueError("asym slice must align to codes-per-word")
        zeros = qt.zeros[:, start // ppw : (start + size) // ppw]
    else:
        zeros = qt.zeros[:, start : start + size]
    return qt.replace(
        packed=packed.contiguous(), scales=scales.contiguous(), zeros=zeros.contiguous()
    )


def concat_mpq(parts: Sequence[MPQTensor]) -> MPQTensor:
    """Concatenate tensors sharing one K along N (fused q|k|v, gate|up).

    Group quantization is per (K-group, N-column), so concatenation along N
    commutes with quantization.  Act-order parts (``g_idx``/``q_perm``) are
    refused: their row maps cannot share one launch.
    """
    first = parts[0]
    for p in parts[1:]:
        if (
            p.w_bit != first.w_bit
            or p.group_size != first.group_size
            or p.asym != first.asym
            or p.layout != first.layout
            or p.code_bits != first.code_bits
            or p.in_features != first.in_features
        ):
            raise ValueError("concat_mpq: parts disagree on quant structure")
    if any(p.g_idx is not None or p.q_perm is not None for p in parts):
        raise ValueError("concat_mpq: parts with g_idx/q_perm (act-order) cannot be fused")
    return first.replace(
        packed=torch.cat([p.packed for p in parts], dim=1),
        scales=torch.cat([p.scales for p in parts], dim=1),
        zeros=torch.cat([p.zeros for p in parts], dim=1),
        grad_shadow=None,
        zeros_mid=all(p.zeros_mid for p in parts),
    )


def _recip(c: float) -> float:
    """float32 reciprocal of ``c``, as XLA folds ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


def _mean(x: torch.Tensor, factor: float = 1.0, divisor: float = 1.0) -> torch.Tensor:
    """``factor * mean(x) / divisor`` in f32 as the jitted JAX computes it:
    XLA folds the three constants into one, ``f32(f32(factor * 1/n) *
    1/divisor)`` (each reciprocal in f32), and multiplies the sum by it."""
    c = np.float32(factor) * np.float32(_recip(x.numel()))
    return x.sum() * float(np.float32(c * np.float32(_recip(divisor))))


# ---------------------------------------------------------------------------
# Per-tensor quantizers
# ---------------------------------------------------------------------------


def nv_tensor_quant(
    inputs: torch.Tensor, amax: Optional[torch.Tensor] = None, num_bits: int = 8,
    narrow_range: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization (TensorRT style): ``(q, scale)`` with
    ``q = clamp(round(x * scale), -B, B)`` (``-B - 1`` below without
    ``narrow_range``), ``B = 2^(bits-1) - 1`` and ``scale = B / amax``, in
    the dtype of ``inputs``.

    As in the reference, ``amax`` defaults to the MAXIMUM of ``x`` (not its
    largest magnitude), and an ``amax`` at or below 2^-24 overrides only the
    RETURNED scale (to 1), after ``q`` was computed with the huge one."""
    x = inputs.float()
    amax = x.max() if amax is None else torch.as_tensor(amax, dtype=torch.float32,
                                                         device=x.device)
    max_bound = float(2.0 ** (num_bits - 1) - 1.0)
    min_bound = -max_bound if narrow_range else -max_bound - 1.0
    # a true division (``float / tensor`` would multiply by the reciprocal)
    scale = torch.div(torch.full_like(amax, max_bound), amax)
    q = torch.clamp(torch.round(x * scale), min_bound, max_bound)
    scale = torch.where(amax <= 1.0 / (1 << 24), torch.ones_like(scale), scale)
    return q.to(inputs.dtype), scale


def _act_quant(x: torch.Tensor, scale_a, eps: float, divisor: float, lo: int, hi: int):
    xf = x.float()
    if scale_a is None:
        scale = torch.clamp_min(_mean(xf.abs(), 2.0, divisor), eps)
        return torch.clamp(torch.round(xf / scale), lo, hi), scale
    scale = torch.clamp_min(torch.as_tensor(scale_a, device=xf.device).float(), eps)
    return torch.clamp(torch.round(xf / scale), lo, hi)


def q8_quantization(x: torch.Tensor, scale_a: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """Uniform 8-bit activation quantization: codes in [-128, 127] as f32;
    without ``scale_a`` also returns the data scale ``2 mean|x| / 11.269``."""
    return _act_quant(x, scale_a, eps, Q8_DIVISOR, -128, 127)


def q4_quantization(x: torch.Tensor, scale_a: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """Uniform 4-bit activation quantization: codes in [-8, 7] as f32;
    without ``scale_a`` also returns the data scale ``2 mean|x| / 5.6345``."""
    return _act_quant(x, scale_a, eps, Q4_DIVISOR, -8, 7)


# ---------------------------------------------------------------------------
# Binary / n-bit QAT weights
# ---------------------------------------------------------------------------


def init_binary_weight(weight: torch.Tensor) -> BinaryQTensor:
    """fp weight ``(N, K)`` → int8 binary-QAT weight + L1 scale: ``scale_w =
    mean |w|``; the centered weight quantized by :func:`nv_tensor_quant`,
    its zero codes replaced by the centered value's sign."""
    w = weight.float()
    scale_w = _mean(w.abs())
    centered = w - _mean(w)
    w_int8, _ = nv_tensor_quant(centered)
    w_int8 = torch.where(w_int8 == 0, torch.sign(centered), w_int8)
    return BinaryQTensor(data=w_int8.to(torch.int8), scale_w=scale_w, in_features=weight.shape[1])


def init_nbit_weight(weight: torch.Tensor, w_bit: int = 4) -> IntQTensor:
    """fp weight → int8 n-bit QAT codes with ``w ≈ data * scale_w``,
    ``scale_w = max(2 mean|w| / divisor, 1e-5)`` (divisor 5.6345 at 4 bits,
    11.269 otherwise)."""
    w = weight.float()
    divisor = Q4_DIVISOR if w_bit == 4 else Q8_DIVISOR
    scale_w = torch.clamp_min(_mean(w.abs(), 2.0, divisor), 1e-5)
    qlow, qhigh = -(2.0 ** (w_bit - 1)), 2.0 ** (w_bit - 1) - 1.0
    data = torch.clamp(torch.round(w / scale_w), qlow, qhigh)
    return IntQTensor(data=data.to(torch.int8), scale_w=scale_w, w_bit=w_bit)


def pack_binary_weight(qt: BinaryQTensor) -> BinaryQTensor:
    """QAT binary weight ``(N, K)`` → sign-packed inference weight (one bit
    a weight); a packed weight is returned as it is."""
    if qt.packed:
        return qt
    data, _ = packing.pad_to_multiple(qt.data.float(), 1, 32, value=-1.0)
    return BinaryQTensor(data=packing.pack_signs(data), scale_w=qt.scale_w, packed=True,
                         in_features=qt.data.shape[1])


def quantize_mpq(
    weight: torch.Tensor,
    w_bit: int = 4,
    group_size: int = 128,
    asym: bool = False,
    code_bits: Optional[int] = None,
    mid_sym: bool = False,
) -> MPQTensor:
    """Round-to-nearest group quantization of an fp weight ``(K, N)``.

    sym (GBA): ``w = q * s - z`` with ``z = -min``; asym (GPTQ): packed
    integer zeros; ``mid_sym``: ``z = 2**(bits-1) * s`` exactly (exl2
    symmetric midpoint).  ``code_bits`` < ``w_bit`` quantizes at an odd
    width inside the byte-aligned container.

    The JAX package runs this under ``jit``, where XLA turns a division by
    a constant into a multiplication by its float32 reciprocal; the port
    multiplies by the same reciprocal (``_recip``) so that the two agree
    bit for bit.
    """
    k, n = weight.shape
    if w_bit not in packing.SUPPORTED_BITS:
        raise ValueError(
            f"w_bit={w_bit} is not a packable container width {packing.SUPPORTED_BITS}; "
            f"for odd exl2 widths pass the container (e.g. w_bit=4, code_bits=3)"
        )
    if k % group_size != 0:
        raise ValueError(f"K={k} not a multiple of group_size={group_size}")
    if code_bits is not None and not 0 < code_bits <= w_bit:
        raise ValueError(f"code_bits={code_bits} must be in (0, w_bit={w_bit}]")
    w = weight.float().reshape(k // group_size, group_size, n)
    maxq = float(2 ** (code_bits or w_bit) - 1)
    wmin = w.amin(dim=1)
    wmax = w.amax(dim=1)
    if asym:
        scales = torch.clamp_min((wmax - wmin) * _recip(maxq), 1e-8)
        zeros_int = torch.clamp(torch.round(-wmin / scales), 1, maxq).to(torch.int32)
        q = torch.clamp(torch.round(w / scales[:, None, :]) + zeros_int[:, None, :], 0, maxq)
        return MPQTensor(
            packed=packing.pack_rows(q.to(torch.int32).reshape(k, n), w_bit),
            scales=scales,
            zeros=packing.pack_cols(zeros_int, w_bit),
            w_bit=w_bit,
            group_size=group_size,
            asym=True,
            code_bits=code_bits,
        )
    if mid_sym:
        mid = float(2 ** ((code_bits or w_bit) - 1))
        scales = torch.clamp_min(
            torch.maximum(wmax * _recip(maxq - mid), -wmin * _recip(mid)), 1e-8
        )
        zeros = mid * scales
        q = torch.clamp(torch.round(w / scales[:, None, :]) + mid, 0, maxq)
        return MPQTensor(
            packed=packing.pack_rows(q.reshape(k, n).to(torch.int32), w_bit),
            scales=scales,
            zeros=zeros,
            w_bit=w_bit,
            group_size=group_size,
            code_bits=code_bits,
            zeros_mid=True,
        )
    scales = torch.clamp_min((wmax - wmin) * _recip(maxq), 1e-8)
    zeros = -wmin
    q = torch.clamp(torch.round((w + zeros[:, None, :]) / scales[:, None, :]), 0, maxq)
    return MPQTensor(
        packed=packing.pack_rows(q.reshape(k, n).to(torch.int32), w_bit),
        scales=scales,
        zeros=zeros,
        w_bit=w_bit,
        group_size=group_size,
        code_bits=code_bits,
    )


def repack_mpq(
    weight: torch.Tensor, qt: MPQTensor, unpacked_zeros: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """fp weight ``(K, N)`` → packed int32 in the gptq row order, reusing
    ``qt``'s scales, zeros and ``g_idx`` (DiodeMix's requantization after
    its AdamW step).  Bit-exact with the JAX package's ``repack_mpq``: the
    division by the scales is a true division (the scales are no constant
    XLA could fold), ``torch.round`` rounds half to even.  A ``q_perm``
    tensor gathers the logical rows into its stored order; asym tensors
    take ``unpacked_zeros`` ``(G, N)`` in place of their packed zeros."""
    if qt.layout != "gptq":
        raise ValueError(
            f"repack_mpq writes the gptq layout; this tensor is {qt.layout!r} "
            "(prepare_for_kernel converts it)"
        )
    k, _ = qt.logical_shape
    maxq = 2 ** qt.quant_bits - 1
    g = _group_index(qt, k)
    scales = qt.scales[g].float()
    w = weight.float()
    if qt.g_idx is None and qt.q_perm is not None:
        w = w[qt.q_perm.long()]
    if qt.asym:
        zeros = packing.unpack_cols(qt.zeros, qt.w_bit) if unpacked_zeros is None else unpacked_zeros
        q = torch.round(w / scales + zeros[g].float())
    else:
        q = torch.round((w + qt.zeros[g].float()) / scales)
    return packing.pack_rows(torch.clamp(q, 0, maxq).to(torch.int32), qt.w_bit)


# ---------------------------------------------------------------------------
# GBA double-quantization decompression
# ---------------------------------------------------------------------------


def _apply_scale_affine(qscales, zeros, scales, g, out_channels, dq_mode, dtype):
    """Affine-dequantize 4-bit scale codes, ``(q - z) * s`` in ``dtype``.

    ``dq_mode=2`` (LLaMA-2/3 GBA checkpoints): the pair is per (group,
    dq-group), ``(G, N/dqg, 1)`` against ``(G, N/dqg, dqg)`` codes;
    ``dq_mode=1`` (LLaMA-1-era GBA): per output channel, ``(1, N, 1)``,
    applied to the codes flattened to ``(G, N)``.
    """
    if dq_mode == 1:
        q2d = qscales.reshape(g, out_channels)
        return (q2d - zeros.to(dtype).reshape(1, out_channels)) * scales.to(dtype).reshape(
            1, out_channels
        )
    return ((qscales - zeros.to(dtype)) * scales.to(dtype)).reshape(g, out_channels)


def decompress_gba_sym(
    qstatistic: torch.Tensor, qzeros_zeros: torch.Tensor, qzeros_scales: torch.Tensor,
    qscales_zeros: torch.Tensor, qscales_scales: torch.Tensor, out_channels: int,
    dtype: torch.dtype = torch.float32, dq_mode: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GBA double-quantized scales and zeros (symmetric mode) → ``(G, N)``
    each: ``qstatistic`` uint8 ``(G, N/dqg, dqg)`` holds the 4-bit scale
    code in its high nibble and the 4-bit zero code in its low nibble, each
    dequantized by its own (zero, scale) pair; ``dq_mode`` picks the scale
    pair's layout (:func:`_apply_scale_affine`), the zeros pair is per
    dq-group in both modes."""
    qs = qstatistic.to(torch.uint8)
    qscales = (qs >> 4).to(dtype)
    qzeros = (qs & 0x0F).to(dtype)
    g = qs.shape[0]
    zeros = ((qzeros - qzeros_zeros.to(dtype)) * qzeros_scales.to(dtype)).reshape(g, out_channels)
    scales = _apply_scale_affine(qscales, qscales_zeros, qscales_scales, g, out_channels,
                                 dq_mode, dtype)
    return scales, zeros


def decompress_gba_asym(
    qscales: torch.Tensor, qscales_zeros: torch.Tensor, qscales_scales: torch.Tensor,
    out_channels: int, w_bit: int, dtype: torch.dtype = torch.float32, dq_mode: int = 2,
) -> torch.Tensor:
    """GBA double-quantized scales (asymmetric mode) → ``(G, N)``; the zeros
    stay the packed int32 ``qzeros``.  At w_bit 2 a 2-d ``qscales`` gets a
    trailing axis first."""
    qsc = qscales.to(dtype)
    if w_bit == 2 and qsc.dim() == 2:
        qsc = qsc[..., None]
    return _apply_scale_affine(qsc, qscales_zeros, qscales_scales, qsc.shape[0], out_channels,
                               dq_mode, dtype)
