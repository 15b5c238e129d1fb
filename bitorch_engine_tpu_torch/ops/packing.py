"""Bit packing and unpacking of int32 code words, in PyTorch.

The counterpart of ``bitorch_engine_tpu/ops/packing.py``, bit-exact with it.
PyTorch has no uint32, so words are widened to int64 and masked to their
low 32 bits before any shift; packed words are stored back as int32 with
two's-complement wrap.

The three TPU row layouts (``tpu_tiled``, ``tpu_pair``, ``tpu_quad``) are
read here so that parameters relayouted by the JAX package still load; the
port packs only the checkpoint ("gptq") order.

Sign packing for binary tensors (:func:`pack_signs` / :func:`unpack_signs`)
keeps the JAX package's bit order: bit j of a word is element j of its 32
(LSB first), set iff the element is >= 0; callers pad with -1, so pad bits
are 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

SUPPORTED_BITS = (1, 2, 4, 8)

# container widths whose codes fit an int8 byte unbiased: the A8 regime's
QUAD_BITS = (1, 2, 4)

# storage container per quantization width: odd exl2 widths ride in the
# next byte-aligned container; MPQTensor.code_bits records the true width
CONTAINER_BITS = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 8: 8}

_LOW32 = 0xFFFFFFFF


def _check_bits(w_bit: int) -> int:
    if w_bit not in SUPPORTED_BITS:
        raise ValueError(
            f"w_bit={w_bit} unsupported; int32 packing needs w_bit in {SUPPORTED_BITS}"
        )
    return 32 // w_bit


def _words_u32(packed: torch.Tensor) -> torch.Tensor:
    return packed.to(torch.int64) & _LOW32


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 with two's-complement wrap."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _shifts(w_bit: int, count: int, device) -> torch.Tensor:
    return torch.arange(count, dtype=torch.int64, device=device) * w_bit


# ---------------------------------------------------------------------------
# "gptq" order along rows: int32 (K // ppw, N) <-> int (K, N)
# ---------------------------------------------------------------------------


def pack_rows(intweight: torch.Tensor, w_bit: int) -> torch.Tensor:
    """Pack unsigned values in [0, 2^w_bit) along axis 0 into int32 words."""
    ppw = _check_bits(w_bit)
    k, n = intweight.shape
    if k % ppw != 0:
        raise ValueError(f"K={k} must be a multiple of {ppw} for w_bit={w_bit}")
    vals = intweight.to(torch.int64).reshape(k // ppw, ppw, n)
    words = (vals << _shifts(w_bit, ppw, vals.device)[None, :, None]).sum(dim=1)
    return _to_int32(words)


def unpack_rows(packed: torch.Tensor, w_bit: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows` → int32 ``(K, N)`` in [0, 2^w_bit)."""
    ppw = _check_bits(w_bit)
    kw, n = packed.shape
    words = _words_u32(packed)[:, None, :]
    vals = (words >> _shifts(w_bit, ppw, packed.device)[None, :, None]) & ((1 << w_bit) - 1)
    return vals.reshape(kw * ppw, n).to(torch.int32)


# ---------------------------------------------------------------------------
# GPTQ zeros along columns: (G, N) <-> int32 (G, N // ppw), stored as zero - 1
# ---------------------------------------------------------------------------


def pack_cols(zeros: torch.Tensor, w_bit: int) -> torch.Tensor:
    """Pack zero-points ``(G, N)`` in [1, 2^b] along the last axis as ``zero - 1``."""
    ppw = _check_bits(w_bit)
    g, n = zeros.shape
    if n % ppw != 0:
        raise ValueError(f"N={n} must be a multiple of {ppw} for w_bit={w_bit}")
    vals = ((zeros.to(torch.int64) - 1) & _LOW32) & ((1 << w_bit) - 1)
    vals = vals.reshape(g, n // ppw, ppw)
    words = (vals << _shifts(w_bit, ppw, vals.device)[None, None, :]).sum(dim=-1)
    return _to_int32(words)


def unpack_cols(packed_zeros: torch.Tensor, w_bit: int) -> torch.Tensor:
    """Inverse of :func:`pack_cols` → int32 ``(G, N)`` with the ``+1`` re-applied."""
    ppw = _check_bits(w_bit)
    g, nw = packed_zeros.shape
    words = _words_u32(packed_zeros)[:, :, None]
    vals = (words >> _shifts(w_bit, ppw, packed_zeros.device)[None, None, :]) & (
        (1 << w_bit) - 1
    )
    return vals.reshape(g, nw * ppw).to(torch.int32) + 1


# ---------------------------------------------------------------------------
# TPU row layouts, read only (see bitorch_engine_tpu/ops/packing.py)
# ---------------------------------------------------------------------------


def unpack_rows_tpu_tiled(packed: torch.Tensor, w_bit: int, group_size: int) -> torch.Tensor:
    """Within each group, value j of word r is row ``j * (gs / ppw) + r``."""
    ppw = _check_bits(w_bit)
    kw, n = packed.shape
    bkp = group_size // ppw
    g = kw // bkp
    words = _words_u32(packed).reshape(g, 1, bkp, n)
    sh = _shifts(w_bit, ppw, packed.device)[None, :, None, None]
    vals = (words >> sh) & ((1 << w_bit) - 1)
    return vals.reshape(g * ppw * bkp, n).to(torch.int32)


def unpack_rows_tpu_pair(packed: torch.Tensor, w_bit: int, group_size: int) -> torch.Tensor:
    """Codes split across the two 16-bit halves of each word: row of (tile j,
    word r, half h) is ``j * 2 * bkp + 2 r + h`` within its group."""
    ppw = _check_bits(w_bit)
    kw, n = packed.shape
    bkp = group_size // ppw
    g = kw // bkp
    words = _words_u32(packed).reshape(g, 1, bkp, 1, n)
    sh = (
        _shifts(w_bit, ppw // 2, packed.device)[None, :, None, None, None]
        + (torch.arange(2, dtype=torch.int64, device=packed.device) * 16)[
            None, None, None, :, None
        ]
    )
    vals = (words >> sh) & ((1 << w_bit) - 1)
    return vals.reshape(g * group_size, n).to(torch.int32)


def quad_superblock_groups(w_bit: int) -> int:
    """Quant groups per tpu_quad superblock (= ppw / 4 = 8 / w_bit)."""
    return 8 // w_bit


def unpack_rows_tpu_quad(packed: torch.Tensor, w_bit: int, group_size: int) -> torch.Tensor:
    """Codes split across the four byte slots of each word, per superblock of
    ``8 / w_bit`` groups: row of (tile j, word r, byte h) is
    ``j * 4 * R + 4 r + h`` within its superblock (R word rows)."""
    ppw = _check_bits(w_bit)
    kw, n = packed.shape
    bkp = group_size // ppw
    sb = quad_superblock_groups(w_bit)
    r = sb * bkp
    nsb = kw // r
    words = _words_u32(packed).reshape(nsb, 1, r, 1, n)
    sh = (
        _shifts(w_bit, ppw // 4, packed.device)[None, :, None, None, None]
        + (torch.arange(4, dtype=torch.int64, device=packed.device) * 8)[
            None, None, None, :, None
        ]
    )
    vals = (words >> sh) & ((1 << w_bit) - 1)
    return vals.reshape(nsb * sb * group_size, n).to(torch.int32)


def unpack_rows_layout(
    packed: torch.Tensor, w_bit: int, group_size: int, layout: str
) -> torch.Tensor:
    """Dispatch unpacking by :class:`MPQTensor` ``layout``."""
    if layout == "tpu_pair":
        return unpack_rows_tpu_pair(packed, w_bit, group_size)
    if layout == "tpu_quad":
        return unpack_rows_tpu_quad(packed, w_bit, group_size)
    if layout == "tpu_tiled":
        return unpack_rows_tpu_tiled(packed, w_bit, group_size)
    if layout != "gptq":
        raise ValueError(f"unknown packed layout {layout!r}")
    return unpack_rows(packed, w_bit)


# ---------------------------------------------------------------------------
# Sign bits of binary tensors along the last axis: (..., K) <-> int32 (..., K / 32)
# ---------------------------------------------------------------------------


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """Pack signs along the last axis: bit j of word w is set iff
    ``x[..., 32 w + j] >= 0`` (NaN packs as -1).  ``K`` must be a multiple
    of 32 (see :func:`pad_to_multiple`)."""
    *lead, k = x.shape
    if k % 32 != 0:
        raise ValueError(f"last axis {k} must be a multiple of 32")
    bits = (x >= 0).to(torch.int64).reshape(*lead, k // 32, 32)
    return _to_int32((bits << torch.arange(32, device=x.device)).sum(dim=-1))


def unpack_signs(packed: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_signs`: int32 ``(..., Kw)`` → ±1 ``(..., 32 Kw)``."""
    *lead, kw = packed.shape
    bits = (_words_u32(packed)[..., None] >> torch.arange(32, device=packed.device)) & 1
    return (bits * 2 - 1).reshape(*lead, kw * 32).to(dtype)


def pad_to_multiple(
    x: torch.Tensor, axis: int, multiple: int, value=0
) -> Tuple[torch.Tensor, int]:
    """Pad ``axis`` of ``x`` with ``value`` up to the next multiple of
    ``multiple``; returns ``(padded, pad)``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x, 0
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=axis), pad


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its low 32 bits), as int64."""
    v = _words_u32(words)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _LOW32) >> 24
