"""Quantized-weight records as dataclasses of tensors.

The counterpart of ``bitorch_engine_tpu/qtensor.py``: ``MPQTensor`` (the
group-quantized weight), ``MBWQTensor`` (the mixed-bit weight, a tuple of
per-bit-width ``MPQTensor`` segments), the QAT records ``BinaryQTensor``
(1-bit) and ``IntQTensor`` (4/8-bit), the packed ``BinaryEmbeddingQTensor``,
and the training-mode helpers :func:`with_grad_shadow` /
:func:`without_grad_shadow`.

Packed sign words are int32, bit-identical to the JAX package's uint32
words (see ``ops/packing.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MPQTensor:
    """Group-quantized (GPTQ/GBA-style) packed weight, logical shape (K, N).

    * ``packed``: int32 ``(K // 32 * w_bit, N)``; each word holds
      ``32 // w_bit`` K-rows, value ``j`` at bit offset ``j * w_bit``.  Row
      order per ``layout``: ``"gptq"`` (value j of word r is row
      ``r * ppw + j``) is the checkpoint order and the port's kernel
      layout; ``"tpu_tiled"``, ``"tpu_pair"`` and ``"tpu_quad"`` are the
      JAX package's TPU layouts, which the port reads (to load relayouted
      parameters) and never writes.
    * ``scales``: float ``(G, N)``, ``G = ceil(K / group_size)``.
    * ``zeros``: asym → packed int32 ``(G, N // 32 * w_bit)`` holding
      ``zero - 1`` (GPTQ convention); sym → float ``(G, N)`` subtractive
      zeros, ``w = q * s - z``.
    * ``g_idx``: optional int32 ``(K,)`` row → group map (act-order GPTQ).
    * ``q_perm``: optional int32 ``(K,)`` row permutation restored at
      dequantize time.
    * ``code_bits``: true quantization width when below the ``w_bit``
      container; ``act_bits``: the decode regime's activation width, 16
      (bf16 activations) or 8 (per-token int8 activations against the
      codes, for ``w_bit`` in 1/2/4); ``zeros_mid``: zeros are exactly
      ``2**(bits-1) * scales``.
    * ``grad_shadow``: training mode's f32 ``(K, N)`` weight-gradient slot
      (the layer's ``nn.Parameter``, whose ``.grad`` receives ``xᵀ g``), or
      ``None`` for inference.
    """

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    g_idx: Optional[torch.Tensor] = None
    q_perm: Optional[torch.Tensor] = None
    w_bit: int = 4
    group_size: int = 128
    asym: bool = False
    grad_shadow: Optional[torch.Tensor] = None
    code_bits: Optional[int] = None
    layout: str = "gptq"
    act_bits: int = 16
    zeros_mid: bool = False

    @property
    def in_features(self) -> int:
        return self.packed.shape[0] * 32 // self.w_bit

    @property
    def out_features(self) -> int:
        return self.packed.shape[1]

    @property
    def logical_shape(self) -> Tuple[int, int]:
        return (self.in_features, self.out_features)

    @property
    def quant_bits(self) -> int:
        """True quantization width (at most the container ``w_bit``)."""
        return self.code_bits if self.code_bits is not None else self.w_bit

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def replace(self, **changes) -> "MPQTensor":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "MPQTensor":
        def mv(t):
            return None if t is None else t.to(device)

        return self.replace(
            packed=mv(self.packed), scales=mv(self.scales), zeros=mv(self.zeros),
            g_idx=mv(self.g_idx), q_perm=mv(self.q_perm),
            grad_shadow=mv(self.grad_shadow),
        )


@dataclasses.dataclass(frozen=True)
class MBWQTensor:
    """Mixed-bit-width (channel-mix) weight, logical shape (K, N).

    Rows of the weight are quantized at different bit widths and sorted
    into contiguous per-bit segments (descending width); each segment is a
    uniform :class:`MPQTensor` over its rows.

    * ``q_perm``: int32 ``(K,)``, logical input channel of each
      segment-sorted row; the forward gathers the activations by it.
    * ``channel_scale``: optional f32 ``(K,)`` per-input-channel pre-scale
      of the activations.
    * ``block_perm``: int32 ``(K / perm_block,)``, ``q_perm[::perm_block] //
      perm_block``; with ``perm_block > 0`` the permutation moves whole
      blocks of that many rows and the forward gathers blocks.
    * ``grad_shadow``: training mode's f32 ``(K, N)`` weight-gradient slot
      of the logical weight (the segments carry none), or ``None``.
    """

    segments: Tuple[MPQTensor, ...]
    q_perm: Optional[torch.Tensor] = None
    channel_scale: Optional[torch.Tensor] = None
    grad_shadow: Optional[torch.Tensor] = None
    block_perm: Optional[torch.Tensor] = None
    perm_block: int = 0

    @property
    def in_features(self) -> int:
        return sum(seg.in_features for seg in self.segments)

    @property
    def out_features(self) -> int:
        return self.segments[0].out_features

    @property
    def logical_shape(self) -> Tuple[int, int]:
        return (self.in_features, self.out_features)

    @property
    def bit_widths(self) -> Tuple[int, ...]:
        """True quantization width of each segment."""
        return tuple(seg.quant_bits for seg in self.segments)

    @property
    def device(self) -> torch.device:
        return self.segments[0].device

    def replace(self, **changes) -> "MBWQTensor":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class BinaryQTensor:
    """1-bit weight, in one of two forms:

    * QAT (``packed=False``): ``data`` int8 in [-127, 127] (the sign is the
      weight; the magnitude is the initial quantized value), ``(N, K)`` for
      a linear layer, ``(KH, KW, C, O)`` (HWIO) for a conv;
    * inference (``packed=True``): ``data`` int32 ``(N, ceil(K / 32))``,
      sign bits packed along K (bit j of word w is element ``32 w + j``,
      set iff it is >= 0; the pad bits are 0).

    ``scale_w`` is the f32 layer-wise scale (mean |w|); ``in_features`` the
    logical K of a packed weight.

    ``logical_shape`` is ``data``'s own shape for the QAT form.  The JAX
    package gives a conv weight ``(KH, KW)`` there, so its grad shadow does
    not fit the conv's weight gradient and its binary conv net cannot train;
    the port's shadow has the conv weight's full shape.
    """

    data: torch.Tensor
    scale_w: torch.Tensor
    grad_shadow: Optional[torch.Tensor] = None
    packed: bool = False
    in_features: int = -1

    @property
    def out_features(self) -> int:
        return self.data.shape[0]

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        if not self.packed:
            return tuple(self.data.shape)
        k = self.in_features if self.in_features >= 0 else self.data.shape[1] * 32
        return (self.data.shape[0], k)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def replace(self, **changes) -> "BinaryQTensor":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class IntQTensor:
    """4/8-bit QAT weight: ``data`` int8 codes in ``[-2^(b-1), 2^(b-1) - 1]``
    (``(N, K)``, or HWIO for a conv) with ``w ≈ data * scale_w``; DiodeMix
    requantizes it after every step."""

    data: torch.Tensor
    scale_w: torch.Tensor
    w_bit: int = 4
    grad_shadow: Optional[torch.Tensor] = None

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def replace(self, **changes) -> "IntQTensor":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class BinaryEmbeddingQTensor:
    """Bit-packed binary embedding table: ``data`` int32 ``(vocab,
    ceil(dim / 32))`` sign words, ``scale`` f32 ``(vocab, 1)`` per-row
    scale.  In training mode ``grad_shadow`` is the dense f32 ``(vocab,
    dim)`` table gradient (rows not looked up are exactly 0)."""

    data: torch.Tensor
    scale: torch.Tensor
    grad_shadow: Optional[torch.Tensor] = None
    dim: int = -1

    @property
    def vocab_size(self) -> int:
        return self.data.shape[0]

    @property
    def logical_shape(self) -> Tuple[int, int]:
        d = self.dim if self.dim > 0 else self.data.shape[1] * 32
        return (self.data.shape[0], d)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def replace(self, **changes) -> "BinaryEmbeddingQTensor":
        return dataclasses.replace(self, **changes)


def with_grad_shadow(qt):
    """Attach a zero f32 grad shadow of the logical weight shape (training
    mode), on the tensor's device."""
    return qt.replace(grad_shadow=torch.zeros(qt.logical_shape, dtype=torch.float32,
                                              device=qt.device))


def without_grad_shadow(qt):
    """Drop the grad shadow (inference mode: no memory overhead)."""
    return qt.replace(grad_shadow=None)
