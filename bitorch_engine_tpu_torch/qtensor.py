"""Quantized-weight records as dataclasses of tensors.

The counterpart of ``bitorch_engine_tpu/qtensor.py``: ``MPQTensor`` (the
group-quantized weight) and ``MBWQTensor`` (the mixed-bit weight, a tuple of
per-bit-width ``MPQTensor`` segments), and the training-mode helpers
:func:`with_grad_shadow` / :func:`without_grad_shadow`.  The binary and
n-bit QAT records come with the slices that use them.
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


def with_grad_shadow(qt):
    """Attach a zero f32 grad shadow of the logical weight shape (training
    mode), on the tensor's device."""
    return qt.replace(grad_shadow=torch.zeros(qt.logical_shape, dtype=torch.float32,
                                              device=qt.device))


def without_grad_shadow(qt):
    """Drop the grad shadow (inference mode: no memory overhead)."""
    return qt.replace(grad_shadow=None)
