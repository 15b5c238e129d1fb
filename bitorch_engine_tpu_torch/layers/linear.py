"""Quantized linear modules (the counterpart of ``layers/linear.py``).

``MPQLinear`` holds its :class:`MPQTensor` as buffers (``packed``,
``scales``, ``zeros`` and the optional ``g_idx`` / ``q_perm``) so that
``.to()``, ``state_dict()`` and ``named_buffers()`` see them; the static
fields (bit width, group size, layout, ...) are plain attributes.
``MBWQLinear`` holds each segment of its :class:`MBWQTensor` in an
``MPQLinear`` of ``segments`` (so whatever walks the model's ``MPQLinear``
modules, such as ``utils.convert.prepare_params_for_cuda``, reaches the
segments too) and the permutation and channel scale as buffers.

In training mode (``utils.convert.prepare_for_training``) a layer carries
its weight's f32 ``grad_shadow`` as an ``nn.Parameter`` of the logical
``(K, N)`` shape: the quantized linear's autograd Function takes it as an
input, so its ``.grad`` is the JAX package's ``grad_shadow`` cotangent,
``xᵀ g``.  The binary and n-bit QAT layers and fp projections come with
their slices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.mbwq_linear import mbwq_linear, quantize_mbwq
from ..ops.mpq_linear import mpq_linear
from ..ops.quant import quantize_mpq
from ..qtensor import MBWQTensor, MPQTensor

_TENSOR_FIELDS = ("packed", "scales", "zeros", "g_idx", "q_perm")
_STATIC_FIELDS = ("w_bit", "group_size", "asym", "code_bits", "layout", "act_bits", "zeros_mid")


def _set_shadow(module: nn.Module, shadow: Optional[torch.Tensor]) -> None:
    """Hold ``shadow`` as the module's ``grad_shadow`` parameter (or none)."""
    if shadow is not None and not isinstance(shadow, nn.Parameter):
        shadow = nn.Parameter(shadow)
    module.grad_shadow = shadow


def kaiming_uniform(
    shape, generator: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    """Kaiming-uniform fan-in init (``a = sqrt(5)``), fan-in = ``shape[1]``."""
    bound = 1.0 / math.sqrt(shape[1]) * math.sqrt(3.0)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-bound, bound, generator=generator)


class MPQLinear(nn.Module):
    """Weight-only group-quantized linear: ``x @ dequant(qweight) [+ bias]``.

    Without ``qweight`` the constructor quantizes a random Kaiming-uniform
    weight (tests and benchmarks) on ``device``, which defaults to ``cuda``
    and raises without a GPU (pass ``device="cpu"`` for the plain path);
    with ``qweight`` the layer lives where that tensor does.
    :meth:`set_qweight` installs a loaded or prepared tensor.  ``out_slice``
    keeps only the first outputs of a padded projection
    (``LlamaConfig.proj_pad_to``).
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        w_bit: int = 4,
        group_size: int = 128,
        asym: bool = False,
        use_bias: bool = False,
        mid_sym: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
        out_slice: Optional[int] = None,
        qweight: Optional[MPQTensor] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.out_slice = out_slice
        self.register_parameter("grad_shadow", None)
        if qweight is not None and device is None:
            device = qweight.device
        device = resolve_device(device)
        if qweight is None:
            gs = group_size if group_size > 0 else in_features
            w = kaiming_uniform((out_features, in_features), generator, device).T
            qweight = quantize_mpq(w, w_bit=w_bit, group_size=gs, asym=asym, mid_sym=mid_sym)
        self.set_qweight(qweight)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(
                torch.zeros(out_features, dtype=dtype, device=device), requires_grad=False
            )

    @property
    def qweight(self) -> MPQTensor:
        return MPQTensor(
            **{f: getattr(self, f) for f in _TENSOR_FIELDS},
            **{f: getattr(self, "_" + f) for f in _STATIC_FIELDS},
            grad_shadow=self.grad_shadow,
        )

    def set_qweight(self, qt: MPQTensor) -> None:
        for f in _TENSOR_FIELDS:
            self.register_buffer(f, getattr(qt, f))
        for f in _STATIC_FIELDS:
            setattr(self, "_" + f, getattr(qt, f))
        _set_shadow(self, qt.grad_shadow)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = mpq_linear(x.to(self.dtype), self.qweight)
        if self.bias is not None:
            out = out + self.bias
        if self.out_slice is not None:
            out = out[..., : self.out_slice]
        return out


# the JAX package's MBWQLinear default: 75% of the rows at w4, 25% at w2, g64
DEFAULT_MBWQ_STRATEGY = {"bits": [4, 2], "bits_prop": [0.75, 0.25], "group_size": {"4": 64, "2": 64}}


class MBWQLinear(nn.Module):
    """Channel-mixed-bit-width linear: ``(x · channel_scale) @ dequant(qweight)``.

    ``strategy`` is the reference's per-projection dict (``ops.mbwq_linear
    .strategy_dict`` builds it from ``LlamaConfig.mbwq_strategy``).  Without
    ``qweight`` the constructor quantizes a random Kaiming-uniform weight on
    ``device`` (default ``cuda``, which raises without a GPU; pass
    ``device="cpu"`` for the plain path), with an all-ones ``channel_scale``
    when ``use_channel_scale``; with ``qweight`` the layer lives where that
    tensor does.  ``out_slice`` keeps only the first outputs of a padded
    projection (``LlamaConfig.proj_pad_to``).  No bias, as in the JAX
    package."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        strategy: Optional[dict] = None,
        use_channel_scale: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
        out_slice: Optional[int] = None,
        qweight: Optional[MBWQTensor] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.out_slice = out_slice
        self.register_parameter("grad_shadow", None)
        if qweight is not None and device is None:
            device = qweight.device
        device = resolve_device(device)
        if qweight is None:
            w = kaiming_uniform((out_features, in_features), generator, device).T
            cs = torch.ones(in_features, device=device) if use_channel_scale else None
            qweight = quantize_mbwq(w, strategy or DEFAULT_MBWQ_STRATEGY, channel_scale=cs)
        self.set_qweight(qweight)

    @property
    def qweight(self) -> MBWQTensor:
        return MBWQTensor(
            segments=tuple(seg.qweight for seg in self.segments), q_perm=self.q_perm,
            channel_scale=self.channel_scale, block_perm=self.block_perm,
            perm_block=self._perm_block, grad_shadow=self.grad_shadow,
        )

    def set_qweight(self, qt: MBWQTensor) -> None:
        self.segments = nn.ModuleList(
            MPQLinear(s.in_features, s.out_features, dtype=self.dtype, qweight=s)
            for s in qt.segments
        )
        for f in ("q_perm", "channel_scale", "block_perm"):
            self.register_buffer(f, getattr(qt, f))
        self._perm_block = qt.perm_block
        _set_shadow(self, qt.grad_shadow)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = mbwq_linear(x.to(self.dtype), self.qweight)
        if self.out_slice is not None:
            out = out[..., : self.out_slice]
        return out
