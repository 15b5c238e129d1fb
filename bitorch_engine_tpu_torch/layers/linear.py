"""Quantized linear modules (the counterpart of ``layers/linear.py``).

``MPQLinear`` holds its :class:`MPQTensor` as buffers (``packed``,
``scales``, ``zeros`` and the optional ``g_idx`` / ``q_perm``) so that
``.to()``, ``state_dict()`` and ``named_buffers()`` see them; the static
fields (bit width, group size, layout, ...) are plain attributes.
``MBWQLinear`` holds each segment of its :class:`MBWQTensor` in an
``MPQLinear`` of ``segments`` (so whatever walks the model's ``MPQLinear``
modules, such as ``utils.convert.prepare_params_for_cuda``, reaches the
segments too) and the permutation and channel scale as buffers.

The QAT layers ``BinaryLinear``, ``Q4Linear`` and ``Q8Linear`` hold a
``BinaryQTensor`` / ``IntQTensor`` the same way (buffers ``data`` and
``scale_w``) beside their fp parameters ``scale_a`` (the learnable
activation scale) and ``bias_a`` (the learnable input shift), named as the
JAX package's flax parameters.  flax initialises ``scale_a`` from the data
in its init-time forward; the port does it explicitly:
:func:`init_activation_scales` runs one forward of a sample batch in which
each such layer first sets its scale from its own input.

In training mode (``utils.convert.prepare_for_training``) a layer carries
its weight's f32 ``grad_shadow`` as an ``nn.Parameter`` of the logical
shape: the quantized op's autograd Function takes it as an input, so its
``.grad`` is the JAX package's ``grad_shadow`` cotangent.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.binary_linear import binary_linear
from ..ops.mbwq_linear import mbwq_linear, quantize_mbwq
from ..ops.mpq_linear import mpq_linear
from ..ops.qat_linear import qat_linear
from ..ops.quant import Q4_DIVISOR, Q8_DIVISOR, init_binary_weight, init_nbit_weight, quantize_mpq
from ..qtensor import BinaryQTensor, IntQTensor, MBWQTensor, MPQTensor


def _set_shadow(module: nn.Module, shadow: Optional[torch.Tensor]) -> None:
    """Hold ``shadow`` as the module's ``grad_shadow`` parameter (or none)."""
    if shadow is not None and not isinstance(shadow, nn.Parameter):
        shadow = nn.Parameter(shadow)
    module.grad_shadow = shadow


class QuantLayer(nn.Module):
    """A layer whose weight is one quantized record (``_RECORD``): its
    tensor fields ``_BUFFERS`` as buffers, its static fields ``_STATIC`` as
    ``_``-prefixed attributes, its grad shadow as the ``grad_shadow``
    parameter (or ``None``)."""

    _RECORD: type
    _BUFFERS: tuple
    _STATIC: tuple

    def __init__(self):
        super().__init__()
        self.register_parameter("grad_shadow", None)

    @property
    def qweight(self):
        return self._RECORD(
            **{f: getattr(self, f) for f in self._BUFFERS},
            **{f: getattr(self, "_" + f) for f in self._STATIC},
            grad_shadow=self.grad_shadow,
        )

    def set_qweight(self, qt) -> None:
        for f in self._BUFFERS:
            self.register_buffer(f, getattr(qt, f))
        for f in self._STATIC:
            setattr(self, "_" + f, getattr(qt, f))
        _set_shadow(self, qt.grad_shadow)


class DataInit:
    """Mixin of a layer with parameters initialised from its input:
    ``init_from_input(x)`` sets them; ``forward`` calls :meth:`_data_init`
    first, which does so while :func:`init_activation_scales` runs."""

    _calibrating = False

    def _data_init(self, *inputs) -> None:
        if self._calibrating:
            with torch.no_grad():
                self.init_from_input(*inputs)


@torch.no_grad()
def init_activation_scales(model: nn.Module, *sample) -> nn.Module:
    """Run ``model(*sample)`` once with every data-initialised layer setting
    its parameters from its own input before using them (the counterpart of
    flax's init-time forward).  Returns the model."""
    mods = [m for m in model.modules() if isinstance(m, DataInit)]
    for m in mods:
        m._calibrating = True
    try:
        model(*sample)
    finally:
        for m in mods:
            m._calibrating = False
    return model


def _mean_abs(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().sum() / x.numel()


def kaiming_uniform(
    shape, generator: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    """Kaiming-uniform fan-in init (``a = sqrt(5)``), fan-in = ``shape[1]``."""
    bound = 1.0 / math.sqrt(shape[1]) * math.sqrt(3.0)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-bound, bound, generator=generator)


class MPQLinear(QuantLayer):
    """Weight-only group-quantized linear: ``x @ dequant(qweight) [+ bias]``.

    Without ``qweight`` the constructor quantizes a random Kaiming-uniform
    weight (tests and benchmarks) on ``device``, which defaults to ``cuda``
    and raises without a GPU (pass ``device="cpu"`` for the plain path);
    with ``qweight`` the layer lives where that tensor does.
    :meth:`set_qweight` installs a loaded or prepared tensor.  ``out_slice``
    keeps only the first outputs of a padded projection
    (``LlamaConfig.proj_pad_to``).
    """

    _RECORD = MPQTensor
    _BUFFERS = ("packed", "scales", "zeros", "g_idx", "q_perm")
    _STATIC = ("w_bit", "group_size", "asym", "code_bits", "layout", "act_bits", "zeros_mid")

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


class _QATLinear(DataInit, QuantLayer):
    """A QAT linear's weight record beside its fp ``scale_a`` (1 until
    :func:`init_activation_scales`) and ``bias_a`` (0).  Without
    ``qweight`` the constructor quantizes a random Kaiming-uniform weight
    (``_quantize``) on ``device`` (default ``cuda``, which raises without a
    GPU)."""

    _BUFFERS = ("data", "scale_w")

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator], qweight):
        super().__init__()
        if qweight is not None and device is None:
            device = qweight.device
        device = resolve_device(device)
        if qweight is None:
            qweight = self._quantize(kaiming_uniform((out_features, in_features), generator, device))
        self.set_qweight(qweight)
        self.scale_a = nn.Parameter(torch.ones((), dtype=dtype, device=device))
        self.bias_a = nn.Parameter(torch.zeros(in_features, dtype=dtype, device=device))


class BinaryLinear(_QATLinear):
    """1-bit linear: ``binary_linear(x, qweight, scale_a, bias_a)``;
    :func:`init_activation_scales` sets ``scale_a`` to ``2 mean|x|``
    (``4 mean|x|`` when not ``symmetric``)."""

    _RECORD = BinaryQTensor
    _STATIC = ("packed", "in_features")

    def __init__(self, in_features: int, out_features: int, symmetric: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 qweight: Optional[BinaryQTensor] = None):
        self.symmetric = symmetric
        super().__init__(in_features, out_features, dtype, device, generator, qweight)

    def _quantize(self, w: torch.Tensor) -> BinaryQTensor:
        return init_binary_weight(w)

    def init_from_input(self, x: torch.Tensor) -> None:
        self.scale_a.copy_((2.0 if self.symmetric else 4.0) * _mean_abs(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._data_init(x)
        return binary_linear(x, self.qweight, self.scale_a, self.bias_a)


class NBitLinear(_QATLinear):
    """n-bit QAT linear: ``qat_linear(x + bias_a, qweight, scale_a)``;
    :func:`init_activation_scales` sets ``scale_a`` to ``2 mean|x| /
    divisor`` (5.6345 at 4 bits, 11.269 otherwise)."""

    _RECORD = IntQTensor
    _STATIC = ("w_bit",)
    w_bit = 4

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None,
                 qweight: Optional[IntQTensor] = None):
        super().__init__(in_features, out_features, dtype, device, generator, qweight)

    def _quantize(self, w: torch.Tensor) -> IntQTensor:
        return init_nbit_weight(w, self.w_bit)

    def init_from_input(self, x: torch.Tensor) -> None:
        divisor = Q4_DIVISOR if self._w_bit == 4 else Q8_DIVISOR
        self.scale_a.copy_(2.0 * _mean_abs(x) / divisor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._data_init(x)
        return qat_linear(x + self.bias_a, self.qweight, self.scale_a)


class Q4Linear(NBitLinear):
    """4-bit QAT linear (4-bit activations)."""

    w_bit = 4


class Q8Linear(NBitLinear):
    """8-bit QAT linear (8-bit activations)."""

    w_bit = 8
