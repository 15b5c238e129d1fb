"""Quantized convolution layers (the counterpart of ``layers/conv.py``):
``BinaryConv2d`` and ``Q4Conv2d``, NHWC activations, HWIO weights held as
a ``BinaryQTensor`` / ``IntQTensor`` (buffers ``data``, ``scale_w``), and a
learnable activation scale ``scale_a`` that
``layers.linear.init_activation_scales`` sets from a sample batch."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..ops.conv import binary_conv2d, qat_conv2d
from ..ops.quant import Q4_DIVISOR, Q8_DIVISOR, init_binary_weight, init_nbit_weight
from ..qtensor import BinaryQTensor, IntQTensor
from .linear import DataInit, QuantLayer, _mean_abs


def kaiming_conv(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform ±sqrt(3 / fan_in) with fan_in = KH·KW·C (the JAX package's
    ``_kaiming_conv``)."""
    bound = math.sqrt(3.0) / math.sqrt(shape[0] * shape[1] * shape[2])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-bound, bound, generator=generator)


class _QuantConv(DataInit, QuantLayer):
    _BUFFERS = ("data", "scale_w")

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int], padding: str, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator], qweight):
        super().__init__()
        if qweight is not None and device is None:
            device = qweight.device
        device = resolve_device(device)
        self.strides, self.padding = tuple(strides), padding
        if qweight is None:
            kh, kw = kernel_size
            w = kaiming_conv((kh, kw, in_channels, features), generator, device)
            qweight = self._quantize(w)
        self.set_qweight(qweight)
        self.scale_a = nn.Parameter(torch.ones((), dtype=dtype, device=device))

    def _quantize_flat(self, w2d: torch.Tensor):
        raise NotImplementedError

    def _quantize(self, w: torch.Tensor):
        """Quantize the HWIO weight as the ``(O, KH·KW·C)`` matrix, as the
        JAX package does."""
        kh, kw, c, o = w.shape
        flat = self._quantize_flat(w.reshape(-1, o).T)
        return flat.replace(data=flat.data.T.reshape(kh, kw, c, o).contiguous())


class BinaryConv2d(_QuantConv):
    """1-bit conv: ``binary_conv2d(x, qweight, scale_a)``; ``scale_a`` =
    ``2 mean|x|`` after ``init_activation_scales``."""

    _RECORD = BinaryQTensor
    _STATIC = ("packed", "in_features")

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 qweight: Optional[BinaryQTensor] = None):
        super().__init__(in_channels, features, kernel_size, strides, padding, dtype, device,
                         generator, qweight)

    def _quantize_flat(self, w2d):
        return init_binary_weight(w2d).replace(in_features=-1)

    def init_from_input(self, x: torch.Tensor) -> None:
        self.scale_a.copy_(2.0 * _mean_abs(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._data_init(x)
        return binary_conv2d(x, self.qweight, self.scale_a, self.strides, self.padding)


class Q4Conv2d(_QuantConv):
    """n-bit QAT conv (4 bits by default): ``qat_conv2d(x, qweight,
    scale_a)``; ``scale_a`` = ``2 mean|x| / divisor`` after
    ``init_activation_scales``."""

    _RECORD = IntQTensor
    _STATIC = ("w_bit",)

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding: str = "SAME", w_bit: int = 4,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 qweight: Optional[IntQTensor] = None):
        self.w_bit = w_bit if qweight is None else qweight.w_bit
        super().__init__(in_channels, features, kernel_size, strides, padding, dtype, device,
                         generator, qweight)

    def _quantize_flat(self, w2d):
        return init_nbit_weight(w2d, self.w_bit)

    def init_from_input(self, x: torch.Tensor) -> None:
        divisor = Q4_DIVISOR if self._w_bit == 4 else Q8_DIVISOR
        self.scale_a.copy_(2.0 * _mean_abs(x) / divisor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._data_init(x)
        return qat_conv2d(x, self.qweight, self.scale_a, self.strides, self.padding)
