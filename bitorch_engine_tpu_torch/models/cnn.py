"""The quantized conv net (CIFAR-class tasks), the counterpart of
``bitorch_engine_tpu/models/cnn.py``: fp ``Conv`` → LayerNorm → hardtanh,
then per width after the first a quantized 3x3 conv (binary at 1 bit,
int4 QAT at 4) → LayerNorm → hardtanh, a 2x2 max pool after every second
one, a global mean over H and W, and an fp ``Dense`` head.  NHWC inputs.

Submodules carry the flax names (``Conv_0``, ``LayerNorm_{i}``,
``qconv_{i}``, ``Dense_0``), so the JAX package's parameter tree loads one
to one.  Unlike the JAX package's, the binary net trains: its conv
weights' grad shadows have the weights' full shape (see
``qtensor.BinaryQTensor``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..layers.basic import Conv, Dense, LayerNorm
from ..layers.conv import BinaryConv2d, Q4Conv2d
from ..layers.linear import init_activation_scales


class QuantConvNet(nn.Module):
    """``bits`` in {1, 4}; ``widths`` the conv widths (the first fp).
    Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default ``cuda``); with ``sample`` (NHWC inputs) the
    quantized convs' activation scales are initialised from it."""

    def __init__(self, in_channels: int = 3, n_classes: int = 10, bits: int = 1,
                 widths: Sequence[int] = (64, 128, 128, 256), device=None, seed: int = 0,
                 sample: Optional[torch.Tensor] = None):
        super().__init__()
        if bits not in (1, 4):
            raise ValueError(f"unsupported bits: {bits}")
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        quant_conv = BinaryConv2d if bits == 1 else Q4Conv2d
        self.widths = tuple(widths)
        self.Conv_0 = Conv(in_channels, widths[0], use_bias=False, device=device, generator=gen)
        self.LayerNorm_0 = LayerNorm(widths[0], device=device)
        for i, (c, w) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"qconv_{i}", quant_conv(c, w, device=device, generator=gen))
            self.add_module(f"LayerNorm_{i + 1}", LayerNorm(w, device=device))
        self.Dense_0 = Dense(widths[-1], n_classes, device=device, generator=gen)
        if sample is not None:
            init_activation_scales(self, sample.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.hardtanh(self.LayerNorm_0(self.Conv_0(x)))
        for i in range(len(self.widths) - 1):
            x = getattr(self, f"qconv_{i}")(x)
            x = F.hardtanh(getattr(self, f"LayerNorm_{i + 1}")(x))
            if i % 2 == 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return self.Dense_0(x.mean(dim=(1, 2)))
