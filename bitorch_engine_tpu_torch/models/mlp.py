"""The binary / low-bit MLP (MNIST-class tasks), the counterpart of
``bitorch_engine_tpu/models/mlp.py``: fp ``Dense`` → hardtanh → quantized
hidden linear (1, 4 or 8 bits) → hardtanh → fp ``Dense`` head.

Submodules carry the flax auto-names (``Dense_0``, ``BinaryLinear_0`` /
``Q4Linear_0`` / ``Q8Linear_0``, ``Dense_1``), so the JAX package's
parameter tree loads one to one (``utils.convert.load_jax_params``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..layers.basic import Dense
from ..layers.linear import BinaryLinear, Q4Linear, Q8Linear, init_activation_scales

QUANT_LINEARS = {1: BinaryLinear, 4: Q4Linear, 8: Q8Linear}


class QuantMLP(nn.Module):
    """``Dense(hidden)`` → hardtanh → ``{Binary,Q4,Q8}Linear(hidden)`` →
    hardtanh → ``Dense(n_classes)`` on flattened inputs.

    Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default ``cuda``, which raises without a GPU; pass
    ``device="cpu"`` for the plain path).  With ``sample`` (a batch of
    inputs) the quantized layer's activation scale is initialised from it
    (:func:`init_activation_scales`), as flax's ``init`` does."""

    def __init__(self, in_features: int = 784, hidden: int = 1024, n_classes: int = 10,
                 bits: int = 1, device=None, seed: int = 0,
                 sample: Optional[torch.Tensor] = None):
        super().__init__()
        if bits not in QUANT_LINEARS:
            raise ValueError(f"unsupported bits: {bits}")
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.bits = bits
        self.Dense_0 = Dense(in_features, hidden, device=device, generator=gen)
        quant = QUANT_LINEARS[bits](hidden, hidden, device=device, generator=gen)
        self.add_module(f"{type(quant).__name__}_0", quant)
        self.Dense_1 = Dense(hidden, n_classes, device=device, generator=gen)
        if sample is not None:
            init_activation_scales(self, sample.to(device))

    @property
    def quant(self) -> nn.Module:
        return getattr(self, f"{QUANT_LINEARS[self.bits].__name__}_0")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.hardtanh(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(F.hardtanh(self.quant(x)))
