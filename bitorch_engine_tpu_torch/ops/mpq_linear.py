"""MPQ weight-only linear, forward (the counterpart of ``ops/mpq_linear.py``).

Two regimes, as in the JAX package:

* decode (``m <= MAX_FUSED_ROWS`` rows on the card): the fused
  dequant-matmul kernel reads the packed words once and never writes the
  weight out;
* prefill (more rows): the streaming dequant kernel reconstructs the bf16
  weight, and ``torch.matmul`` runs the product (the JAX package leaves that
  product to XLA).

On the CPU every ``m`` takes the second form with the plain dequantize,
exactly as the JAX package does off the TPU: dequantize to ``x.dtype``, an
f32-accumulated product, cast.  The regime is chosen from the device and
the shape up front; nothing catches a kernel's error to fall back.  The
backward comes with the training slice.
"""

from __future__ import annotations

import torch

from ..qtensor import MPQTensor
from .cuda.dequant_matmul import dequant_mpq, mpq_matmul
from .quant import dequantize_mpq

# Crossover between the two regimes, measured on a TPU v5e by the JAX
# package; re-measuring it on the H100 is later work.
MAX_FUSED_ROWS = 512


def reconstruct_weight(qt: MPQTensor, dtype: torch.dtype) -> torch.Tensor:
    """Logical fp weight ``(K, N)``: kernel 2 on the card (which raises on
    act-order ``g_idx`` / ``q_perm`` tensors), the plain dequantize on the
    CPU."""
    if qt.device.type != "cuda":
        return dequantize_mpq(qt, dtype)
    return dequant_mpq(qt, dtype)


def mpq_linear(x: torch.Tensor, qt: MPQTensor) -> torch.Tensor:
    """``x (..., K) @ dequant(qt)`` → ``(..., N)`` in ``x.dtype``."""
    if qt.act_bits != 16:
        raise NotImplementedError("act_bits=8 (the A8 decode regime) arrives with the sub-4-bit slice")
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2d = x.reshape(-1, k)
    if x.device.type == "cuda" and x2d.shape[0] <= MAX_FUSED_ROWS:
        out = mpq_matmul(x2d.contiguous(), qt)
    else:
        w = reconstruct_weight(qt, x.dtype)
        out = torch.matmul(x2d, w)
    return out.reshape(*lead, -1)
