"""MPQ weight-only linear, forward (the counterpart of ``ops/mpq_linear.py``).

Two regimes, as in the JAX package:

* decode (``m <= MAX_FUSED_ROWS`` rows): on the card the fused kernel reads
  the packed words once and never writes the weight out: kernel 1 for A16
  tensors (bf16 activations), kernel 5 for A8 tensors (``act_bits=8``:
  per-token int8 activations against the codes).  On the CPU an A8 tensor
  takes the JAX package's exact simulation of its A8 kernel (kernel 5's
  plain version), an A16 tensor the second form below;
* prefill (more rows, and every A16 ``m`` on the CPU): the weight is
  reconstructed in ``x.dtype`` (kernel 2 on the card, in either regime) and
  ``torch.matmul`` runs the product (the JAX package leaves that product to
  XLA).

The regime is chosen from the tensor, the device and the shape up front;
nothing catches a kernel's error to fall back.  The backward comes with the
training slice.
"""

from __future__ import annotations

import torch

from ..qtensor import MPQTensor
from .cuda.dequant_matmul import dequant_mpq, mpq_matmul
from .cuda.quad_matmul import mpq_matmul_a8
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
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2d = x.reshape(-1, k)
    small = x2d.shape[0] <= MAX_FUSED_ROWS
    if qt.act_bits == 8 and small:
        out = mpq_matmul_a8(x2d.contiguous(), qt)
    elif x.device.type == "cuda" and small:
        out = mpq_matmul(x2d.contiguous(), qt)
    else:
        w = reconstruct_weight(qt, x.dtype)
        out = torch.matmul(x2d, w)
    return out.reshape(*lead, -1)
