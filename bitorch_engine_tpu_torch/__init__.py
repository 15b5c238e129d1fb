"""bitorch_engine_tpu_torch: the PyTorch / CUDA port of bitorch_engine_tpu.

A second package beside the JAX one, which stays the reference.  It runs the
Llama serving path (w4 MPQ or mixed-bit MBWQ projections, the A8 int8
activation regime for sub-4-bit weights, int8 KV cache, prefill and greedy
decode, paged KV and continuous batching), quantized-weight training with
DiodeMix, and the binary / QAT family (``QuantMLP``, ``QuantConvNet``, the
packed 1-bit MLP) on an NVIDIA Hopper GPU through hand-written CUDA kernels
(``ops/cuda``, sources in ``csrc``), and runs the
same math as plain PyTorch on the CPU when the caller asks for
``device="cpu"``.

It imports ``torch`` and numpy only, never JAX or the JAX package.
"""

from .device import require_cuda, resolve_device
from .qtensor import BinaryEmbeddingQTensor, BinaryQTensor, IntQTensor, MBWQTensor, MPQTensor

__all__ = ["BinaryEmbeddingQTensor", "BinaryQTensor", "IntQTensor", "MBWQTensor", "MPQTensor",
           "require_cuda", "resolve_device"]
