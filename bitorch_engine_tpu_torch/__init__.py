"""bitorch_engine_tpu_torch: the PyTorch / CUDA port of bitorch_engine_tpu.

A second package beside the JAX one, which stays the reference.  It runs the
Llama serving path (w4 MPQ or mixed-bit MBWQ projections, the A8 int8
activation regime for sub-4-bit weights, int8 KV cache, prefill and greedy
decode, paged KV and continuous batching) on an NVIDIA Hopper GPU through
hand-written CUDA kernels (``ops/cuda``, sources in ``csrc``), and runs the
same math as plain PyTorch on the CPU when the caller asks for
``device="cpu"``.

It imports ``torch`` and numpy only, never JAX or the JAX package.
"""

from .device import require_cuda, resolve_device
from .qtensor import MBWQTensor, MPQTensor

__all__ = ["MBWQTensor", "MPQTensor", "require_cuda", "resolve_device"]
