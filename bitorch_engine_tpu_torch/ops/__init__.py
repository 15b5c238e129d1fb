"""Quantized ops: packing, quantization, the MPQ linear and the CUDA kernels."""
