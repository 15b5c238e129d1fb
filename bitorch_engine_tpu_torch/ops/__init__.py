"""Quantized ops: packing, quantization, the MPQ / MBWQ linears, the binary
and QAT ops and the CUDA kernels."""
