"""Quantized layers (the MPQ linear and the fp projection)."""
