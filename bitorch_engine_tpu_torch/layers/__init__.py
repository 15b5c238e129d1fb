"""Quantized layers: the MPQ / MBWQ linears, the binary and n-bit QAT
linears, convs, embeddings and attention, and the flax-named fp layers."""
