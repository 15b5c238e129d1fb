"""LLM twins: quantize-and-generate, continuous-batching serving, fine-tuning."""
