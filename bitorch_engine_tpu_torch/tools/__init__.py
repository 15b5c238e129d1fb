"""Command-line tools: checkpoint quantization and inspection (``cli``) and
the perplexity gate (``ppl_gate``)."""
