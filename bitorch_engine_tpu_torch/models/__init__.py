"""Models: the Llama family and generation."""
