"""Models: the Llama family and generation, and the QAT models (``QuantMLP``,
``QuantConvNet``)."""
