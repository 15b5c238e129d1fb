"""PyTorch twins of ``examples/``: the same scripts, flags and output on
the port (``bitorch_engine_tpu_torch``).  Each runs on the card unless given
``--cpu`` and has ``main(argv=None)``, which returns the numbers it printed.

    python examples_torch/mnist/train_mnist.py --bits 1 --epochs 3 [--cpu]
    python -m examples_torch.llm.serve --demo
"""
