"""The CIFAR-10 twin: a binary / 4-bit conv net."""
