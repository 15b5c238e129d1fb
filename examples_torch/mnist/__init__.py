"""MNIST twins: the low-bit MLP and the bring-your-own-trainer flow."""
