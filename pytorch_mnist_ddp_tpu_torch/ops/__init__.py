"""Kernels written by hand for Hopper, with their plain PyTorch versions."""
