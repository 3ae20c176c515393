"""Kernels written by hand for Hopper with their plain PyTorch versions;
attention, the loss, the Adadelta update and the lr schedule."""
