"""MNIST arrays, input transforms and the batch loader."""
