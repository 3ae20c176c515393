"""PyTorch + CUDA port of the MNIST models' serving and training paths.

A second package beside the JAX reference ``pytorch_mnist_ddp_tpu``: the
same models (the CNN and the ViT), checkpoints, serving contract and
training CLIs, written in PyTorch, with
the JAX package's TPU kernels replaced by kernels written by hand for
Hopper (``csrc/``).  It imports ``torch``, ``numpy`` and the standard
library only — never ``jax``, ``flax`` or the JAX package; what it needs
from there it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the CLI); see :func:`.device.resolve_device`.
"""
