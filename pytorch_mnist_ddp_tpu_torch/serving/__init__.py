"""Inference serving: engine, micro-batcher, HTTP endpoint and CLI
(``python -m pytorch_mnist_ddp_tpu_torch.serving``)."""
