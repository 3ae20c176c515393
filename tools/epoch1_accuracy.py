#!/usr/bin/env python3
"""Epoch-1 test accuracy of MNIST training at several seeds.

    python3 tools/epoch1_accuracy.py --seeds 1,2,3 --batch-size 200 --pallas-opt
    python3 tools/epoch1_accuracy.py --seeds 1,2,3,4,5 --batch-size 200 --device cpu
    python3 tools/epoch1_accuracy.py --seeds 1,2,3 --batch-size 200 --impl reference

One epoch per seed on the synthetic 60k/10k set (the dataset without IDX
files), with ``mnist.py``'s other defaults; prints one JSON line per seed
(seed, batch size, device, implementation, epoch-1 test accuracy, training
seconds) and, on the card, the card's name and power limit first.

``--impl port`` (the default) is one ``fit()`` of the port's ``mnist.py``.
``--impl reference`` is a witness that shares nothing with the port but
the data: the upstream PyTorch MNIST example's model (``nn.Conv2d``,
``nn.Dropout``, ``nn.Linear`` with their default initialisation, seeded by
``torch.manual_seed``), its loss and ``torch.optim.Adadelta``, shuffled by
``torch.randperm``, with the port's switches (TF32 off, deterministic
cuDNN).  Where an epoch ends depends on the seed: this is how the
accuracy floors of ``chip_smoke.py`` are set, and the witness says whether
a low reading is the training's nature or the port's fault.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist  # noqa: E402
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser  # noqa: E402
from pytorch_mnist_ddp_tpu_torch.trainer import fit  # noqa: E402

TEST_BATCH = 1000


class ReferenceNet(nn.Module):
    """The upstream example's ``Net``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 3, 1)
        self.conv2 = nn.Conv2d(32, 64, 3, 1)
        self.dropout1 = nn.Dropout(0.25)
        self.dropout2 = nn.Dropout(0.5)
        self.fc1 = nn.Linear(9216, 128)
        self.fc2 = nn.Linear(128, 10)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv2(F.relu(self.conv1(x)))), 2)
        x = F.relu(self.fc1(torch.flatten(self.dropout1(x), 1)))
        return F.log_softmax(self.fc2(self.dropout2(x)), dim=1)


@functools.lru_cache(maxsize=None)
def tensors(split: str, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``ToTensor`` then ``Normalize((0.1307,), (0.3081,))``, NCHW."""
    images, labels = synthetic_mnist(split)
    x = (torch.from_numpy(images).float().div(255.0) - 0.1307) / 0.3081
    return x.unsqueeze(1).to(device), torch.from_numpy(labels).long().to(device)


def reference_epoch(seed: int, batch_size: int, device: torch.device) -> tuple[float, float]:
    """One epoch of the upstream example; ``(test accuracy, train seconds)``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.manual_seed(seed)
    x, y = tensors("train", device)
    xt, yt = tensors("test", device)
    model = ReferenceNet().to(device)
    opt = torch.optim.Adadelta(model.parameters(), lr=1.0)
    model.train()
    t0 = time.perf_counter()
    for idx in torch.randperm(len(y)).to(device).split(batch_size):
        opt.zero_grad()
        F.nll_loss(model(x[idx]), y[idx]).backward()
        opt.step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    model.eval()
    correct = 0
    with torch.no_grad():
        for xb, yb in zip(xt.split(TEST_BATCH), yt.split(TEST_BATCH)):
            correct += int((model(xb).argmax(1) == yb).sum())
    return correct / len(yt), seconds


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="1,2,3", help="comma-separated --seed values")
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    p.add_argument("--pallas-opt", action="store_true", help="--impl port only")
    p.add_argument("--impl", choices=("port", "reference"), default="port")
    args = p.parse_args(argv)
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip(), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.impl == "reference":
            acc, seconds = reference_epoch(seed, args.batch_size,
                                           torch.device(args.device or "cuda"))
        else:
            flags = ["--batch-size", str(args.batch_size), "--epochs", "1", "--seed", str(seed)]
            timings: dict = {}
            with contextlib.redirect_stdout(io.StringIO()):
                fit(build_parser().parse_args(flags + ["--pallas-opt"] * args.pallas_opt),
                    args.device, timings=timings)
            acc, seconds = timings["epoch1_test_accuracy"], timings["epoch_train_s"][0]
        print(json.dumps({"seed": seed, "batch_size": args.batch_size,
                          "device": args.device or "cuda", "impl": args.impl,
                          "pallas_opt": args.pallas_opt and args.impl == "port",
                          "epoch1_test_accuracy": acc, "train_seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
