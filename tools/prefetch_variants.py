#!/usr/bin/env python3
"""What the per-batch path's input feed costs, one design against another.

    python3 tools/prefetch_variants.py          # on the card

Four feeds of the same batches (the synthetic 60k set at batch 64, seed 1)
in turns, forward then backward, four rounds: ``depth0`` (the loader at
``--prefetch-depth 0``: assembly, pinning and the copy inline),
``stream_copy`` (a thread assembles, pins and copies on a CUDA stream of
its own; the consumer's stream waits on the copy's event and records the
batch's memory on itself: the JAX package's placement in the producer),
``pin_only`` (the thread assembles and pins; the consumer copies on its
own stream) and ``host_only`` (the loader at depth 2, ``data/loader.py``:
the thread assembles; the consumer pins and copies).  For
each: the seconds the loader alone takes for an epoch, then the seconds
of an epoch of ``--pallas-opt`` steps from fresh weights (dropout on,
deterministic cuDNN, TF32 off), and whether every feed ends on the same
parameters.  Prints one JSON object and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())  # run from the root of a checkout
import torch  # noqa: E402

from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
from pytorch_mnist_ddp_tpu_torch.data import loader as L
from pytorch_mnist_ddp_tpu_torch.data.prefetch import DevicePrefetcher
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step


class StreamCopy(L.DataLoader):
    """The thread assembles, pins and copies on the loader's own stream."""

    def epoch(self, epoch, start_batch=0):
        stream = torch.cuda.Stream(self.device)

        def place(host_batch):
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                batch = self._place(host_batch)
                copied = torch.cuda.Event()
                copied.record(stream)
            return batch, copied

        feed = DevicePrefetcher(map(place, self._host_batches(epoch, start_batch)),
                                self.prefetch_depth)
        try:
            for batch, copied in feed:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(copied)
                for t in batch:
                    t.record_stream(current)
                yield batch
        finally:
            feed.close()


class PinOnly(L.DataLoader):
    """The thread assembles and pins; the consumer copies on its stream."""

    def epoch(self, epoch, start_batch=0):
        def pin(host_batch):
            return tuple(torch.from_numpy(a).pin_memory() for a in host_batch)

        feed = DevicePrefetcher(map(pin, self._host_batches(epoch, start_batch)),
                                self.prefetch_depth)
        try:
            for batch in feed:
                yield tuple(t.to(self.device, non_blocking=True) for t in batch)
        finally:
            feed.close()


VARIANTS = {"depth0": (L.DataLoader, 0), "stream_copy": (StreamCopy, 2),
            "pin_only": (PinOnly, 2), "host_only": (L.DataLoader, 2)}


def main() -> None:
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    images, labels = synthetic_mnist("train")
    res = {k: {"loader_s": [], "train_s": []} for k in VARIANTS}
    ref = None
    for rep in range(4):
        order = list(VARIANTS.items()) if rep % 2 == 0 else list(reversed(VARIANTS.items()))
        for name, (cls, depth) in order:
            loader = cls(images, labels, 64, dev, seed=1, prefetch_depth=depth)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sum(1 for _ in loader.epoch(1))
            torch.cuda.synchronize()
            res[name]["loader_s"].append(time.perf_counter() - t0)
            net = Net(torch.Generator().manual_seed(12)).cuda()
            state = make_train_state(net, use_pallas=True)
            step = make_train_step(use_pallas=True, dropout_seed=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, y, w in loader.epoch(1):
                step(net, state, x, y, w, 1.0)
            torch.cuda.synchronize()
            res[name]["train_s"].append(time.perf_counter() - t0)
            params = torch.cat([q.detach().reshape(-1) for q in net.parameters()]).cpu()
            if ref is None:
                ref = params
            res[name]["equal"] = bool(torch.equal(ref, params))
    print(json.dumps(res, indent=1))
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read())


if __name__ == "__main__":
    main()
