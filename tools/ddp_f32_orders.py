#!/usr/bin/env python3
"""How far f32 summation orders of one training step drift from f64.

    python3 tools/ddp_f32_orders.py --device cpu
    python3 tools/ddp_f32_orders.py --perms 8           # on the card

The CNN's first ``--steps`` steps at lr 1.0, dropout off, on fixed global
batches of 64 from the synthetic set, as ``chip_smoke.py``'s ddp phase
takes them: once in float64, written apart from the port (the forward in
``torch.nn.functional``, ``torch.optim.Adadelta``), and in float32 through
the port's step in several orders of the same math: the batch of 64 as
it comes; its rows permuted (``--perms`` permutations); the data-parallel
order, two halves of 32 whose gradients are summed and halved; and four
quarters of 16.  Prints, per order, one JSON line: the largest parameter
difference from the f64 run after the last step and the loss's relative
difference from it after each step.  On the card, the card's name and
power limit come first.  TF32 is off and cuDNN deterministic, as in
``fit()``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist  # noqa: E402
from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize  # noqa: E402
from pytorch_mnist_ddp_tpu_torch.models.net import Net  # noqa: E402
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init, adadelta_update  # noqa: E402
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import forward_loss  # noqa: E402

BATCH = 64
INIT_SEED = 12  # chip_smoke.py's SEED


def f64_run(xs, ys, device):
    """The steps in float64; returns (losses [steps], state)."""
    net = Net(torch.Generator().manual_seed(INIT_SEED)).to(device).double()
    opt = torch.optim.Adadelta(net.parameters(), lr=1.0, rho=0.9, eps=1e-6)
    losses = []
    for x, y in zip(xs, ys):
        h = F.relu(F.conv2d(x.double().permute(0, 3, 1, 2), net.conv1.weight, net.conv1.bias))
        h = F.max_pool2d(F.relu(F.conv2d(h, net.conv2.weight, net.conv2.bias)), 2)
        h = F.relu(F.linear(torch.flatten(h, 1), net.fc1.weight, net.fc1.bias))
        loss = F.nll_loss(F.log_softmax(F.linear(h, net.fc2.weight, net.fc2.bias), 1), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).cpu(), {k: v.detach().cpu() for k, v in net.state_dict().items()}


def f32_run(xs, ys, device, parts: int, perm=None):
    """The steps in float32 through the port's forward and plain Adadelta,
    each batch (rows permuted by ``perm``) in ``parts`` equal slices whose
    mean gradients are summed and divided by ``parts``; returns (the
    slices' mean losses [steps], state)."""
    net = Net(torch.Generator().manual_seed(INIT_SEED)).to(device)
    params = dict(net.named_parameters())
    state = adadelta_init(params)
    b = BATCH // parts
    w = torch.ones(b, device=device)
    divisor = torch.full((), float(parts), device=device)
    losses = []
    for x, y in zip(xs, ys):
        if perm is not None:
            x, y = x[perm], y[perm]
        net.train()
        total, step_losses = None, []
        for i in range(parts):
            rows = slice(i * b, (i + 1) * b)
            loss = forward_loss(net, x[rows], y[rows], w, None)
            grads = torch.autograd.grad(loss, list(params.values()))
            total = grads if total is None else [t + g for t, g in zip(total, grads)]
            step_losses.append(loss.detach())
        adadelta_update(params, {k: g.div(divisor) for k, g in zip(params, total)},
                        state, 1.0)
        losses.append(torch.stack(step_losses).mean())
    return torch.stack(losses).cpu(), {k: v.detach().cpu() for k, v in net.state_dict().items()}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--perms", type=int, default=4)
    p.add_argument("--perm-seed", type=int, default=INIT_SEED)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip(), flush=True)
    images, labels = synthetic_mnist("train", args.steps * BATCH)
    xs = torch.from_numpy(normalize(images).reshape(args.steps, BATCH, 28, 28, 1)).to(device)
    ys = torch.from_numpy(labels.astype(np.int64).reshape(args.steps, BATCH)).to(device)
    want_losses, want = f64_run(xs, ys, device)
    gen = torch.Generator().manual_seed(args.perm_seed)
    orders = [("batch_64", 1, None), ("halves_2x32", 2, None), ("quarters_4x16", 4, None)]
    orders += [(f"rows_permuted_{i}", 1, torch.randperm(BATCH, generator=gen).to(device))
               for i in range(args.perms)]
    for name, parts, perm in orders:
        losses, got = f32_run(xs, ys, device, parts, perm)
        rel = (losses.double() - want_losses).abs() / want_losses.abs()
        print(json.dumps({
            "order": name, "device": device.type, "steps": args.steps,
            "max_abs_param_diff": max(float((got[k].double() - want[k]).abs().max())
                                      for k in want),
            "rel_loss_diff_by_step": [float(f"{v:.3g}") for v in rel.tolist()]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
