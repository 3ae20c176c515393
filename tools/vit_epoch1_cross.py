#!/usr/bin/env python3
"""Epoch-1 test accuracy of the ViT CLIs, each package from its own
initial weights and from the other's.

    python3 tools/vit_epoch1_cross.py --seeds 1,2,3 --experts 8
    python3 tools/vit_epoch1_cross.py --seeds 1 --experts 0 --work build/cross

The port's ``vit_mnist`` and the JAX package's root ``vit_mnist.py`` draw
their initial weights from different generators (``torch.Generator``
against JAX's key stream), from the same distributions.  Where an epoch
ends depends on that draw, so an epoch-1 reading of one package says
little about the other's.  This tool separates the draw from the trainer:
for every seed it writes both packages' initial weights (``--epochs 0
--save-model``, the JAX package's params-tree archive), then trains one
epoch four ways, each trainer from each draw (``--resume``), at the CLI
defaults and ``--seed`` (which also orders the batches).  Both read the
synthetic 60k/10k set from IDX files written once under ``--work``, so
neither looks for a download.  Everything runs on the CPU, the JAX CLI
without ``--flash`` (its Pallas kernel would run in interpret mode), the
port's with it (its plain version on the CPU).

Prints one JSON line per run: seed, trainer (``port``/``jax``), initial
weights (``port``/``jax``), epoch-1 test accuracy, wall seconds.  It needs
the JAX package and the port in one environment, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import struct
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The JAX CLI under a guard: its loader tries a download when the IDX
# files are missing; they are not, and the guard makes sure of it.
JAX_CLI = (
    "import runpy, sys; import pytorch_mnist_ddp_tpu.data.mnist as m; "
    "m._try_download = lambda *a: None; sys.argv = ['vit_mnist.py'] + sys.argv[1:]; "
    f"runpy.run_path({os.path.join(ROOT, 'vit_mnist.py')!r}, run_name='__main__')"
)
ACCURACY = re.compile(r"Accuracy: (\d+)/(\d+)")


def write_idx(root: str) -> None:
    """The synthetic set as the four MNIST IDX files."""
    import numpy as np

    from pytorch_mnist_ddp_tpu_torch.data.mnist import _FILES, synthetic_mnist

    os.makedirs(root, exist_ok=True)
    for split in ("train", "test"):
        images, labels = synthetic_mnist(split)
        n = len(images)
        with open(os.path.join(root, _FILES[(split, "images")]), "wb") as f:
            f.write(struct.pack(">iiii", 2051, n, 28, 28) + images.astype(np.uint8).tobytes())
        with open(os.path.join(root, _FILES[(split, "labels")]), "wb") as f:
            f.write(struct.pack(">ii", 2049, n) + labels.astype(np.uint8).tobytes())


def run(trainer: str, flags: list[str], cwd: str, env: dict) -> tuple[str, float]:
    if trainer == "port":
        cmd = [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.vit_mnist", "--no-cuda",
               "--flash", *flags]
    else:
        cmd = [sys.executable, "-c", JAX_CLI, "--no-accel", *flags]
    os.makedirs(cwd, exist_ok=True)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"{trainer} {flags} failed ({out.returncode}):\n{out.stderr[-4000:]}")
    return out.stdout, time.perf_counter() - t0


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--work", default=os.path.join(ROOT, "build", "vit_epoch1_cross"))
    args = p.parse_args()
    work = os.path.abspath(args.work)
    data = os.path.join(work, "idx")
    write_idx(data)
    env = dict(os.environ, MNIST_DATA_DIR=data, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)  # one JAX device, as the port's one process
    model = ["--experts", str(args.experts)] if args.experts else []
    for seed in (int(s) for s in args.seeds.split(",")):
        inits = {}
        for pkg in ("port", "jax"):
            cwd = os.path.join(work, f"s{seed}", f"init_{pkg}")
            run(pkg, [*model, "--seed", str(seed), "--epochs", "0", "--save-model"], cwd, env)
            inits[pkg] = os.path.join(cwd, "vit_mnist.npz")
        for trainer in ("port", "jax"):
            for init in ("port", "jax"):
                flags = [*model, "--seed", str(seed), "--epochs", "1"]
                if init != trainer:
                    flags += ["--resume", inits[init]]
                stdout, seconds = run(trainer, flags,
                                      os.path.join(work, f"s{seed}", f"{trainer}_{init}"), env)
                correct, total = map(int, ACCURACY.findall(stdout)[-1])
                print(json.dumps({"seed": seed, "experts": args.experts, "trainer": trainer,
                                  "initial_weights": init, "epoch1_test_accuracy": correct / total,
                                  "wall_seconds": round(seconds, 1)}), flush=True)


if __name__ == "__main__":
    main()
