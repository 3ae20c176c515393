#!/usr/bin/env python
"""ViT-family benchmark row, one JSON line a run:
``python -m pytorch_mnist_ddp_tpu_torch.tools.vit_bench [--mode M]
[--epochs N] [--batch-size N] [--device cuda|cpu]``.

The JAX package's ``tools/vit_bench.py`` over the port's CLI.  It runs
``python -m pytorch_mnist_ddp_tpu_torch.vit_mnist`` in a subprocess at
``--epochs`` (20), ``--batch-size`` (200) and ``--test-batch-size``
(1000), and prints one JSON line: the CLI's own wall clock (its
``Total cost time`` line), the accuracies of its first and last epoch and
the dataset; for the fused modes (``fused``, ``zero``: ``--zero
--fused``) also the CLI's ``--timings-json`` attribution (``run_s``,
``compile_s``, ``data_s``; ``compile_s`` is the CUDA-graph capture),
images/s a card over ``run_s``, and MFU from the analytic ViT FLOPs
(``utils/flops.py`` ``vit_run_flops``) against ``gpu_peak_flops`` for the
run's dtype, under a key that names it (``peak_f32_tflops_per_chip``).
The other modes (``sp``, ``sp-ulysses``, ``tp`` at degree 1 under
``--allow-degree-1``, ``flash``) are per-batch smoke rows: wall clock and
accuracy only.  A failure prints an error JSON and exits 1.

The card's count and name come from a torch subprocess
(``torch.cuda.device_count()``, ``get_device_name(0)``), started beside
the CLI's; without a card the probe fails and so does the row.  The CLI runs without the launcher,
a world of one on ``cuda:0``, so ``n_chips`` is 1 and ``cards_visible``
the probe's count.  ``--device cpu`` passes ``--no-cuda`` and probes
nothing: its row is a CPU run's and carries no MFU.  The tool writes one
temporary file (the timings), removed on every exit path, and nothing in
the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils.flops import gpu_peak_flops, vit_run_flops

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLI = "pytorch_mnist_ddp_tpu_torch.vit_mnist"

# Extra CLI flags per mode (JAX's).  sp/tp ride --allow-degree-1: their
# parallel code paths on a 1-wide axis of one card; no pp (two stages at
# least, a world of one has one rank).
MODES = {
    "fused": ["--fused"],
    "sp": ["--sp", "1", "--allow-degree-1"],
    "sp-ulysses": ["--sp", "1", "--sp-impl", "ulysses", "--allow-degree-1"],
    "tp": ["--tp", "1", "--allow-degree-1"],
    "flash": ["--flash"],
    "zero": ["--zero", "--fused"],
}
# The modes that run the fused whole-run and write --timings-json.
FUSED_MODES = ("fused", "zero")
# Every mode trains in float32 (TF32 off): the peak MFU is read against,
# and the key that records it (JAX's names its bf16 peak).
DTYPE = "float32"
PEAK_KEY = "peak_f32_tflops_per_chip"

PROBE = ("import torch\n"
         "n = torch.cuda.device_count()\n"
         "print(n)\n"
         "print(torch.cuda.get_device_name(0) if n else '')\n")


def probe_cards(timeout: float = 120.0) -> tuple[int, str]:
    """``(count, name of card 0)`` from a torch subprocess; raises when
    there is no card."""
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2 or int(lines[-2]) < 1:
        raise RuntimeError(f"no CUDA device (exit {proc.returncode}: "
                           f"{(proc.stdout + proc.stderr)[-300:]!r})")
    return int(lines[-2]), lines[-1]


def run_cli(cmd: list[str], timeout: float) -> subprocess.CompletedProcess:
    """The CLI in a subprocess, the repository on its import path."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)


def cli_command(args, timings_path: str | None) -> list[str]:
    cmd = [sys.executable, "-m", CLI, "--epochs", str(args.epochs),
           "--batch-size", str(args.batch_size),
           "--test-batch-size", str(args.test_batch_size), *MODES[args.mode]]
    if args.device == "cpu":
        cmd.append("--no-cuda")
    if timings_path:
        cmd += ["--timings-json", timings_path]
    return cmd


def summarize(args, stdout: str, stderr: str, wall: float, n_chips: int, cards_visible: int,
              device_kind: str, timings: dict) -> dict:
    """The row from the CLI's output and its timings (``{}`` for a
    per-batch mode); raises ValueError when the output lacks the timer
    or the accuracy lines."""
    m = re.search(r"Total cost time:([0-9.]+)", stdout)
    accs = re.findall(r"Accuracy: (\d+)/(\d+)", stdout)
    if not m or not accs:
        raise ValueError("output missing timer or accuracy lines")
    out = stdout + stderr
    result = {
        "metric": f"vit_mnist_{args.mode}_wall_clock",
        "value": round(float(m.group(1)), 2),
        "unit": "s",
        "model": "vit",
        "mode": args.mode,
        "mode_degree": 1 if "--allow-degree-1" in MODES[args.mode] else None,
        "epochs": args.epochs,
        "n_chips": n_chips,
        "cards_visible": cards_visible,
        "device": device_kind,
        "batch_size_per_shard": args.batch_size,
        "global_batch": args.batch_size * n_chips,
        # the fused modes overwrite this from the timings' own label
        "dataset": ("synthetic" if "synthetic MNIST-like data" in out
                    else "idx-unverified" if "idx-unverified" in out else "idx"),
        "subprocess_wall_s": round(wall, 2),
        "epoch1_test_accuracy": round(100.0 * int(accs[0][0]) / int(accs[0][1]), 2),
        "final_test_accuracy": round(100.0 * int(accs[-1][0]) / int(accs[-1][1]), 2),
    }
    if timings.get("dataset"):
        result["dataset"] = timings["dataset"]
    if "run_s" in timings:
        t = timings
        result["run_s"] = round(t["run_s"], 2)
        result["compile_s"] = round(t.get("compile_s", 0.0), 2)
        result["data_s"] = round(t.get("data_s", 0.0), 2)
        result["device_run_share"] = round(t["run_s"] / result["value"], 3)
        # JAX's heuristic (a warm load ~1-2 s, a cold compile ~20 s); here
        # compile_s is a CUDA-graph capture, which compiles nothing
        result["cache"] = "warm" if result["compile_s"] < 5.0 else "cold"
        if t["run_s"] > 0:
            from ..models.vit import ViTConfig  # noqa: PLC0415 -- torch only for a fused row

            result["images_per_sec_per_chip_run"] = round(
                t["train_size"] * args.epochs / t["run_s"] / n_chips, 1)
            cfg = ViTConfig(depth=t.get("depth", 2), dim=t.get("dim", 64))
            flops = vit_run_flops(cfg, t["train_size"], t["test_size"], args.epochs)
            result["model_tflops"] = round(flops / 1e12, 3)
            peak = gpu_peak_flops(device_kind, DTYPE) if args.device == "cuda" else None
            if peak is not None:
                result[PEAK_KEY] = round(peak / 1e12, 1)
                result["mfu"] = round(flops / t["run_s"] / (peak * n_chips), 5)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m pytorch_mnist_ddp_tpu_torch.tools.vit_bench")
    p.add_argument("--mode", default="fused", choices=sorted(MODES))
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the CLI trains: the card (cuda:0), or the CPU "
                        "(--no-cuda; no probe, no MFU)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    def fail(reason: str) -> int:
        print(json.dumps({"metric": f"vit_mnist_{args.mode}_wall_clock", "value": None,
                          "error": reason}))
        return 1

    timings_path = None
    if args.mode in FUSED_MODES:
        fd, timings_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
    try:
        # The probe's process starts beside the CLI's: each pays its own
        # start-up (torch's import, the card's context); its verdict is
        # read first, as the JAX tool probes before it runs.
        with ThreadPoolExecutor(1) as pool:
            probed = pool.submit(probe_cards) if args.device == "cuda" else None
            start = time.time()
            try:
                proc = run_cli(cli_command(args, timings_path), args.timeout)
            except subprocess.TimeoutExpired:
                proc = None
            wall = time.time() - start
            cards_visible, device_kind = 0, "cpu"
            if probed is not None:
                try:
                    cards_visible, device_kind = probed.result()
                except (OSError, RuntimeError, ValueError, subprocess.TimeoutExpired) as e:
                    return fail(f"device probe failed: {e}")
        if proc is None:
            return fail(f"timeout after {args.timeout}s")
        if proc.returncode != 0:
            return fail(f"exit {proc.returncode}: {proc.stderr[-400:]}")
        timings = {}
        if timings_path:
            try:
                with open(timings_path) as f:
                    timings = json.load(f)
            except (OSError, ValueError):
                timings = {}
        try:
            result = summarize(args, proc.stdout, proc.stderr, wall, 1, cards_visible,
                               device_kind, timings)
        except ValueError as e:
            return fail(str(e))
    finally:
        if timings_path and os.path.exists(timings_path):
            os.unlink(timings_path)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
