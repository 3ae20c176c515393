#!/usr/bin/env python3
"""The int8 head kernel of this checkout against an earlier one's, on one GPU.

    python3 tools/int8_head_ab.py --parent build/parent   # from the root of a checkout

``--parent`` is an unpacked earlier checkout (``git archive <commit> | tar
-x -C build/parent``) whose ``csrc/int8_head.cu`` has the two-argument-
shorter C entry of the single-pass kernel (no scratch pointers).  Both
kernels run at the CNN head's shape (k 9216, h 128, o 10; random int8
layers and non-negative features from a seed) with the cluster size and
shared memory this checkout's plan picks, which the two layouts share at
that shape.  Per n = 1, 8, 128 the outputs must be equal (torch.equal), and
each kernel is timed in turns, earlier, this, this, earlier, by
chip_smoke.py's median of 60 CUDA-event-timed calls, for --rounds rounds.
Prints one JSON line per round and n, then the card's name and power
limit.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K, H, O = 9216, 128, 10
ROWS = (1, 8, 128)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="unpacked earlier checkout")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_head_ab: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import head_layers, median_ms
    from pytorch_mnist_ddp_tpu_torch.ops import _build
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih

    src = Path(args.parent) / "pytorch_mnist_ddp_tpu_torch" / "csrc" / "int8_head.cu"
    lib_path = ROOT / "build" / "int8_head_ab" / "parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    parent = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    parent.int8_head_launch.argtypes = [i, p, i, i, p, p, p, i, p, p, p, i, p, i, i, p]
    parent.int8_head_launch.restype = i

    fc1, fc2 = head_layers(torch, np, K, H, O, seed=3)
    feats = torch.from_numpy(
        np.abs(np.random.RandomState(0).randn(max(ROWS), K)).astype(np.float32)).cuda()

    def earlier(x, plan):
        out = torch.empty((x.shape[0], O), dtype=torch.float32, device="cuda")
        rc = parent.int8_head_launch(
            0, x.data_ptr(), x.shape[0], K, fc1["weight_q"].data_ptr(), fc1["scale"].data_ptr(),
            fc1["bias"].data_ptr(), H, fc2["weight_q"].data_ptr(), fc2["scale"].data_ptr(),
            fc2["bias"].data_ptr(), O, out.data_ptr(), plan["cluster"], plan["smem"],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"the earlier kernel's launch failed: CUDA error {rc}")
        return out

    for r in range(args.rounds):
        for n in ROWS:
            x = feats[:n]
            plan = ih.launch_plan(n, K, H, O, 0)
            if not torch.equal(earlier(x, plan), ih.fused_int8_head(fc1, fc2, x)):
                raise SystemExit(f"the two kernels differ at n={n}")
            a = median_ms(torch, lambda: earlier(x, plan))
            b = median_ms(torch, lambda: ih.fused_int8_head(fc1, fc2, x))
            b2 = median_ms(torch, lambda: ih.fused_int8_head(fc1, fc2, x))
            a2 = median_ms(torch, lambda: earlier(x, plan))
            print(json.dumps({"round": r, "n": n, "cluster": plan["cluster"],
                              "earlier_us": [1e3 * a, 1e3 * a2], "this_us": [1e3 * b, 1e3 * b2]}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
