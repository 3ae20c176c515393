#!/usr/bin/env python3
"""Where the int8 head kernel's time goes, on one GPU.

    python3 tools/int8_head_phases.py                # from the root of a checkout
    python3 tools/int8_head_phases.py --copy-warps 8,4,1

Builds copies of pytorch_mnist_ddp_tpu_torch/csrc/int8_head.cu into
build/int8_head_phases/, one per number of copy warps asked for, each with
a clock64() stamp at every phase boundary: by thread 0, and by the first
copy warp once its own W1 copies have landed.  Each copy runs at the CNN
head's shape (k 9216, h 128, o 10; random int8 layers and features from a
seed) at n = 1, 8 and 128, with every cluster size the card can run there.
Per case it checks the output against int8_head_reference with
torch.equal, times 100 calls between one pair of CUDA events, and prints
one JSON line: the time per call, whether the wrapper's plan picks that
cluster size, and per phase the cycles since the block's start, the
median over row tiles of each tile's rank 0.  The last line is the card's
name and power limit.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "pytorch_mnist_ddp_tpu_torch" / "csrc" / "int8_head.cu"
OUT_DIR = ROOT / "build" / "int8_head_phases"
K, H, O = 9216, 128, 10
ROWS = (1, 8, 128)
CALLS = 100
SLOTS = 16  # stamps per block
PHASES = ("start", "x_issued", "maxima", "scales", "codes", "w1_landed", "mma_ready",
          "mma_done", "exchanged", "reduced", "end")

STAMPS = r'''
__device__ unsigned long long g_stamps[1 << 16];
#define STAMP_IF(i, cond) \
  if (cond) g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + (i)] = clock64();
#define STAMP(i) STAMP_IF(i, threadIdx.x == 0)
'''

# (text in the source, the same text with a stamp added); each must occur once.
MARKS = (
    ("  const int8_t* arow = xq + g * L.pitch + 4 * t;\n",
     "  const int8_t* arow = xq + g * L.pitch + 4 * t;\n  STAMP(0)\n"),
    ("        cluster_wait();\n#pragma unroll\n", "        cluster_wait();\n        STAMP(1)\n#pragma unroll\n"),
    ("        cluster_arrive();\n        cluster_wait();\n        if (tid < R) {",
     "        cluster_arrive();\n        cluster_wait();\n        STAMP(2)\n        if (tid < R) {"),
    ("          scale1[tid] = act_scale(a);\n        }\n        compute_sync();\n",
     "          scale1[tid] = act_scale(a);\n        }\n        compute_sync();\n        STAMP(3)\n"),
    ('      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n      if (step == 0) cluster_wait();\n',
     '      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "      STAMP_IF(5, threadIdx.x == 32 * WARPS)\n      if (step == 0) cluster_wait();\n"),
    ("    }\n    __syncthreads();  // the step's W1 has landed, the codes are written\n",
     "      STAMP(4)\n    }\n    __syncthreads();  // the step's W1 has landed, the codes are written\n"
     "    STAMP(6)\n"),
    ("    __syncthreads();  // W1's buffer and the codes are free for the next step\n",
     "    STAMP(7)\n    __syncthreads();  // W1's buffer and the codes are free for the next step\n"),
    ("    cluster.sync();\n\n    // 4.", "    cluster.sync();\n    STAMP(8)\n\n    // 4."),
    ("    if constexpr (!HID_SMEM) __threadfence();\n",
     "    STAMP(9)\n    if constexpr (!HID_SMEM) __threadfence();\n"),
    ("    out[(size_t)(row0 + r) * o + oo] = epilogue(acc2, scale2[r], s2[oo], b2[oo]);\n  }\n",
     "    out[(size_t)(row0 + r) * o + oo] = epilogue(acc2, scale2[r], s2[oo], b2[oo]);\n  }\n"
     "  STAMP(10)\n"),
)


def stamped_source(copy_warps: int) -> str:
    src = SOURCE.read_text()
    src = src.replace("namespace {\n\nconstexpr int R", STAMPS + "namespace {\n\nconstexpr int R", 1)
    marks = MARKS + (("constexpr int COPY_WARPS = 8;", f"constexpr int COPY_WARPS = {copy_warps};"),)
    for old, new in marks:
        if src.count(old) != 1:
            raise SystemExit(f"int8_head_phases: the source no longer has {old!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int int8_head_read_stamps(unsigned long long* dst, int count) {\n'
                  "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, count * 8);\n}\n")


def build(copy_warps: int) -> ctypes.CDLL:
    from pytorch_mnist_ddp_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"copy{copy_warps}.cu"
    lib = OUT_DIR / f"copy{copy_warps}.so"
    src.write_text(stamped_source(copy_warps))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.int8_head_launch.argtypes = [i, p, i, i, p, p, p, i, p, p, p, i, p, i, i, p, p, p]
    so.int8_head_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
    so.int8_head_read_stamps.argtypes = [p, i]
    return so


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--copy-warps", default="8", help="comma-separated counts (default 8)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import numpy as np
    import torch

    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih

    if not torch.cuda.is_available():
        print("int8_head_phases: no CUDA device", file=sys.stderr)
        return 1
    counts = [int(c) for c in args.copy_warps.split(",")]
    with ThreadPoolExecutor(len(counts)) as pool:
        libs = dict(zip(counts, pool.map(build, counts)))

    rng = np.random.RandomState(args.seed)
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(np.abs(rng.randn(max(ROWS), K)).astype(np.float32)).to(dev)
    fc1 = {"weight_q": torch.from_numpy(rng.randint(-127, 128, (H, K)).astype(np.int8)),
           "scale": torch.from_numpy((rng.rand(H) * 1e-3).astype(np.float32)),
           "bias": torch.from_numpy(rng.randn(H).astype(np.float32))}
    fc2 = {"weight_q": torch.from_numpy(rng.randint(-127, 128, (O, H)).astype(np.int8)),
           "scale": torch.from_numpy((rng.rand(O) * 1e-2).astype(np.float32)),
           "bias": torch.from_numpy(rng.randn(O).astype(np.float32))}
    fc1, fc2 = ({k: v.to(dev) for k, v in layer.items()} for layer in (fc1, fc2))
    stream = torch.cuda.current_stream(dev).cuda_stream

    for cw, lib in libs.items():
        active = {}
        for c in ih.CLUSTER_SIZES:
            if ih._fits(K, H, O, c):
                count = ctypes.c_int(0)
                lib.int8_head_max_clusters(0, c, ih._smem_bytes(K, H, O, c), ctypes.byref(count))
                active[c] = count.value
        for n in ROWS:
            planned = ih._launch_plan(n, K, H, O, active)["cluster"]
            want = ih.int8_head_reference(fc1, fc2, x[:n])
            for c in (c for c, a in active.items() if a > 0):
                out = torch.empty((n, O), dtype=torch.float32, device=dev)
                smem = ih._smem_bytes(K, H, O, c)

                def launch():
                    rc = lib.int8_head_launch(
                        0, x.data_ptr(), n, K, fc1["weight_q"].data_ptr(), fc1["scale"].data_ptr(),
                        fc1["bias"].data_ptr(), H, fc2["weight_q"].data_ptr(),
                        fc2["scale"].data_ptr(), fc2["bias"].data_ptr(), O, out.data_ptr(), c, smem,
                        None, None, stream)
                    if rc:
                        raise SystemExit(f"launch failed: CUDA error {rc}")

                for _ in range(5):
                    launch()
                torch.cuda.synchronize()
                per_call = []
                for _ in range(5):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    torch.cuda._sleep(50_000_000)
                    start.record()
                    for _ in range(CALLS):
                        launch()
                    end.record()
                    torch.cuda.synchronize()
                    per_call.append(1e3 * start.elapsed_time(end) / CALLS)
                equal = bool(torch.equal(out, want))
                tiles = -(-n // ih.ROWS)
                buf = (ctypes.c_ulonglong * (tiles * c * SLOTS))()
                lib.int8_head_read_stamps(ctypes.addressof(buf), tiles * c * SLOTS)
                stamps = np.array(buf, dtype=np.int64).reshape(tiles, c, SLOTS)[:, 0, :]
                since = stamps[:, :len(PHASES)] - stamps[:, :1]
                print(json.dumps({
                    "copy_warps": cw, "n": n, "cluster": c, "planned": c == planned,
                    "max_clusters": active[c], "us_per_call_back_to_back": statistics.median(per_call),
                    "equal_to_plain": equal,
                    "phase_cycles": {p: int(np.median(since[:, i])) for i, p in enumerate(PHASES)},
                }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
