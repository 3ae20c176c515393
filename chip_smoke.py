#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each:

1. env     — the card (nvidia-smi name and power limit), torch and CUDA
             versions, TF32 off;
2. build   — every kernel under pytorch_mnist_ddp_tpu_torch/csrc/, built and
             loaded as the wrappers do at first use;
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the row counts the serving ladder gives it;
4. engine  — InferenceEngine.from_seed on the card (f32 + int8), bucketed
             and packed: warmup, the int8 parity gate, f32 against the CPU
             model, int8 predictions through the kernel;
5. server  — make_server on 127.0.0.1 over the bucketed engine: JSON
             /predict in f32 and int8 from one client, each answer held
             against engine.predict_logits; /metrics, /healthz, /readyz;
             drain.  Then over the packed engine with concurrent clients,
             so requests coalesce into multi-segment batches on the card;
6. times   — each kernel, its plain version and the nearest library call,
             with CUDA events, beside the least time the card could take.

Then the ``kernels`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Kernel launch counts are zeroed just
before phase 4 and read just after phase 5, so they count only the main
path.  The latencies printed are smoke readings of this script's own
traffic, not a benchmark.  Any failure exits non-zero; so does a host without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

# InferenceEngine.from_seed weights (torch.Generator).  Random weights give
# near-uniform logits, and the int8 gate rightly refuses argmax ties inside
# the quantization error; seed 12's smallest top-1 margin over the 128-row
# parity slice is ~0.1, against an int8 error of ~0.005 (CPU scan).
SEED = 12
KERNEL_ROWS = (1, 3, 8, 64, 128, 130)
TIMED_ROWS = (8, 128)
KERNEL_TOL = 1e-5  # kernel vs plain: same integer arithmetic, IEEE epilogue
F32_TOL = 1e-4  # cuDNN vs CPU f32 convs: same math, other summation order
HTTP_TOL = 1e-5  # same rows, same bucket shape, same device as predict_logits
# Latency loop: one client, closed loop (next request after the reply),
# sizes 1..12 rows alternating f32/int8; 1000 samples leave 10 beyond p99.
LATENCY_REQUESTS = 1000
# Packed server: one round per dtype, each of CLIENTS closed-loop clients
# sending PER_CLIENT requests of 1..12 rows.  One dtype per round: the
# batcher closes a batch at the first queued request of another dtype, and
# on the card mixed traffic dispatched every request alone (PERF.md).
CLIENTS = 8
PER_CLIENT = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def median_ms(torch, fn, runs: int = 60, warm: int = 5) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events
    recorded between calls.  A sleep kernel ahead of them keeps the device
    busy while the host enqueues, so the gaps measure device time, not
    launch overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(100_000_000)
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))


def head_bound(n: int, k: int, h: int, o: int) -> tuple[float, str]:
    """Least time (ms) for the fused head at n rows: each input read once,
    the output written once, against the int8 operations it must do."""
    nbytes = n * k * 4 + h * k + 2 * h * 4 + o * h + 2 * o * 4 + n * o * 4
    ops = 2 * n * (k * h + h * o)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def post_json(url: str, body: dict | bytes) -> dict:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        check(r.status == 200, f"{url} answered {r.status}")
        return json.loads(r.read())


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as r:
        check(r.status == 200, f"{url} answered {r.status}")
        return r.read()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    import numpy as np

    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.models.quant import (
        conv_stack,
        qparams_to,
        quantize_params,
    )
    from pytorch_mnist_ddp_tpu_torch.ops import _build
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.serving.engine import PARITY_SEED, InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
    from pytorch_mnist_ddp_tpu_torch.serving.server import make_server

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                   "matmul": torch.backends.cuda.matmul.allow_tf32}})

    # 2. build
    t0 = time.perf_counter()
    for name in _build.sources():
        _build.library(name)
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "sources": _build.sources(), "seconds": build_s})

    # 3. kernel against its plain version, at the ladder's row counts
    state = Net(torch.Generator().manual_seed(SEED)).state_dict()
    q = qparams_to(quantize_params(state), dev)
    fc1, fc2 = q["fc1"], q["fc2"]
    raw = np.random.RandomState(PARITY_SEED).randint(
        0, 256, (max(KERNEL_ROWS), 28, 28)).astype(np.uint8)
    x_all = normalize(raw)
    with torch.inference_mode():
        feats = conv_stack(q, torch.from_numpy(x_all).to(dev))
    kernel_err = {}
    for n in KERNEL_ROWS:
        f = feats[:n]
        got = ih.fused_int8_head(fc1, fc2, f)
        want = ih.int8_head_reference(fc1, fc2, f)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"int8_head non-finite at n={n}")
        check(err <= KERNEL_TOL, f"int8_head off its plain version by {err} at n={n}")
        check(bool((got.argmax(1) == want.argmax(1)).all()), f"int8_head argmax at n={n}")
        kernel_err[n] = err
    emit({"phase": "kernel", "name": "int8_head", "tolerance": KERNEL_TOL,
          "max_abs_err_by_n": kernel_err})

    # 4 + 5. the main path; launch counts cover exactly these two phases
    ih.LAUNCHES = 0
    cpu_net = Net()
    cpu_net.load_state_dict(state)
    cpu_net.eval()
    engines = {}
    for packed in (False, True):
        metrics = ServingMetrics()
        engine = InferenceEngine.from_seed(SEED, dtypes=("int8",), packed=packed,
                                           metrics=metrics)
        check(engine.device.type == "cuda", f"engine on {engine.device}")
        t0 = time.perf_counter()
        rungs = engine.warmup()
        warm_s = time.perf_counter() - t0
        gate = engine.verify_parity()["int8"]
        check(gate["passed"], f"int8 parity gate failed: {gate}")
        before = ih.LAUNCHES
        x = x_all[:100]  # past no bucket on the default ladder: one chunk
        out8 = engine.predict_logits(x, dtype="int8")
        check(ih.LAUNCHES > before, "int8 predictions did not launch int8_head")
        out32 = engine.predict_logits(x)
        with torch.inference_mode():
            ref32 = cpu_net(torch.from_numpy(x)).numpy()
        f32_err = float(np.abs(out32 - ref32).max())
        check(np.isfinite(out8).all() and out8.shape == (100, 10), "int8 output")
        check(f32_err <= F32_TOL, f"f32 engine off the CPU model by {f32_err}")
        check((out32.argmax(1) == ref32.argmax(1)).all(), "f32 argmax vs CPU model")
        engines[packed] = (engine, metrics)
        emit({"phase": "engine", "packed": packed, "buckets": list(engine.buckets),
              "rungs": len(rungs), "warmup_s": warm_s, "parity": gate,
              "f32_vs_cpu_max_abs": f32_err,
              "int8_vs_f32_max_abs": float(np.abs(out8 - out32).max())})

    engine, metrics = engines[False]
    server = make_server(engine, metrics, linger_ms=1.0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    http_err = 0.0
    bodies = [
        json.dumps({"instances": raw[:i].reshape(i, -1).tolist(),
                    "dtype": "int8" if i % 2 else "f32",
                    "return_log_probs": True}).encode()
        for i in range(1, 13)
    ]
    try:
        for i in range(1, 13):
            dtype = "int8" if i % 2 else "f32"
            rows = raw[:i]
            resp = post_json(base + "/predict", bodies[i - 1])
            got = np.asarray(resp["log_probs"], np.float32)
            want = engine.predict_logits(normalize(rows), dtype=dtype)
            err = float(np.abs(got - want).max())
            check(err <= HTTP_TOL, f"/predict {dtype} x{i} off predict_logits by {err}")
            check(resp["predictions"] == want.argmax(1).tolist(), "/predict argmax")
            http_err = max(http_err, err)
        latencies = []
        t_loop = time.perf_counter()
        for j in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            post_json(base + "/predict", bodies[j % len(bodies)])
            latencies.append(1e3 * (time.perf_counter() - t0))
        loop_s = time.perf_counter() - t_loop
        snap = json.loads(get(base + "/metrics"))
        prom = get(base + "/metrics?format=prom").decode()
        check("serving_requests_total" in prom, "prometheus exposition")
        check(json.loads(get(base + "/healthz"))["status"] == "ok", "/healthz")
        get(base + "/readyz")
    finally:
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
        serve.join(timeout=30)
    check(not serve.is_alive(), "server thread did not stop")
    done = metrics.completed
    sent = 12 + LATENCY_REQUESTS
    check(snap["requests"]["completed"] == sent and metrics.failed == 0,
          f"server completed {done} of {sent}, failed {metrics.failed}")
    emit({"phase": "server", "requests": sent, "completed": done,
          "max_abs_vs_predict_logits": http_err,
          "client_closed_loop": {"requests": LATENCY_REQUESTS, "seconds": loop_s,
                                 "p50_ms": float(np.percentile(latencies, 50)),
                                 "p99_ms": float(np.percentile(latencies, 99))},
          "server_submit_to_result_ms": {k: snap["latency_ms"][k]
                                         for k in ("count", "p50", "p99")}})

    # The packed engine behind the server with concurrent clients: the
    # batcher coalesces the requests into one capacity buffer with several
    # segments.  Expected answers are computed before the server
    # starts, since only the dispatch thread may launch while it runs.
    engine, metrics = engines[True]
    want_all = {dt: engine.predict_logits(normalize(raw), dtype=dt)
                for dt in ("f32", "int8")}
    server = make_server(engine, metrics, fill_wait_ms=2.0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def client(c: int, dtype: str) -> tuple[list[float], float]:
        lat, worst = [], 0.0
        for j in range(PER_CLIENT):
            size = 1 + (c + j) % 12
            off = (7 * c + 13 * j) % (len(raw) - size)
            body = {"instances": raw[off:off + size].reshape(size, -1).tolist(),
                    "dtype": dtype, "return_log_probs": True}
            t0 = time.perf_counter()
            resp = post_json(base + "/predict", body)
            lat.append(1e3 * (time.perf_counter() - t0))
            got = np.asarray(resp["log_probs"], np.float32)
            want = want_all[dtype][off:off + size]
            err = float(np.abs(got - want).max())
            check(err <= HTTP_TOL, f"packed /predict {dtype} x{size} off by {err}")
            check(resp["predictions"] == want.argmax(1).tolist(), "packed /predict argmax")
            worst = max(worst, err)
        return lat, worst

    rounds = {}
    try:
        for dtype in ("f32", "int8"):
            batches, samples = metrics.batches, metrics.snapshot()["samples"]
            t_loop = time.perf_counter()
            with ThreadPoolExecutor(CLIENTS) as pool:
                results = list(pool.map(client, range(CLIENTS), [dtype] * CLIENTS))
            loop_s = time.perf_counter() - t_loop
            after = metrics.snapshot()["samples"]
            batches = metrics.batches - batches
            latencies = [t for lat, _ in results for t in lat]
            rounds[dtype] = {
                "batches": batches, "requests_per_batch": CLIENTS * PER_CLIENT / batches,
                "fill": (after["real"] - samples["real"])
                / (after["dispatched"] - samples["dispatched"]),
                "max_abs_vs_predict_logits": max(w for _, w in results),
                "seconds": loop_s,
                "client_p50_ms": float(np.percentile(latencies, 50)),
                "client_p99_ms": float(np.percentile(latencies, 99)),
            }
    finally:
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
        serve.join(timeout=30)
    check(not serve.is_alive(), "packed server thread did not stop")
    sent = 2 * CLIENTS * PER_CLIENT
    check(metrics.completed == sent and metrics.failed == 0,
          f"packed server completed {metrics.completed} of {sent}, "
          f"failed {metrics.failed}")
    for dtype, r in rounds.items():
        check(r["requests_per_batch"] > 1.0,
              f"no {dtype} request coalesced: {r['batches']} batches")
    launches = ih.LAUNCHES
    check(launches > 0, "the main path never launched int8_head")
    emit({"phase": "server_packed", "clients": CLIENTS, "requests": sent,
          "completed": metrics.completed, "rounds": rounds,
          "launches_main_path": {"int8_head": launches}})

    # 6. times, at the ladder's small and top buckets
    k, h, o = fc1["weight_q"].shape[1], fc1["weight_q"].shape[0], fc2["weight_q"].shape[0]
    by_n = {}
    for n in TIMED_ROWS:
        f = feats[:n]
        kernel_ms = median_ms(torch, lambda: ih.fused_int8_head(fc1, fc2, f))
        plain_ms = median_ms(torch, lambda: ih.int8_head_reference(fc1, fc2, f))
        library_ms = None
        if n > 16:  # torch._int_mm takes more than 16 rows only
            a_max = f.abs().amax(dim=-1, keepdim=True)
            xq = torch.clamp(torch.round(f / (a_max / 127.0)), -127, 127).to(torch.int8)
            w1t = fc1["weight_q"].t().contiguous()
            library_ms = median_ms(torch, lambda: torch._int_mm(xq, w1t))
        bound_ms, bound_by = head_bound(n, k, h, o)
        by_n[str(n)] = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "times", "name": "int8_head", "by_n": by_n,
          "library": "torch._int_mm on the fc1 product alone (no single "
                     "PyTorch call computes the whole head)"})
    top = by_n[str(TIMED_ROWS[-1])]
    emit({"kernels": [{
        "name": "int8_head", "route": "cuda",
        "source": "pytorch_mnist_ddp_tpu_torch/csrc/int8_head.cu",
        "replaces": "pytorch_mnist_ddp_tpu/ops/pallas_infer.py:61",
        "launches": launches, "max_abs_err": max(kernel_err.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "rows": TIMED_ROWS[-1], "by_n": by_n,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
