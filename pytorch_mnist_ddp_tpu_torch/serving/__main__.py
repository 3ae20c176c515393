"""Serving CLI: ``python -m pytorch_mnist_ddp_tpu_torch.serving``.

Startup order: load the checkpoint (or seed-init weights), warm every
(dtype, bucket) rung, gate the int8 variant's parity against f32, and only
then open the HTTP socket — a server that accepted traffic before warmup
would serve its first requests at build-and-tune latency.  A failed gate
refuses to serve (exit 1).  ``--warmup-only`` stops after the gate.
SIGTERM/SIGINT drain the queue and the in-flight window, then print the
metrics report.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.serving",
        description="MNIST inference server (PyTorch/CUDA): dynamic "
        "micro-batching over power-of-two batch buckets",
    )
    parser.add_argument(
        "--checkpoint", default=None,
        help="trained model to serve: a --save-model file (torch .pt or npz) "
        "or a --save-state archive; omitted = fresh seed-init weights",
    )
    parser.add_argument(
        "--seed", type=int, default=1,
        help="init seed (torch.Generator) when no --checkpoint is given",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--buckets", default=None,
        help="comma-separated batch-size ladder (powers of two); default: "
        "powers of two up to --max-bucket",
    )
    parser.add_argument(
        "--max-bucket", type=int, default=None,
        help="top of the default bucket ladder (default 128)",
    )
    parser.add_argument(
        "--dtypes", default="f32",
        help="comma-separated serving variants (f32,int8); int8 must pass its "
        "parity gate before the server starts, and requests select it with "
        'the /predict "dtype" field',
    )
    parser.add_argument(
        "--packed", action="store_true",
        help="packed ragged batching: one rows-capacity buffer plus a "
        "segment-id vector instead of a pow2 bucket per batch",
    )
    parser.add_argument(
        "--fill-wait-ms", type=float, default=None,
        help="packed mode: how long a forming batch waits for more rows "
        "(replaces --linger-ms)",
    )
    parser.add_argument(
        "--linger-ms", type=float, default=2.0,
        help="max time the batcher waits to coalesce a non-full batch",
    )
    parser.add_argument(
        "--queue-depth", type=int, default=64,
        help="admission queue bound; a full queue rejects with 503",
    )
    parser.add_argument(
        "--timeout-ms", type=float, default=1000.0,
        help="per-request deadline (queued past it -> 504)",
    )
    parser.add_argument(
        "--max-inflight", type=int, default=2,
        help="batches launched but not yet read back",
    )
    parser.add_argument(
        "--warmup-only", action="store_true",
        help="warm every rung, run the parity gate, exit without serving",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from .engine import InferenceEngine
    from .metrics import ServingMetrics
    from .server import make_server

    metrics = ServingMetrics()
    dtypes = [d.strip() for d in args.dtypes.split(",") if d.strip()]
    engine_kwargs = dict(
        device=args.device,
        buckets=[int(b) for b in args.buckets.split(",")] if args.buckets else None,
        max_bucket=None if args.buckets else args.max_bucket,
        dtypes=[d for d in dtypes if d != "f32"],
        packed=args.packed,
        metrics=metrics,
    )
    if args.checkpoint:
        print(f"loading checkpoint {args.checkpoint}")
        engine = InferenceEngine.from_checkpoint(args.checkpoint, **engine_kwargs)
    else:
        print(
            f"no --checkpoint; serving fresh seed-{args.seed} weights "
            "(smoke/load-test mode)"
        )
        engine = InferenceEngine.from_seed(args.seed, **engine_kwargs)
    print(
        f"warming buckets {list(engine.buckets)} x dtypes {list(engine.dtypes)} "
        f"on {engine.device}" + (" (packed)" if engine.packed else "")
    )
    engine.warmup(
        on_rung=lambda dtype, bucket, done: print(
            f"  {dtype:>4s} bucket {bucket:4d}: ready ({done} rungs warmed)",
            flush=True,
        )
    )
    gates = engine.verify_parity()
    for name, result in gates.items():
        print(
            f"parity gate [{name}]: "
            + ("PASS" if result["passed"] else "FAIL")
            + f" (max|dlogit| {result['max_abs_logit_diff']:.2e} <= "
            f"{result['tolerance']:g}, argmax_identical="
            f"{result['argmax_identical']}, {result['rows']} rows)"
        )
    failed = [name for name, r in gates.items() if not r["passed"]]
    if failed:
        print(
            f"refusing to serve: variants {failed} failed their parity gate "
            "(near-untrained weights put real ties inside the quantization "
            "error; serve a trained checkpoint, or drop the variant from "
            "--dtypes)"
        )
        return 1
    if args.warmup_only:
        return 0
    server = make_server(
        engine, metrics, host=args.host, port=args.port,
        linger_ms=args.linger_ms, queue_depth=args.queue_depth,
        timeout_ms=args.timeout_ms, max_inflight=args.max_inflight,
        fill_wait_ms=args.fill_wait_ms,
    )
    host, port = server.server_address[:2]
    print(
        f"serving on http://{host}:{port} (POST /predict, GET /metrics, "
        f"GET /healthz, GET /readyz; in-flight window {args.max_inflight})",
        flush=True,
    )

    def _shutdown(signum, frame):
        # serve_forever must be unblocked from another thread; the drain
        # runs below, after the accept loop exits.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        server.serve_forever()
    finally:
        print("draining admitted requests and the in-flight window...")
        server.batcher.stop(drain=True)
        server.server_close()
        print(server.metrics.report_lines(
            queue_depth=server.batcher.depth(),
            buckets=engine.buckets,
            inflight=server.batcher.inflight(),
            max_inflight=server.batcher.max_inflight,
        ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
