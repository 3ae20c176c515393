"""Serving CLI: ``python -m pytorch_mnist_ddp_tpu_torch.serving``.

The JAX package's single-engine serving CLI: its flags, refusals and
lines (the warmup lines aside: the port has no traces to count).
Startup order: validate the flags (a config error fails before the
engine is built), load the checkpoint, the registry's default version or
seed-init weights, warm every (dtype, bucket) rung, gate the
reduced-precision variants' parity against f32, and only then open the
HTTP socket — a server that accepted traffic before warmup would serve
its first requests at build-and-tune latency.  A failed gate refuses to
serve (exit 1).  ``--warmup-only`` stops after the gate.  SIGTERM/SIGINT
drain the queue and the in-flight window, then print the metrics report.

The replica pool, the fleet and the ``compile/`` analogue are not ported
yet: their flags parse and are refused with an explicit error (exit 2).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

# Flags of the JAX CLI this port refuses, by the part they belong to.
NOT_PORTED = {
    "the compile/ analogue (CUDA-graph capture, the AOT store, warm start)": (
        "--aot-cache", "--cache-dir", "--serial-warmup", "--no-device-stage"),
    "the replica pool": (
        "--replicas", "--replica-shapes", "--router-policy", "--hedge",
        "--hedge-delay-ms", "--no-supervise", "--stall-timeout-s", "--restart-budget"),
    "the serving fleet": (
        "--fleet", "--fleet-base-port", "--fleet-restart-budget",
        "--fleet-heartbeat-timeout-s", "--fleet-ready-timeout-s", "--autoscale",
        "--scale-high", "--scale-low", "--scale-min", "--scale-max",
        "--scale-window-s", "--scale-cooldown-s"),
}
_SWITCHES = ("--serial-warmup", "--no-device-stage", "--hedge", "--no-supervise",
             "--autoscale")


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
    parser.add_argument(
        "--registry", default=None, metavar="DIR",
        help="serve from a model registry directory: load the manifest's "
        'default (model, version), route the /predict "model"/"version" '
        "fields through it, and expose POST /admin/{swap,canary,rollback}. "
        "Mutually exclusive with --checkpoint",
    )
    parser.add_argument(
        "--canary", type=float, default=None, metavar="PCT",
        help="with --registry: start with a live canary serving the "
        "default model's HIGHEST non-default version to PCT%% of unpinned "
        "traffic (the payload-hash split of POST /admin/canary)",
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
        "--linger-ms", type=float, default=2.0,
        help="max time the batcher waits to coalesce a non-full batch "
        "(the adaptive controller's ceiling)",
    )
    parser.add_argument(
        "--max-inflight", type=int, default=2,
        help="batches launched but not yet read back",
    )
    parser.add_argument(
        "--no-adaptive-linger", action="store_true",
        help="pin the linger at --linger-ms instead of shrinking it toward "
        "0 while the admission queue is deep",
    )
    parser.add_argument(
        "--no-deadline-close", action="store_true",
        help="disable deadline-aware batch close (a forming batch "
        "dispatches once its oldest member's remaining deadline no longer "
        "covers the estimated service time)",
    )
    parser.add_argument(
        "--qos-weights", default=None, metavar="CLASS=W,...",
        help="weighted-round-robin service shares for the QoS admission "
        "queue (default interactive=4,batch=1); requests pick a class with "
        'the /predict "qos" field, and a full queue sheds the lowest '
        "class first",
    )
    parser.add_argument(
        "--response-cache", type=int, default=None, metavar="N",
        help="enable the content-addressed response cache with "
        "single-flight dedup, bounded at N entries; keyed on the weights "
        "digest, so a swap invalidates.  Off by default",
    )
    parser.add_argument(
        "--telemetry-dir", default=None,
        help="write serving JSONL telemetry (serving_request/serving_batch "
        "events, pad/dispatch/complete spans, the warmup span) into this "
        "directory",
    )
    parser.add_argument(
        "--queue-depth", type=int, default=64,
        help="admission queue bound; a full queue sheds or rejects with 503",
    )
    parser.add_argument(
        "--timeout-ms", type=float, default=1000.0,
        help="per-request deadline (queued past it -> 504)",
    )
    parser.add_argument(
        "--request-timeout-s", type=float, default=30.0,
        help="handler-connection socket timeout: a client that connects "
        "and goes silent is closed (or answered 408 mid-body) within "
        "this bound",
    )
    parser.add_argument(
        "--bf16", action="store_true",
        help="serve the DEFAULT forward in bfloat16 (parameters stay f32, "
        "the log_softmax tail f32); for a gated bf16 variant BESIDE the "
        "f32 path use --dtypes",
    )
    parser.add_argument(
        "--dtypes", default="f32",
        help="comma-separated serving variants (f32,bf16,int8); each "
        "reduced-precision variant must pass its parity gate before the "
        'server starts, and requests select one with the /predict "dtype" '
        "field",
    )
    parser.add_argument(
        "--conv-impl", default="conv",
        help="convolution lowering of the f32/bf16 forwards, as in "
        "training (conv, im2col_c1, im2col)",
    )
    parser.add_argument(
        "--int8-impl", default="pallas", choices=("dot", "pallas"),
        help="int8 dense head: 'pallas' = the fused CUDA kernel "
        "(csrc/int8_head.cu), 'dot' = two library int8 GEMMs "
        "(torch._int_mm)",
    )
    parser.add_argument(
        "--packed", action="store_true",
        help="packed ragged batching: one rows-capacity buffer plus a "
        "segment-id vector instead of a pow2 bucket per batch; a request "
        "that overflows the forming batch is split",
    )
    parser.add_argument(
        "--fill-wait-ms", type=float, default=None,
        help="packed mode: how long a forming batch waits for more rows "
        "(replaces the linger ceiling)",
    )
    parser.add_argument(
        "--warmup-only", action="store_true",
        help="warm every rung, run the parity gates, exit without serving",
    )
    for part, flags in NOT_PORTED.items():
        for flag in flags:
            kwargs = (dict(action="store_const", const=True) if flag in _SWITCHES
                      else dict(metavar="X"))
            parser.add_argument(flag, default=None,
                                help=f"not ported yet ({part}); refused", **kwargs)
    return parser


def _not_ported(args) -> str | None:
    for part, flags in NOT_PORTED.items():
        for flag in flags:
            if getattr(args, flag[2:].replace("-", "_")) is not None:
                return (f"error: {flag} is not ported to the PyTorch/CUDA "
                        f"serving CLI yet ({part}); run without it")
    return None


def _parse_qos_weights(spec: str) -> tuple[dict[str, int] | None, str | None]:
    """``CLASS=INT,...`` -> (weights, None), or (None, the error line)."""
    from .qos import QOS_CLASSES

    try:
        weights = {name.strip(): int(w)
                   for name, w in (part.split("=") for part in spec.split(","))}
    except ValueError:
        return None, (f"error: --qos-weights {spec!r} must be "
                      "CLASS=INT[,CLASS=INT...] (e.g. interactive=4,batch=1)")
    unknown = sorted(set(weights) - set(QOS_CLASSES))
    bad = sorted(n for n, w in weights.items() if w < 1)
    if unknown or bad:
        return None, (
            f"error: --qos-weights {spec!r}: "
            + (f"unknown class(es) {unknown} (have {list(QOS_CLASSES)})" if unknown else "")
            + ("; " if unknown and bad else "")
            + (f"weight(s) must be >= 1 for {bad}" if bad else "")
        )
    return weights, None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    refused = _not_ported(args)
    if refused:
        print(refused)
        return 2
    if args.response_cache is not None and args.response_cache < 1:
        print(f"error: --response-cache must be >= 1, got {args.response_cache}")
        return 2
    if args.registry and args.checkpoint:
        print("error: --registry and --checkpoint are mutually exclusive "
              "(the registry's manifest names the checkpoint)")
        return 2
    if args.canary is not None:
        if not args.registry:
            print("error: --canary needs --registry (the canary version "
                  "comes from the manifest)")
            return 2
        if not 0.0 < args.canary <= 100.0:
            print(f"error: --canary must be in (0, 100], got {args.canary:g}")
            return 2
    dtypes = [d.strip() for d in args.dtypes.split(",") if d.strip()]
    if args.bf16 and any(d != "f32" for d in dtypes):
        print(
            "error: --bf16 (bf16 DEFAULT forward) cannot combine with "
            "--dtypes variants — the parity gates would lose their f32 "
            "reference; drop --bf16 and add bf16 to --dtypes instead"
        )
        return 2
    qos_weights = None
    if args.qos_weights:
        qos_weights, error = _parse_qos_weights(args.qos_weights)
        if error:
            print(error)
            return 2

    import torch

    from ..liveness import Heartbeat
    from ..obs.events import open_sink
    from ..obs.spans import span
    from .engine import InferenceEngine
    from .metrics import ServingMetrics
    from .server import make_server

    metrics = ServingMetrics()
    engine_kwargs = dict(
        device=args.device,
        buckets=[int(b) for b in args.buckets.split(",")] if args.buckets else None,
        max_bucket=None if args.buckets else args.max_bucket,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        conv_impl=args.conv_impl,
        dtypes=[d for d in dtypes if d != "f32"],
        packed=args.packed,
        metrics=metrics,
        int8_impl=args.int8_impl,
    )
    registry = entry = canary_version = None
    if args.registry:
        from .registry import ModelRegistry

        registry = ModelRegistry(args.registry)
        try:
            entry = registry.resolve()
            if args.canary is not None:
                candidates = [v for v in registry.versions(entry.model)
                              if v != entry.version]
                if not candidates:
                    print(
                        f"error: --canary needs a second registered "
                        f"version of {entry.model!r}; the manifest only "
                        f"has {entry.version!r}"
                    )
                    return 2
                canary_version = candidates[-1]
            print(
                f"registry {args.registry}: serving "
                f"{entry.model}@{entry.version} (digest {entry.digest[:12]})"
            )
            engine = InferenceEngine(registry.load(entry), version=entry.version,
                                     **engine_kwargs)
        except ValueError as e:
            print(f"error: --registry {args.registry}: {e}")
            return 2
    elif args.checkpoint:
        print(f"loading checkpoint {args.checkpoint}")
        engine = InferenceEngine.from_checkpoint(args.checkpoint, **engine_kwargs)
    else:
        print(
            f"no --checkpoint; serving fresh seed-{args.seed} weights "
            "(smoke/load-test mode)"
        )
        engine = InferenceEngine.from_seed(args.seed, **engine_kwargs)

    sink = open_sink(args.telemetry_dir)
    if sink:
        print(f"serving telemetry: {sink.path}")
    print(
        f"warming buckets {list(engine.buckets)} x dtypes {list(engine.dtypes)} "
        f"on {engine.device}" + (" (packed)" if engine.packed else "")
        + (" (BatchNorm checkpoint)" if engine.use_bn else "")
    )
    with span("warmup", sink=sink, registry=metrics.registry):
        engine.warmup(
            on_rung=lambda dtype, bucket, done: print(
                f"  {dtype:>4s} bucket {bucket:4d}: ready ({done} rungs warmed)",
                flush=True,
            )
        )
    gates = engine.verify_parity(sink=sink)
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
        sink.close()
        return 1
    if args.warmup_only:
        sink.close()
        return 0
    # A supervisor that exported SERVE_HEARTBEAT_FILE reads the dispatch
    # loop's beats by the file's age; without it nothing is built.
    hb = Heartbeat.from_env("SERVE_HEARTBEAT_FILE")
    rollout = None
    if registry is not None:
        from .rollout import RolloutController

        rollout = RolloutController(registry, engine, metrics=metrics, sink=sink)
    server = make_server(
        engine, metrics, host=args.host, port=args.port, sink=sink,
        request_timeout_s=args.request_timeout_s,
        response_cache=args.response_cache, rollout=rollout,
        linger_ms=args.linger_ms, queue_depth=args.queue_depth,
        timeout_ms=args.timeout_ms, max_inflight=args.max_inflight,
        adaptive_linger=not args.no_adaptive_linger,
        deadline_aware=not args.no_deadline_close,
        qos_weights=qos_weights,
        heartbeat=hb.beat if hb is not None else None,
        fill_wait_ms=args.fill_wait_ms,
    )
    if rollout is not None and canary_version is not None:
        rollout.start_canary(canary_version, args.canary)
        print(
            f"canary: {entry.model}@{canary_version} at "
            f"{args.canary:g}% of unpinned traffic (deterministic "
            "payload-hash split, auto-rollback armed)"
        )
    if args.response_cache:
        print(
            f"response cache: {args.response_cache} entries "
            f"(weights digest {engine.weights_digest[:12]}, "
            "single-flight dedup on)"
        )
    host, port = server.server_address[:2]
    print(
        f"serving on http://{host}:{port} (POST /predict, GET /metrics, "
        "GET /healthz liveness, GET /readyz readiness; "
        f"in-flight window {args.max_inflight}, adaptive linger "
        f"{'off' if args.no_adaptive_linger else 'on'}, deadline close "
        f"{'off' if args.no_deadline_close else 'on'})",
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
        sink.close()
        print(metrics.report_lines(
            queue_depth=server.batcher.depth(),
            buckets=engine.buckets,
            inflight=server.batcher.inflight(),
            max_inflight=server.batcher.max_inflight,
            linger_ms=server.batcher.current_linger_ms,
        ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
