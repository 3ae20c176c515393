"""Serving CLI: ``python -m pytorch_mnist_ddp_tpu_torch.serving``.

The JAX package's serving CLI: its flags, refusals and lines (the warmup
lines aside: they count rungs and kernel libraries, the port has no
traces or executables to count).
Startup order: validate the flags (a config error fails before the
engine is built), load the checkpoint, the registry's default version or
seed-init weights, warm every (dtype, bucket) rung, gate the
reduced-precision variants' parity against f32, and only then open the
HTTP socket — a server that accepted traffic before warmup would serve
its first requests at build-and-tune latency.  A failed gate refuses to
serve (exit 1).  ``--warmup-only`` stops after the gate.  SIGTERM/SIGINT
drain the queue and the in-flight window, then print the metrics report.

``--replicas N`` serves the replica pool (serving/pool.py): N engines,
replica i on ``cuda:(i % device_count)`` each on its own CUDA stream
(``0`` = one per visible card), behind the router (``--router-policy``,
``--hedge``/``--hedge-delay-ms``) and the replica supervisor
(``--no-supervise``, ``--stall-timeout-s``, ``--restart-budget``).
``--replica-shapes`` gives each replica's shape (``tp4,dp``: a tensor-
parallel replica over four cards beside a dp one; serving/sharded.py),
planned over the visible cards as JAX plans them: a plan that needs more
cards than there are exits 2 with JAX's planner error, before anything is
built.  Each sharded replica passes its parity gate against the
single-device forward before the socket opens.

The startup flags (``compile/``): ``--aot-cache DIR`` keeps the built
kernel libraries in a gated store (``compile/aot.py``; a warm start runs
no ``nvcc``; point it only at a directory you own: a library runs code
when loaded), shared by every replica; ``--cache-dir DIR`` moves the
build directory, a store of the same kind that reports no outcome
(``utils/compile_cache.py``); ``--serial-warmup`` warms a pool's
replicas one after another instead of together (one engine always warms
its rungs in turn, on its one stream); ``--no-device-stage`` stages
batches in pageable memory with a blocking copy.

``--fleet N`` makes this process the fleet's front (serving/fleet.py):
it imports no torch, spawns N backends (this CLI without the front's
flags, each on its own port, all on one ``--aot-cache`` store: the
operator's or a scratch one for the run), routes ``/predict`` under
``--router-policy``, replaces a dead or wedged backend
(``--fleet-restart-budget``, ``--fleet-heartbeat-timeout-s``,
``--fleet-ready-timeout-s``) and, with ``--autoscale``, adds and drains
backends between ``--scale-low`` and ``--scale-high``.
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
    parser.add_argument(
        "--aot-cache", default=None, metavar="DIR",
        help="keep the built kernel libraries in DIR (compile/aot.py "
        "ExecutableStore, shared by every replica, its hits and misses "
        "counted): a warm start loads them with no nvcc run, behind a "
        "gate that rebuilds on any source/torch/driver/card mismatch; "
        "use a directory you own",
    )
    parser.add_argument(
        "--cache-dir", default=None,
        help="the build directory's store, where the kernel libraries are "
        "built and loaded without --aot-cache (default: build/torch_kernels "
        "in the checkout); naming one "
        "explicitly also sets it up on the CPU, where nothing is built "
        "— same operator-intent semantics as the trainer CLIs' "
        "--compile-cache-dir",
    )
    parser.add_argument(
        "--serial-warmup", action="store_true",
        help="warm a pool's replicas one after another instead of "
        "concurrently; slower startup, deterministic build order (one "
        "engine warms its rungs in turn either way: it has one stream)",
    )
    parser.add_argument(
        "--no-device-stage", action="store_true",
        help="stage padded batches in pageable host memory and copy them "
        "to the card blocking, instead of from pinned buffers by a "
        "non_blocking copy on the engine's stream (the default)",
    )
    parser.add_argument(
        "--replicas", type=int, default=None, metavar="N",
        help="serve N engine replicas, replica i on cuda:(i %% cards), each "
        "on its own CUDA stream (0 = one per visible card; --device cuda:K "
        "puts every replica on card K; at most 32 a card), behind the "
        "queue-aware router; omitted = the single-engine path",
    )
    parser.add_argument(
        "--replica-shapes", default=None, metavar="SPEC",
        help="with --replicas: comma-separated per-replica shard shape, "
        "e.g. 'tp4,dp,dp,dp,dp' — tp/vtp/ep/pp replicas span disjoint "
        "k-card blocks of the visible cards and are parity-gated against "
        "the single-device reference at warmup; count must match the "
        "replica count",
    )
    parser.add_argument(
        "--router-policy", default="cost", choices=("roundrobin", "least-loaded", "cost"),
        help="replica placement policy with --replicas: roundrobin "
        "(load-blind baseline), least-loaded (queue depth + in-flight), "
        "or cost (expected time-to-answer from the per-replica latency "
        "EWMA; falls back to least-loaded until samples exist)",
    )
    parser.add_argument(
        "--hedge", action="store_true",
        help="with --replicas: hedged dispatch — re-submit a straggler "
        "request to a second replica once it has waited past its QoS "
        "class's online p99 (or --hedge-delay-ms), first completion "
        "wins with exactly one client-visible outcome",
    )
    parser.add_argument(
        "--hedge-delay-ms", type=float, default=None, metavar="MS",
        help="fixed hedge delay instead of the per-class p99 digest "
        "(implies --hedge; pool mode only)",
    )
    parser.add_argument(
        "--no-supervise", action="store_true",
        help="with --replicas: disable the replica supervisor "
        "(quarantine / backoff restart / ejection of replicas that "
        "fail, hang, or trip their circuit breaker)",
    )
    parser.add_argument(
        "--stall-timeout-s", type=float, default=5.0,
        help="supervisor completion-stall threshold: a replica whose "
        "oldest in-flight batch is older than this is quarantined",
    )
    parser.add_argument(
        "--restart-budget", type=int, default=3,
        help="consecutive failed supervisor restarts before a replica "
        "is permanently ejected from the pool",
    )
    parser.add_argument(
        "--fleet", type=int, default=None, metavar="N",
        help="run a multi-PROCESS serving fleet: this process becomes a "
        "torch-free front on --port that spawns N backend serving "
        "processes (each this same CLI on --fleet-base-port+i, sharing one "
        "AOT cache so replacements warm-start), routes /predict to them by "
        "--router-policy, liveness-probes and REPLACES dead or wedged "
        "backends under a seeded backoff restart budget, and (with "
        "--autoscale) adds/drains whole backends from the load signal",
    )
    parser.add_argument(
        "--fleet-base-port", type=int, default=None, metavar="PORT",
        help="first backend port with --fleet (default --port + 1; "
        "backend i listens on base+i, a replacement reuses its port)",
    )
    parser.add_argument(
        "--fleet-restart-budget", type=int, default=3,
        help="consecutive failed backend replacements before a backend "
        "is permanently ejected from the fleet",
    )
    parser.add_argument(
        "--fleet-heartbeat-timeout-s", type=float, default=10.0,
        help="a backend whose dispatch-loop heartbeat file is older "
        "than this is treated as wedged and replaced (0 disables; "
        "process death and /readyz probes still apply)",
    )
    parser.add_argument(
        "--fleet-ready-timeout-s", type=float, default=300.0,
        help="bring-up bound per backend (a cold start builds the kernel "
        "libraries; a warm start off the store runs no nvcc)",
    )
    parser.add_argument(
        "--autoscale", action="store_true",
        help="with --fleet: add a backend when the smoothed per-backend "
        "backlog breaches --scale-high for --scale-window-s, drain the "
        "newest at --scale-low (drain -> settle -> kill, nothing "
        "lost), with cooldown hysteresis and --scale-min/--scale-max "
        "bounds",
    )
    parser.add_argument(
        "--scale-high", type=float, default=8.0, metavar="DEPTH",
        help="autoscaler high-water mark: smoothed mean backlog "
        "(queue depth + in-flight) per active backend",
    )
    parser.add_argument(
        "--scale-low", type=float, default=1.0, metavar="DEPTH",
        help="autoscaler low-water mark (must be < --scale-high; the "
        "gap is the hysteresis band)",
    )
    parser.add_argument("--scale-min", type=int, default=1)
    parser.add_argument("--scale-max", type=int, default=4)
    parser.add_argument(
        "--scale-window-s", type=float, default=2.0,
        help="a watermark breach must sustain this long before acting",
    )
    parser.add_argument(
        "--scale-cooldown-s", type=float, default=10.0,
        help="minimum quiet time after any scale event",
    )
    return parser


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
    raw_argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(raw_argv)

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
    if args.fleet is not None:
        # The front is a control plane and a proxy: no engine, no
        # checkpoint, no torch.  It comes up at once and keeps working
        # when a backend (the part that owns the card) is what broke.
        # Delegate before anything imports torch.
        if args.fleet < 1:
            print(f"error: --fleet must be >= 1, got {args.fleet}")
            return 2
        if args.autoscale and args.scale_low >= args.scale_high:
            print(
                f"error: --scale-low {args.scale_low:g} must be < "
                f"--scale-high {args.scale_high:g} (the hysteresis band)"
            )
            return 2
        if args.autoscale and not (
            1 <= args.scale_min <= args.fleet <= args.scale_max
        ):
            # Before the backends' bring-up, not after it: the
            # autoscaler would refuse these only once every backend warmed.
            print(
                f"error: need 1 <= --scale-min ({args.scale_min}) <= "
                f"--fleet ({args.fleet}) <= --scale-max ({args.scale_max})"
            )
            return 2
        if args.warmup_only:
            # Passed through, every backend would warm and exit 0, and the
            # front would report an opaque bring-up failure.
            print("error: --warmup-only is a backend concern; run it "
                  "without --fleet")
            return 2
        from .fleet import run_fleet

        return run_fleet(args, raw_argv)
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
    hedge = args.hedge or args.hedge_delay_ms is not None
    if hedge and (args.replicas is None or args.replicas == 1):
        print("error: --hedge/--hedge-delay-ms need --replicas >= 2 (a "
              "lone replica has no second replica to hedge onto)")
        return 2
    pool_mode = args.replicas is not None
    if args.replica_shapes:
        if not pool_mode:
            print("error: --replica-shapes needs --replicas (a sharded "
                  "replica is a pool member)")
            return 2
        from .devices import parse_replica_shapes, plan_replica_meshes, visible_devices

        try:
            plan_replica_meshes(parse_replica_shapes(args.replica_shapes),
                                visible_devices(args.device))
        except ValueError as e:
            print(f"error: --replica-shapes {args.replica_shapes!r}: {e}")
            return 2

    import torch

    from ..liveness import Heartbeat
    from ..obs.events import open_sink
    from ..obs.spans import span
    from ..ops import _build
    from ..utils.compile_cache import enable_persistent_cache
    from .engine import InferenceEngine
    from .fleet import ENV_FLEET_HEARTBEAT_FILE
    from .metrics import ServingMetrics
    from .server import make_server

    if args.cache_dir is not None:
        # Before the first library loads, or the warmup misses it.
        cache_dir = enable_persistent_cache(args.cache_dir, force=True, device=args.device)
        print(f"persistent compile cache: {cache_dir}" if cache_dir else
              "persistent compile cache: disabled (cache dir not writable)")

    factory = InferenceEngine
    pool_kwargs = {}
    if pool_mode:
        from .pool import EnginePool

        factory = EnginePool
        pool_kwargs = dict(replicas=args.replicas or None,
                           replica_shapes=args.replica_shapes or None)
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
        aot_cache=args.aot_cache,
        device_stage=not args.no_device_stage,
        **pool_kwargs,
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
            engine = factory(registry.load(entry), version=entry.version, **engine_kwargs)
        except ValueError as e:
            print(f"error: --registry {args.registry}: {e}")
            return 2
    elif args.checkpoint:
        print(f"loading checkpoint {args.checkpoint}")
        engine = factory.from_checkpoint(args.checkpoint, **engine_kwargs)
    else:
        print(
            f"no --checkpoint; serving fresh seed-{args.seed} weights "
            "(smoke/load-test mode)"
        )
        engine = factory.from_seed(args.seed, **engine_kwargs)

    sink = open_sink(args.telemetry_dir)
    if sink:
        print(f"serving telemetry: {sink.path}")
    where = (f"x {engine.n_replicas} replicas (devices {[str(d) for d in engine.devices]})"
             if pool_mode else
             f"serially on {engine.device}")
    store_note = ""
    if args.aot_cache:
        store_note = f" ({'shared ' if pool_mode else ''}AOT cache {args.aot_cache})"
    print(
        f"warming buckets {list(engine.buckets)} x dtypes {list(engine.dtypes)} {where}"
        + (" (packed)" if engine.packed else "")
        + (" (BatchNorm checkpoint)" if engine.use_bn else "")
        + store_note
    )

    def on_rung(dtype, bucket, done, replica=None):
        tag = f"[{replica}] " if replica else ""
        print(f"  {tag}{dtype:>4s} bucket {bucket:4d}: ready ({done} rungs warmed)", flush=True)

    builds = _build.BUILDS
    # The warmup span, and the compile service's per-library and per-rung
    # compile spans, land in the JSONL telemetry (and on the registry
    # /metrics serves), so a cold start's cost is observable.
    from .engine import ParityError

    try:
        with span("warmup", sink=sink, registry=metrics.registry):
            engine.warmup(on_rung=on_rung, sink=sink, **(
                {"parallel": not args.serial_warmup} if pool_mode else {}))
    except ParityError as e:
        print(f"refusing to serve: {e}")
        sink.close()
        return 1
    for i, replica in enumerate(engine.engines if pool_mode else ()):
        gate = replica.parity_report.get("f32")
        if replica.shard_kind != "dp" and gate is not None:
            print(
                f"parity gate [r{i} {replica.shard_kind}{gate['devices']}]: PASS "
                f"(max|dlogp| {gate['max_abs_logit_diff']:.2e} <= {gate['tolerance']:g} "
                f"vs the single-device forward, argmax_identical=True, {gate['rows']} rows)"
            )
    n_replicas = engine.n_replicas if pool_mode else 1
    libraries = engine.libraries
    print(
        f"warmup verified: {n_replicas * len(engine.buckets) * len(engine.dtypes)} rungs "
        f"({len(engine.buckets)} buckets x {len(engine.dtypes)} dtypes"
        + (f" x {n_replicas} replicas" if pool_mode else "")
        + f"), {len(libraries)} kernel libraries ready"
        + (" (" + ", ".join(f"{lib}: {_build.origin(lib)}" for lib in libraries) + ")"
           if libraries else "")
        + f", {_build.BUILDS - builds} nvcc builds" + store_note
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
    # A fleet front that exported the heartbeat file reads the dispatch
    # loop's beats by the file's age; without it nothing is built.
    hb = Heartbeat.from_env(ENV_FLEET_HEARTBEAT_FILE)
    rollout = None
    if registry is not None:
        from .rollout import RolloutController

        rollout = RolloutController(registry, engine, metrics=metrics, sink=sink)
    batcher_kwargs = dict(
        linger_ms=args.linger_ms, queue_depth=args.queue_depth,
        timeout_ms=args.timeout_ms, max_inflight=args.max_inflight,
        adaptive_linger=not args.no_adaptive_linger,
        deadline_aware=not args.no_deadline_close,
        qos_weights=qos_weights,
        heartbeat=hb.beat if hb is not None else None,
        fill_wait_ms=args.fill_wait_ms,
    )
    server_kwargs = batcher_kwargs
    if pool_mode:
        server_kwargs = dict(batcher=engine.start(
            router_policy=args.router_policy, sink=sink,
            supervise=not args.no_supervise,
            supervisor_kwargs=dict(stall_timeout_s=args.stall_timeout_s,
                                   restart_budget=args.restart_budget),
            hedge=hedge, hedge_delay_ms=args.hedge_delay_ms,
            **batcher_kwargs,
        ))
    try:
        server = make_server(
            engine, metrics, host=args.host, port=args.port, sink=sink,
            request_timeout_s=args.request_timeout_s,
            response_cache=args.response_cache, rollout=rollout,
            **server_kwargs,
        )
    except BaseException:
        if pool_mode:
            engine.stop(drain=False)
        raise
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
        + (f"{engine.n_replicas} replicas, router policy "
           f"{args.router_policy}, supervisor "
           f"{'off' if args.no_supervise else 'on'}, hedging "
           # The resolved truth: the router does not hedge a one-replica
           # pool (--replicas 0 on a one-card host).
           + ("off, " if not (hedge and engine.n_replicas > 1) else (
               f"on ({args.hedge_delay_ms:g} ms), "
               if args.hedge_delay_ms is not None else "on (p99 digest), "))
           + "per-replica "
           if pool_mode else "")
        + f"in-flight window {args.max_inflight}, adaptive linger "
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
        if pool_mode:
            engine.stop(drain=True)  # the supervisor first, then the router
        else:
            server.batcher.stop(drain=True)
        server.server_close()
        sink.close()
        print(metrics.report_lines(
            queue_depth=server.batcher.depth(),
            compiles=_build.BUILDS,
            buckets=engine.buckets,
            inflight=server.batcher.inflight(),
            max_inflight=server.batcher.max_inflight,
            linger_ms=server.batcher.current_linger_ms,
        ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
