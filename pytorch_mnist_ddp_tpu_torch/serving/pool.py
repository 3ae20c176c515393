"""EnginePool: InferenceEngine replicas behind the router (the JAX
package's ``serving/pool.py``).

Everything a single-engine deployment does — the bucket-warmed forward,
the dtype variants behind their parity gates, the pipelined micro-batcher
— once per replica, with :class:`~.router.Router` in front as the one
admission surface.

- **Placement.**  Replica ``i`` runs on ``cuda:(i % device_count)``
  (serving/devices.py; ``replicas=None`` is one per visible card, and
  ``device="cpu"`` builds the pool on the CPU).  Each replica's engine
  owns a CUDA stream, so two replicas sharing a card each stage, compute
  and read back on their own stream.  The checkpoint is read once on the
  host; each engine places its own copy of the weights.
- **One shared store.**  With ``aot_cache`` every replica's engine
  loads its kernel libraries through one
  :class:`~..compile.ExecutableStore`: the first replica to need a
  library loads (or builds) it, the others reuse the process's copy, so a
  warm pool start runs no ``nvcc`` and records one outcome a library.  A
  store entry is a library, not a (replica, dtype, bucket) rung, so the
  JAX pool's store sizing (``_check_store_sizing``) has no counterpart.
- **Elasticity.**  ``drain(name)`` delegates to the router (unroutable
  first, then the batcher's drain); the engine stays warm, so ``add(name)``
  builds only a fresh batcher: no warmup rung, no kernel build, no parity
  gate.
- **Supervision.**  ``start()`` also runs a :class:`ReplicaSupervisor`:
  a replica that fails consecutive launches, trips its circuit breaker or
  stalls its completion worker is quarantined (batcher aborted, its
  requests retried on survivors) and restarted around its warm engine
  after a seeded backoff; a spent restart budget ejects it.

The pool exposes the single-engine surface the server and the rollout
controller read (``buckets``/``dtypes``/``variant_verified``/``warmed``/
``weights_digest``/``publish_weights``...), so ``make_server(pool,
metrics, batcher=router)`` is the whole wiring difference between one
replica and eight.

Heterogeneous pools (``replica_shapes="tp4,dp"``): each entry is one
replica's shard topology, a sharded replica one engine over ``k``
devices (serving/sharded.py), planned as JAX plans them
(``devices.plan_replica_meshes``: disjoint consecutive blocks, too few
devices refused).  Every sharded replica is held to the single-device
forward by its parity gate at the end of :meth:`warmup` and cannot serve
before that passes.  One pool serves one checkpoint, so the ViT kinds
(``vtp``, ``ep``) do not mix with the CNN ones, nor ``vtp`` with ``ep``;
a sharded plan serves f32 only; the ladder's floor rises to an EP
replica's row shards and a pipeline's microbatches.  ``devices=`` (JAX's
argument) gives the device list to plan over: ``[cuda:0] * k`` runs a
``k``-way replica's shards one after another on one card.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Sequence

import torch

from ..compile import ExecutableStore
from ..liveness import BackoffLadder
from .batcher import MicroBatcher
from . import sharded
from .buckets import DEFAULT_MAX_BUCKET, packed_capacities, pow2_buckets
from .devices import (
    parse_replica_shapes,
    plan_replica_meshes,
    replica_devices,
    replica_mesh,
    visible_devices,
)
from .engine import InferenceEngine, UnverifiedVariantError
from .faults import fault_point
from .metrics import ServingMetrics
from .router import Replica, Router


def _check_own_streams(engines: Sequence[InferenceEngine]) -> None:
    """Raise if two replicas on one card got the same CUDA stream.
    ``torch.cuda.Stream`` takes the next of a card's 32 pooled streams, so
    past 32 streams a card two replicas would share one and serialize
    behind each other: a completion wait would then time the other
    replica's batch, and the supervisor's stall check would blame the
    wrong replica.  A sharded replica's shard streams count too."""
    seen: dict = {}
    for i, engine in enumerate(engines):
        for stream in getattr(engine, "streams", (engine.stream,)):
            if stream is None:
                continue
            device = getattr(stream, "device", engine.device)
            key = (device, stream.cuda_stream)
            if key in seen:
                raise ValueError(
                    f"replicas {_replica_name(seen[key])} and {_replica_name(i)} share a "
                    f"CUDA stream on {device}: PyTorch hands out 32 streams a card, "
                    "so serve at most 32 replicas (and shards) a card"
                )
            seen[key] = i


def _replica_name(i: int) -> str:
    """Replica names are positional and stable across drain/add cycles:
    r0..rN-1, the labels on every per-replica metric family."""
    return f"r{i}"


class _ReplicaWatch:
    """Supervisor-side bookkeeping for one replica's restart ladder."""

    __slots__ = (
        "attempts", "restarts", "next_restart_t", "quarantined_at",
        "backoff_s", "recovery_s",
    )

    def __init__(self):
        self.attempts = 0          # restarts since the last healthy spell
        self.restarts = 0          # lifetime restarts (the counter's twin)
        self.next_restart_t: float | None = None
        self.quarantined_at: float | None = None
        self.backoff_s = 0.0
        self.recovery_s: list[float] = []


class ReplicaSupervisor:
    """Watches replica health, quarantines the sick, restarts with
    backoff, ejects the incurable.

    The control-plane half of fault tolerance (the data-plane half is
    the router's per-replica :class:`~.router.CircuitBreaker`): a
    polling thread reads three health signals per active replica —

    - **circuit open** — the breaker tripped on consecutive batch
      failures (the fast path already stopped placement);
    - **launch-failure streak** — ``batcher.consecutive_launch_failures``
      at/above ``failure_threshold`` (covers a replica the breaker has
      not tripped yet, e.g. failures interleaved with successes on
      other dtypes);
    - **completion stall** — the oldest launched-but-unread batch older
      than ``stall_timeout_s`` (a wedged device or hung D2H read; the
      chaos harness's ``hang`` op injects exactly this).

    A sick replica is **quarantined**: circuit forced open, batcher
    aborted (queued + in-flight requests complete with
    ``ReplicaDeadError`` → handlers retry on survivors), then
    **restarted** after an exponential backoff with seeded jitter — the
    restart rebuilds only the batcher around the still-warm engine, so
    it runs no warmup rung and builds no kernel (pinned in
    tests/test_torch_pool.py).  The circuit re-admits via half-open trial
    requests.  ``restart_budget``
    consecutive failed recoveries escalate to permanent **ejection**.

    Decoupled from :class:`EnginePool` on purpose: the supervisor needs
    only a router, a ``make_batcher(replica) -> started MicroBatcher``
    factory, and somewhere to record — so tests drive it against fake
    batchers at interactive speed (tests/test_torch_router.py).
    """

    def __init__(
        self,
        router: Router,
        make_batcher,
        registry=None,
        sink=None,
        interval_s: float = 0.1,
        stall_timeout_s: float = 5.0,
        failure_threshold: int = 3,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 10.0,
        backoff_jitter: float = 0.25,
        restart_budget: int = 3,
        seed: int = 0,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.router = router
        self.make_batcher = make_batcher
        self.interval_s = interval_s
        self.stall_timeout_s = stall_timeout_s
        self.failure_threshold = max(1, failure_threshold)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.restart_budget = max(0, restart_budget)
        self._registry = registry
        self._sink = sink
        # Seeded: backoff jitter must not make two chaos runs diverge
        # (liveness.py, the ladder every supervisor climbs).
        self._ladder = BackoffLadder(
            base_s=backoff_base_s, max_s=backoff_max_s,
            jitter=backoff_jitter, seed=seed,
        )
        self._watch: dict[str, _ReplicaWatch] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._thread = threading.Thread(
            target=self._run, name="serve-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # The supervisor must outlive any single bad tick (a
                # replica torn down mid-inspection): skipping one beat
                # is recoverable, a dead supervisor is not.
                pass

    # -- the state machine ----------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        """One inspection pass (public so tests can step deterministically
        without the polling thread)."""
        now = now if now is not None else time.perf_counter()
        for replica in list(self.router.replicas):
            watch = self._watch.setdefault(replica.name, _ReplicaWatch())
            if replica.state == "active":
                reason = self._sick_reason(replica)
                if reason is not None:
                    self._quarantine(replica, watch, reason, now)
                elif (
                    watch.attempts
                    and replica.breaker is not None
                    and replica.breaker.state == "closed"
                ):
                    # Healed (a trial passed and traffic flows): the next
                    # incident starts a fresh backoff ladder instead of
                    # inheriting this one's escalation.
                    watch.attempts = 0
            elif (
                replica.state == "quarantined"
                and watch.next_restart_t is not None
                and now >= watch.next_restart_t
            ):
                self._restart(replica, watch, now)

    def _sick_reason(self, replica: Replica) -> str | None:
        if replica.breaker is not None and replica.breaker.state == "open":
            return "circuit_open"
        batcher = replica.batcher
        if (getattr(batcher, "consecutive_launch_failures", 0)
                >= self.failure_threshold):
            return "launch_failures"
        age = getattr(batcher, "oldest_inflight_age", lambda: 0.0)()
        if age > self.stall_timeout_s:
            return "completion_stall"
        return None

    def _backoff(self, attempts: int) -> float:
        """Exponential backoff with seeded jitter for the given rung of
        the ladder (``attempts`` completed restart attempts)."""
        return self._ladder.delay_s(attempts)

    def _quarantine(self, replica, watch, reason, now) -> None:
        if watch.attempts >= self.restart_budget:
            self._eject(replica, watch, reason)
            return
        flushed = self.router.quarantine(replica.name, reason=reason)
        backoff = self._backoff(watch.attempts)
        watch.quarantined_at = now
        watch.next_restart_t = now + backoff
        watch.backoff_s = backoff
        # The router already emitted replica_quarantine; log the
        # schedule here so the backoff ladder is reconstructible.
        if self._sink:
            self._sink.emit(
                "replica_restart_scheduled", replica=replica.name,
                reason=reason, attempt=watch.attempts + 1,
                backoff_s=backoff, flushed=flushed,
            )

    def _restart(self, replica, watch, now) -> None:
        watch.attempts += 1
        with self.router._lock:
            replica.state = "restarting"
        try:
            batcher = self.make_batcher(replica)
        except Exception as e:
            # Engine/batcher rebuild failed outright (not a traffic
            # failure).  The budget applies HERE too: _quarantine's
            # check is only reachable from state "active" (a restart
            # that succeeded and re-sickened), so without this a
            # make_batcher that always raises would cycle
            # quarantined→restarting forever — never ejected, never
            # settled (ejection follows restart_budget consecutive
            # failed recoveries).
            if watch.attempts >= self.restart_budget:
                if self._sink:
                    self._sink.emit(
                        "replica_restart", replica=replica.name,
                        attempt=watch.attempts, outcome="restart_failed",
                        error=f"{type(e).__name__}: {e}",
                    )
                self._eject(replica, watch, "restart_failed")
                return
            with self.router._lock:
                replica.state = "quarantined"
            # attempts was already incremented for this try, so the
            # next wait climbs one rung up the same ladder.
            backoff = self._backoff(watch.attempts)
            watch.next_restart_t = now + backoff
            watch.backoff_s = backoff
            if self._sink:
                self._sink.emit(
                    "replica_restart", replica=replica.name,
                    attempt=watch.attempts, outcome="restart_failed",
                    error=f"{type(e).__name__}: {e}", backoff_s=backoff,
                )
            return
        self.router.attach(replica.name, batcher)
        if replica.breaker is not None:
            replica.breaker.half_open()
        watch.restarts += 1
        watch.next_restart_t = None
        recovery = (
            now - watch.quarantined_at
            if watch.quarantined_at is not None else 0.0
        )
        watch.recovery_s.append(recovery)
        if self._registry is not None:
            self._registry.counter(
                "serving_replica_restarts_total",
                help="supervisor restarts per replica (fresh batcher "
                "around the still-warm engine; no warmup rung)",
                replica=replica.name,
            ).inc()
        if self._sink:
            self._sink.emit(
                "replica_restart", replica=replica.name,
                attempt=watch.attempts, backoff_s=watch.backoff_s,
                recovery_s=recovery, outcome="restarted",
            )

    def _eject(self, replica, watch, reason) -> None:
        with self.router._lock:
            replica.state = "ejected"
        if replica.breaker is not None:
            replica.breaker.force_open("ejected")
        # Same teardown quarantine gives a sick replica: queued and
        # in-flight requests complete with ReplicaDeadError so their
        # handlers retry on survivors instead of idling out their full
        # deadline — ejection is permanent, so nobody else will ever
        # flush this batcher (Router.stop skips ejected replicas, and
        # abort makes that stop a no-op anyway).
        flushed = replica.batcher.abort()
        watch.next_restart_t = None
        if self._sink:
            self._sink.emit(
                "replica_eject", replica=replica.name, reason=reason,
                attempts=watch.attempts, flushed=flushed,
            )

    # -- reads ----------------------------------------------------------------

    def stats(self) -> dict:
        """Per-replica restart/recovery accounting plus the pooled
        recovery times."""
        per_replica = {
            name: {
                "restarts": w.restarts,
                "attempts_since_healthy": w.attempts,
                "recovery_s": list(w.recovery_s),
            }
            for name, w in self._watch.items()
        }
        all_recoveries = [
            s for w in self._watch.values() for s in w.recovery_s
        ]
        return {
            "replicas": per_replica,
            "restarts_total": sum(
                w.restarts for w in self._watch.values()
            ),
            "mean_recovery_s": (
                sum(all_recoveries) / len(all_recoveries)
                if all_recoveries else None
            ),
        }


class EnginePool:
    """Per-device :class:`~.engine.InferenceEngine` replicas of one
    checkpoint.

    Parameters mirror the engine's where they mean the same thing.
    ``replicas`` is the pool size (``None``: one per visible device of
    ``device``; ``cuda:K`` pins every replica to card K), ``devices`` an
    explicit device list to plan over instead, and ``replica_shapes`` a
    plan such as ``"tp4,dp"`` (its length must agree with ``replicas``;
    module docstring), with ``vit_cfg`` and ``pp_microbatches`` for its
    sharded replicas.  Replicas that share a card must each get streams of
    their own, and PyTorch hands out 32 a card in turn: more than that on
    one card raise.  ``aot_cache`` (a directory or a store) is shared by
    every replica; ``device_stage`` is each engine's.
    """

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor],
        replicas: int | None = None,
        device: str | torch.device | None = None,
        buckets: Sequence[int] | None = None,
        max_bucket: int | None = None,
        dtypes: Sequence[str] = (),
        metrics: ServingMetrics | None = None,
        conv_impl: str = "conv",
        compute_dtype: torch.dtype | None = None,
        version: str = "",
        packed: bool = False,
        int8_impl: str = "pallas",
        replica_shapes=None,
        aot_cache: str | ExecutableStore | None = None,
        device_stage: bool = True,
        devices: Sequence[torch.device] | None = None,
        vit_cfg=None,
        pp_microbatches: int = 2,
    ):
        pool = list(devices) if devices is not None else visible_devices(device)
        if replica_shapes is not None:
            shapes = parse_replica_shapes(replica_shapes)
            if replicas is not None and replicas != len(shapes):
                raise ValueError(
                    f"replicas={replicas} disagrees with the "
                    f"{len(shapes)}-entry replica_shapes plan; pass one "
                    "or the other"
                )
            kinds = {kind for kind, _ in shapes}
            vit_kinds = kinds & {"vtp", "ep"}
            if vit_kinds and kinds - vit_kinds:
                raise ValueError(
                    f"replica plan mixes the ViT families {sorted(vit_kinds)} "
                    f"with CNN kinds {sorted(kinds - vit_kinds)}; one pool "
                    "serves one checkpoint, so every replica must serve "
                    "the same model family"
                )
            if len(vit_kinds) > 1:
                raise ValueError(
                    "replica plan mixes 'vtp' (dense ViT) and 'ep' "
                    "(MoE-ViT); those are different param trees"
                )
            if kinds != {"dp"} and dtypes:
                raise ValueError(
                    f"sharded replica shapes serve f32 only; drop dtypes="
                    f"{tuple(dtypes)} (the parity anchor is the single-"
                    "device f32 forward)"
                )
            plans = [(kind, mesh) for kind, _, mesh in plan_replica_meshes(shapes, pool)]
        else:
            plans = [("dp", replica_mesh("dp", 1, [dev])) for dev in replica_devices(replicas, pool)]
        # The ladder's floor: an EP replica splits every bucket over its
        # row shards, a pipeline into its microbatches.  Resolved once, so
        # every replica warms the same rungs.
        n_min = max([1] + [mesh.data for _, mesh in plans]
                    + [int(pp_microbatches) for kind, _ in plans if kind == "pp"])
        if buckets is None:
            buckets = pow2_buckets(max_bucket or DEFAULT_MAX_BUCKET, n_min)
            max_bucket = None
        if packed:
            buckets = packed_capacities(max(buckets), n_min)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.store = aot_cache
        if aot_cache is not None and not isinstance(aot_cache, ExecutableStore):
            self.store = ExecutableStore(aot_cache, registry=self.metrics.registry)
        self.engines = [
            InferenceEngine(
                state_dict, mesh=mesh, shard_kind=kind, buckets=buckets, max_bucket=max_bucket,
                compute_dtype=compute_dtype, conv_impl=conv_impl, dtypes=tuple(dtypes),
                packed=packed, metrics=self.metrics, int8_impl=int8_impl, version=version,
                aot_cache=self.store, device_stage=device_stage, vit_cfg=vit_cfg,
                pp_microbatches=pp_microbatches,
            )
            for kind, mesh in plans
        ]
        _check_own_streams(self.engines)
        self.devices = [e.device for e in self.engines]
        # The topology, scrapeable from the first exposition.
        for i, engine in enumerate(self.engines):
            self.metrics.record_shard_devices(_replica_name(i), len(engine.mesh.devices))
            if engine.shard_kind == "ep":
                self.metrics.ensure_expert_load(engine._vit_cfg.num_experts)
        self.router: Router | None = None
        self.supervisor: ReplicaSupervisor | None = None
        self._batcher_kwargs: dict = {}
        self._sink = None
        self._add_lock = threading.Lock()
        self._rung_lock = threading.Lock()

    # -- construction helpers ---------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "EnginePool":
        """Read the checkpoint ONCE on the host; each replica places it."""
        from ..utils.checkpoint import load_inference_state

        return cls(load_inference_state(path), **kwargs)

    @classmethod
    def from_seed(cls, seed: int = 1, **kwargs) -> "EnginePool":
        """Seed-``seed`` weights from ``torch.Generator`` (the engine's
        ``from_seed``), shared by every replica, of the family the replica
        shapes imply: the CNN for dp/tp/pp, the ViT for vtp, the MoE ViT
        for ep (the constructor refuses a plan that mixes them)."""
        raw = kwargs.get("replica_shapes")
        kinds = {kind for kind, _ in parse_replica_shapes(raw)} if raw else set()
        family = "ep" if "ep" in kinds else "vtp" if "vtp" in kinds else "dp"
        if family != "dp" and kwargs.get("vit_cfg") is None:
            kwargs["vit_cfg"] = sharded.default_vit_cfg(family)
        return cls(sharded.seed_params(family, seed, kwargs.get("vit_cfg")), **kwargs)

    # -- single-engine-compatible surface -----------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    @property
    def replica_names(self) -> list[str]:
        return [_replica_name(i) for i in range(len(self.engines))]

    @property
    def device(self) -> torch.device:
        """Replica r0's device (``devices`` lists every replica's)."""
        return self.engines[0].device

    @property
    def weights_digest(self) -> str:
        """Every replica serves the same weights, so r0's digest is the
        pool's (the response cache's key)."""
        return self.engines[0].weights_digest

    @property
    def version(self) -> str:
        return self.engines[0].version

    @property
    def buckets(self):
        return self.engines[0].buckets

    @property
    def dtypes(self):
        return self.engines[0].dtypes

    @property
    def default_dtype(self) -> str:
        return self.engines[0].default_dtype

    @property
    def packed(self) -> bool:
        return self.engines[0].packed

    @property
    def libraries(self) -> tuple[str, ...]:
        return self.engines[0].libraries

    @property
    def use_bn(self) -> bool:
        return self.engines[0].use_bn

    @property
    def warmed(self) -> bool:
        return all(e.warmed for e in self.engines)

    @property
    def parity_report(self) -> dict:
        return self.engines[0].parity_report

    def variant_verified(self, dtype: str | None) -> bool:
        return all(e.variant_verified(dtype) for e in self.engines)

    def rungs_run(self) -> int:
        """Warmup rungs run across every replica, ever (a restart or an
        ``add`` adds none)."""
        return sum(e.rungs_run for e in self.engines)

    # -- registry/rollout surface (serving/rollout.py) ------------------------------
    # Each verb applies to every replica in turn.  A replica's swap replaces
    # its weight references (engine.publish_weights), so mid-iteration the
    # pool serves whole old and whole new trees side by side: a request
    # lands entirely on one version, never on a torn tree.

    def publish_weights(self, state_dict, version: str | None = None) -> str:
        digest = ""
        for engine in self.engines:
            digest = engine.publish_weights(state_dict, version=version)
        return digest

    def install_version(self, version: str, state_dict, verified: bool | None = None) -> str:
        digest = ""
        for engine in self.engines:
            digest = engine.install_version(version, state_dict, verified=verified)
        return digest

    def remove_version(self, version: str) -> int:
        return sum(e.remove_version(version) for e in self.engines)

    def version_divergence(self, version: str) -> dict:
        return self.engines[0].version_divergence(version)

    # -- lifecycle ------------------------------------------------------------------

    def warmup(self, on_rung=None, parallel: bool = True, sink=None) -> None:
        """Warm every replica's dtype x bucket grid: with ``parallel``
        (the default) the replicas concurrently, each on its own stream
        (two replicas' first int8 rungs then load ``int8_head`` once, on
        its per-source lock); without it (``--serial-warmup``) one
        replica after another.  ``on_rung(dtype, bucket, pool_rungs,
        replica=name)`` reports progress across the whole grid; ``sink``
        takes the ``compile`` spans.  The ``warmup`` fault point fires
        once per replica first, so a failed warmup surfaces instead of
        leaving an unwarmed replica to serve.  Then every sharded replica's
        parity gate (:meth:`_gate_sharded`)."""
        if not parallel or len(self.engines) == 1:
            for i, engine in enumerate(self.engines):
                self._warm_one(i, engine, on_rung, sink)
        else:
            with ThreadPoolExecutor(max_workers=len(self.engines)) as pool:
                futures = [pool.submit(self._warm_one, i, engine, on_rung, sink)
                           for i, engine in enumerate(self.engines)]
                for f in futures:
                    f.result()  # the first warmup failure, raised here
        self._gate_sharded(sink)

    def _gate_sharded(self, sink) -> None:
        """Every sharded replica against the single-device forward of its
        family, right after warmup: it cannot take a request before this
        passes, and a failing gate fails the pool start (ParityError)
        instead of serving wrong answers fast."""
        for engine in self.engines:
            if engine.shard_kind != "dp":
                engine.verify_sharded_parity(raise_on_failure=True, sink=sink)

    def _warm_one(self, i: int, engine: InferenceEngine, on_rung, sink) -> None:
        name = _replica_name(i)
        fault_point("warmup", name)

        def report(dtype, bucket, _n):
            with self._rung_lock:  # one report at a time across replicas
                on_rung(dtype, bucket, self.rungs_run(), replica=name)

        engine.warmup(on_rung=None if on_rung is None else report, sink=sink)

    def verify_parity(self, tol=None, raise_on_failure: bool = False,
                      sink=None) -> dict[str, dict]:
        """Gate the reduced-precision variants on EVERY replica (each runs
        its own forward on its own device and stream).  Per dtype the
        result is r0's when every replica passed, else the first failing
        replica's, tagged with ``"replica"``."""
        results: dict[str, dict] = {}
        for i, engine in enumerate(self.engines):
            name = _replica_name(i)
            gates = engine.verify_parity(tol=tol, sink=sink if i == 0 else None)
            for dtype, gate in gates.items():
                if not gate["passed"]:
                    gate = dict(gate, replica=name)
                if dtype not in results or (not gate["passed"] and results[dtype]["passed"]):
                    results[dtype] = gate
        failed = sorted(d for d, g in results.items() if not g["passed"])
        if raise_on_failure and failed:
            raise UnverifiedVariantError(f"variants {failed} failed their parity gate: "
                                         f"{[results[d] for d in failed]}")
        return results

    # -- batchers + router ------------------------------------------------------------

    def start(
        self,
        router_policy: str = "cost",
        sink=None,
        supervise: bool = True,
        supervisor_kwargs: dict | None = None,
        hedge: bool = False,
        hedge_delay_ms: float | None = None,
        **batcher_kwargs,
    ) -> Router:
        """Start one batcher per replica and the router in front of them.
        ``batcher_kwargs`` are kept, so :meth:`add` and a restart build
        identical batchers.  ``supervise`` starts the
        :class:`ReplicaSupervisor` (``supervisor_kwargs`` its thresholds);
        ``hedge`` hedged dispatch after ``hedge_delay_ms`` (None: each QoS
        class's online p99)."""
        if self.router is not None:
            raise RuntimeError("pool already started")
        self._batcher_kwargs = dict(batcher_kwargs)
        self._sink = sink
        replicas = []
        for i, engine in enumerate(self.engines):
            name = _replica_name(i)
            replica = Replica(name, self._make_batcher(name, engine), engine=engine)
            self._hook_and_start(replica, replica.batcher)
            replicas.append(replica)
        self.router = Router(
            replicas, policy=router_policy, registry=self.metrics.registry, sink=self._sink,
            metrics=self.metrics, hedge=hedge, hedge_delay_ms=hedge_delay_ms,
        )
        if supervise:
            self.supervisor = ReplicaSupervisor(
                self.router, self._restart_batcher, registry=self.metrics.registry,
                sink=self._sink, **(supervisor_kwargs or {}),
            ).start()
        if self._sink is not None:
            self._sink.emit("pool_topology", replicas={
                _replica_name(i): {"shard_kind": engine.shard_kind,
                                   "devices": len(engine.mesh.devices)}
                for i, engine in enumerate(self.engines)
            })
        return self.router

    @staticmethod
    def _hook_and_start(replica: Replica, batcher: MicroBatcher) -> None:
        # Completions feed the router's latency averages and the breaker's
        # success side, failures its trip side; expiries return half-open
        # trial tokens held by requests that never dispatched.
        batcher.on_complete = replica.observe_latency
        batcher.on_failure = replica.observe_failure
        batcher.on_expire = replica.observe_expiry
        batcher.start()

    def _restart_batcher(self, replica: Replica) -> MicroBatcher:
        """The supervisor's restart: a fresh batcher around the replica's
        still-warm engine, built as :meth:`add` builds one."""
        if replica.engine is None:
            raise RuntimeError(f"replica {replica.name!r} has no engine to restart around")
        batcher = self._make_batcher(replica.name, replica.engine)
        self._hook_and_start(replica, batcher)
        return batcher

    def _make_batcher(self, name: str, engine: InferenceEngine) -> MicroBatcher:
        return MicroBatcher(engine, metrics=self.metrics, sink=self._sink, replica=name,
                            **self._batcher_kwargs)

    # -- elasticity -------------------------------------------------------------------

    def drain(self, name: str) -> float:
        """Remove one replica under live traffic (unroutable first, then
        its queue and window drain; nothing dropped or duplicated).  The
        engine stays warm for :meth:`add`.  Returns the drain seconds."""
        if self.router is None:
            raise RuntimeError("pool not started")
        return self.router.drain(name)

    def add(self, name: str | None = None) -> str:
        """Re-add a drained replica (or the first drained one) under live
        traffic: a fresh batcher around its warm engine."""
        if self.router is None:
            raise RuntimeError("pool not started")
        # Serialized: two adds racing to one drained replica would each
        # start a batcher, and the loser's threads would be orphaned.
        with self._add_lock:
            candidates = [r for r in self.router.replicas
                          if r.state == "drained" and (name is None or r.name == name)]
            if not candidates:
                raise RuntimeError(
                    f"no drained replica {'named ' + name if name else 'available'}")
            replica = candidates[0]
            if replica.engine is None:
                raise RuntimeError(
                    f"replica {replica.name!r} has no engine; re-add it "
                    f"with router.attach(name, batcher)")
            t0 = time.perf_counter()
            batcher = self._make_batcher(replica.name, replica.engine)
            self._hook_and_start(replica, batcher)
            self.router.attach(replica.name, batcher)
        if self._sink:
            self._sink.emit("replica_add", replica=replica.name,
                            duration_s=time.perf_counter() - t0)
        return replica.name

    def stop(self, drain: bool = True) -> None:
        """Supervisor first (a restart racing the shutdown would attach a
        batcher to a router tearing down), then the router's replicas.  The
        engines stay warm: a stopped pool can :meth:`start` again.  EP
        replicas then record their last dispatch's expert counts, and the
        sink gets the per-expert picture (``expert_load``)."""
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None
        if self.router is not None:
            self.router.stop(drain=drain)
            self.router = None
        ep_engines = [e for e in self.engines if e.shard_kind == "ep"]
        for engine in ep_engines:
            engine.flush_expert_load()
        if ep_engines and self._sink is not None:
            loads = self.metrics.expert_load_snapshot()
            self._sink.emit("expert_load", loads=loads,
                            imbalance=sharded.expert_imbalance(list(loads.values())) or None)
