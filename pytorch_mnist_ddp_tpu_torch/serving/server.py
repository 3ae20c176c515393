"""Standard-library HTTP endpoint over ``http.server`` (the JAX package's
``serving/server.py``, single engine).

- ``POST /predict`` — body ``{"instances": [...]}``, each instance a flat
  784-list or a 28x28 (optionally ...x1) nested list.  Instances are RAW
  pixels (0..255) by default and get the training pipeline's
  ToTensor∘Normalize affine; ``"normalized": true`` submits pre-normalized
  floats verbatim.  ``"dtype": "bf16"|"int8"`` selects a variant (400 when
  not served, 503 until its parity gate passes), ``"qos":
  "interactive"|"batch"`` the scheduling class (400 on an unknown one),
  ``"model"``/``"version"`` a registry route (400 without a registry).
  Response ``{"predictions": [digit, ...]}``, plus ``"log_probs"`` when
  ``"return_log_probs": true``.

  With ``Content-Type: application/x-mnist-f32`` the same endpoint speaks
  the binary wire (serving/wire.py): one zero-copy ``np.frombuffer`` parse,
  the raw float32 log-probs back (``application/x-mnist-logits-f32``).
  Any other content type parses as JSON (a ``wire_fallback`` event notes
  one that is not JSON's).

  ``response_cache`` adds the content-addressed response cache with
  single-flight dedup at this admission point (serving/cache.py).  Off by
  default; when off, no code path changes.
- ``POST /admin/{swap,canary,rollback,rollout}`` — the rollout control
  surface (serving/rollout.py); 503 without a registry.
- ``GET /metrics`` — the ServingMetrics snapshot as JSON; with
  ``?format=prom`` or ``Accept: text/plain``, the same registry as
  Prometheus text.
- ``GET /healthz`` — liveness plus the warmed/dtype/device summary (and
  the rollout block with a registry; each replica's state in pool mode).
- ``GET /readyz`` — 200 once warmed, else 503; in pool mode 200 while at
  least one replica is routable, with ``routable_replicas`` and each
  replica's health and circuit.

Pool mode (``make_server(pool, metrics, batcher=router)``): a request
flushed off a draining or dead replica (:class:`RejectedError` /
:class:`ReplicaDeadError` at ``result()``) never ran, so the handler
resubmits it on the REMAINING deadline budget, at most 1 + replicas
attempts, and the client sees exactly one outcome
(``serving_request_retries_total`` counts the resubmissions).

Status mapping: 400 malformed input, 503 admission rejected (queue full,
shed or draining), 504 deadline expired, 500 engine failure, 408 a body
that stalls.  Handler threads only parse, submit to the batcher and wait;
the batcher's one dispatch worker owns the device.  Every connection
carries a socket timeout (``request_timeout_s``), so a silent client
cannot pin a handler thread.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..data.transforms import normalize
from ..models.net import INPUT_SHAPE
from ..obs.registry import render_prometheus
from ..ops import _build
from . import wire
from .batcher import MicroBatcher, RejectedError, RequestTimeout
from .cache import COALESCED, HIT, FlightTimeout, ResponseCache
from .engine import VERSION_SEP
from .metrics import ServingMetrics
from .qos import QOS_CLASSES


def decode_instances(body: dict) -> np.ndarray:
    """Request JSON -> model-ready ``[n, 28, 28, 1]`` float32 rows.

    Raises ``ValueError`` (-> 400) on anything malformed, with a message
    the client can act on."""
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    instances = body.get("instances")
    if instances is None:
        raise ValueError('missing "instances"')
    try:
        x = np.asarray(instances, np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"instances are not a rectangular numeric array: {e}")
    if x.ndim == 1 or x.ndim == 2 and x.shape[1:] == (28,):
        raise ValueError(
            "instances must be a LIST of samples (wrap a single sample in "
            "an outer list)"
        )
    h, w, c = INPUT_SHAPE
    if x.ndim == 2 and x.shape[1] == h * w:
        x = x.reshape(-1, h, w)
    elif x.ndim == 3 and x.shape[1:] == (h, w):
        pass
    elif x.ndim == 4 and x.shape[1:] == INPUT_SHAPE:
        x = x[..., 0]
    else:
        raise ValueError(
            f"each instance must be {h * w} flat, {h}x{w}, or {h}x{w}x{c} "
            f"pixels; got array shape {x.shape}"
        )
    if bool(body.get("normalized", False)):
        return x[..., None]
    return normalize(x)


class ServingHandler(BaseHTTPRequestHandler):
    server_version = "mnist-serve-torch/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # /metrics is the observability story, not per-request lines

    def setup(self):
        # A client that connects and goes silent times out here: an idle
        # keep-alive closes, a mid-body stall is answered 408 (do_POST).
        self.timeout = self.server.request_timeout_s
        super().setup()

    def _send(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: dict) -> None:
        self._send(status, json.dumps(payload).encode(), "application/json")

    def do_GET(self):  # noqa: N802 - stdlib casing
        srv: ServingHTTPServer = self.server  # type: ignore[assignment]
        url = urlsplit(self.path)
        engine = srv.engine
        stats = getattr(srv.batcher, "replica_stats", None)  # pool mode
        if url.path == "/healthz":
            health = {
                "status": "ok",
                "warmed": engine.warmed,
                "device": str(engine.device),
                "buckets": list(engine.buckets),
                "dtypes": {d: engine.variant_verified(d) for d in engine.dtypes},
            }
            if stats is not None:
                health["replicas"] = {name: s["state"] for name, s in stats().items()}
            if srv.rollout is not None:
                health["rollout"] = srv.rollout.describe()
            self._send_json(200, health)
        elif url.path == "/readyz":
            # Readiness, not liveness: can a request succeed right now?
            # In pool mode, only while some replica is routable.
            payload: dict = {}
            if stats is not None:
                n = srv.batcher.routable_count()
                ready = n > 0
                by_name = stats()
                payload["routable_replicas"] = n
                payload["replicas"] = {
                    name: "healthy" if s["state"] == "active" else s["state"]
                    for name, s in by_name.items()
                }
                payload["circuits"] = {name: s["circuit"] for name, s in by_name.items()}
            else:
                ready = bool(engine.warmed)
                payload["warmed"] = engine.warmed
            payload["status"] = "ready" if ready else "unready"
            self._send_json(200 if ready else 503, payload)
        elif url.path == "/metrics":
            wants_prom = (
                parse_qs(url.query).get("format", [""])[0] == "prom"
                or "text/plain" in self.headers.get("Accept", "")
            )
            snap = srv.snapshot()
            if wants_prom:
                self._send(
                    200,
                    render_prometheus(srv.metrics.registry).encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            else:
                self._send_json(200, snap)
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})

    def _handle_admin(self, srv) -> None:
        """``POST /admin/{swap,canary,rollback,rollout}``; 503 without a
        registry, rollout state errors 400."""
        if srv.rollout is None:
            self._send_json(503, {"error": "no model registry configured (--registry)"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("admin body must be a JSON object")
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
            return
        try:
            if self.path == "/admin/swap":
                result = srv.rollout.swap(str(body["version"]), model=body.get("model"))
            elif self.path == "/admin/canary":
                if "version" in body:
                    result = srv.rollout.start_canary(
                        str(body["version"]), float(body["pct"]), model=body.get("model"))
                else:
                    result = srv.rollout.set_canary_pct(float(body["pct"]))
            elif self.path == "/admin/rollback":
                result = srv.rollout.rollback(reason=str(body.get("reason", "operator")))
            elif self.path == "/admin/rollout":
                result = srv.rollout.describe()
            else:
                self._send_json(404, {"error": f"no such admin path {self.path!r}"})
                return
        except KeyError as e:
            self._send_json(400, {"error": f"missing admin field {e}"})
            return
        except (TypeError, ValueError) as e:  # RegistryError/RolloutError included
            self._send_json(400, {"error": str(e)})
            return
        self._send_json(200, result)

    def do_POST(self):  # noqa: N802 - stdlib casing
        srv: ServingHTTPServer = self.server  # type: ignore[assignment]
        if self.path.startswith("/admin/"):
            self._handle_admin(srv)
            return
        if self.path != "/predict":
            self._send_json(404, {"error": f"no such path {self.path!r}"})
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
        binary = ctype == wire.WIRE_REQUEST_TYPE
        fmt = "binary" if binary else "json"
        raw = b""

        # Every /predict outcome leaves through here, so the wire families
        # count each exchange once whatever its status.
        def reply(status, data, content_type="application/json"):
            srv.metrics.record_wire(fmt, bytes_in=len(raw), bytes_out=len(data))
            self._send(status, data, content_type)

        def reply_json(status, payload):
            reply(status, json.dumps(payload).encode())

        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            reply_json(400, {"error": "malformed Content-Length"})
            return
        try:
            raw = self.rfile.read(length)
        except OSError:  # the socket timeout included
            # Headers then silence mid-body: answer 408 (best effort) and
            # drop the connection so the thread frees now.
            self.close_connection = True
            try:
                reply_json(408, {"error": "request body read timed out"})
            except OSError:
                pass
            return
        deadline_ms = None
        return_log_probs = False
        route = None
        t_req = time.perf_counter()
        try:
            if binary:
                wreq = wire.decode_request(raw)
                x = wire.to_model_input(wreq)
                dtype = None if wreq.dtype == "f32" else wreq.dtype
                qos = wreq.qos
                deadline_ms = wreq.deadline_ms
                model, version = wreq.model, wreq.version
            else:
                if ctype not in ("", "application/json") and srv.sink:
                    srv.sink.emit("wire_fallback", content_type=ctype)
                body = json.loads(raw or b"{}")
                x = decode_instances(body)
                dtype = body.get("dtype")
                qos = body.get("qos")
                return_log_probs = bool(body.get("return_log_probs", False))
                model, version = body.get("model"), body.get("version")
            if dtype is not None:
                # Version-pinned keys ("f32@v2") are the rollout
                # controller's, never a client's.
                served = [d for d in srv.engine.dtypes if VERSION_SEP not in d]
                if not isinstance(dtype, str) or dtype not in served:
                    raise ValueError(f"unknown dtype {dtype!r}; served dtypes: {served}")
            if qos is not None:
                classes = getattr(srv.batcher, "qos_classes", QOS_CLASSES)
                if not isinstance(qos, str) or qos not in classes:
                    raise ValueError(f"unknown qos {qos!r}; classes: {list(classes)}")
            for field, name in ((model, "model"), (version, "version")):
                if field is not None and not isinstance(field, str):
                    raise ValueError(f'"{name}" must be a string')
            if srv.rollout is not None:
                # The canary split hashes the MODEL-READY rows: both wire
                # formats split a payload the same way.
                route = srv.rollout.route(model, version,
                                          payload=np.ascontiguousarray(x).data)
            elif model is not None or version is not None:
                raise ValueError(
                    "no model registry is configured on this server; "
                    'omit "model"/"version"'
                )
        except ValueError as e:  # WireError, JSONDecodeError, RegistryError
            reply_json(400, {"error": str(e)})
            return

        def observe(ok):
            if route is not None:
                srv.rollout.observe(route, ok, time.perf_counter() - t_req)

        # A canary route dispatches on its version-pinned variant key: the
        # batcher coalesces by key, and the key joins the cache key.
        submit_dtype = dtype
        if route is not None and route.canary:
            submit_dtype = route.dtype_key(dtype or srv.engine.default_dtype)
        cache = srv.response_cache
        flight = key = None
        if cache is not None:
            key = cache.key(np.ascontiguousarray(x).data,
                            dtype=submit_dtype or srv.engine.default_dtype)
            outcome, val = cache.claim(key)
            if outcome == HIT:
                observe(True)
                self._reply_logits(reply, reply_json, val, binary, return_log_probs)
                return
            if outcome == COALESCED:
                # Join the claimant's flight on this request's own budget.
                budget_s = deadline_ms / 1e3 if deadline_ms else srv.batcher.timeout_s
                try:
                    logits = val.result(budget_s + 1.0)
                except RejectedError as e:
                    observe(False)
                    reply_json(503, {"error": str(e)})
                    return
                except (RequestTimeout, FlightTimeout) as e:
                    observe(False)
                    reply_json(504, {"error": str(e)})
                    return
                except BaseException as e:
                    observe(False)
                    reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                observe(True)
                self._reply_logits(reply, reply_json, logits, binary, return_log_probs)
                return
            flight = val  # MISS: this request owns the dispatch
        # A claimed flight resolves on every exit path: a failure wakes the
        # joiners with the error and caches nothing.
        try:
            logits = self._submit_with_retry(srv, x, submit_dtype, qos, deadline_ms)
        except RejectedError as e:
            if flight is not None:
                cache.fail(key, flight, e)
            observe(False)
            reply_json(503, {"error": str(e)})
            return
        except RequestTimeout as e:
            if flight is not None:
                cache.fail(key, flight, e)
            observe(False)
            reply_json(504, {"error": str(e)})
            return
        except Exception as e:  # engine failure propagated by a worker
            if flight is not None:
                cache.fail(key, flight, e)
            observe(False)
            reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        except BaseException as e:
            if flight is not None:
                cache.fail(key, flight, e)
            raise
        if flight is not None:
            cache.complete(key, flight, logits)
        observe(True)
        self._reply_logits(reply, reply_json, logits, binary, return_log_probs)

    @staticmethod
    def _submit_with_retry(srv, x, dtype, qos, deadline_ms):
        """Submit and wait.  In pool mode a request flushed off a draining
        or dead replica never produced a result, so it is resubmitted (the
        router places it on a surviving replica) on the remaining budget,
        at most 1 + replicas attempts; the rejection that survives them is
        the client's one outcome and is counted here.  A single engine
        that flushes is shutting down: one attempt."""
        replicas = getattr(srv.batcher, "replicas", None)
        attempts = 1 + len(replicas) if replicas else 1
        budget_s = deadline_ms / 1e3 if deadline_ms else srv.batcher.timeout_s
        t0 = time.perf_counter()
        for attempt in range(attempts):
            remaining_ms = deadline_ms if attempt == 0 else max(
                0.0, 1e3 * (budget_s - (time.perf_counter() - t0)))
            request = srv.batcher.submit(x, dtype=dtype, qos=qos, timeout_ms=remaining_ms)
            if attempt:
                # Counted after the submit: a resubmission refused at
                # admission never ran, and its 503 is the outcome.
                srv.batcher.record_retry()
            try:
                return request.result()
            except RejectedError:
                if attempt + 1 == attempts:
                    if attempts > 1:
                        srv.metrics.record_rejected()
                    raise

    @staticmethod
    def _reply_logits(reply, reply_json, logits, binary, return_log_probs):
        """``[n, 10]`` log-probs, computed or cached -> the 200, on the wire
        the request came in on."""
        if binary:
            reply(200, wire.encode_response(logits), wire.WIRE_RESPONSE_TYPE)
            return
        payload: dict = {"predictions": [int(p) for p in logits.argmax(axis=1)]}
        if return_log_probs:
            payload["log_probs"] = [[float(v) for v in row] for row in logits]
        reply_json(200, payload)


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the serving objects for its handlers."""

    daemon_threads = True
    # The listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients, which then retry a second or more later.
    request_queue_size = 128

    def __init__(
        self,
        address: tuple[str, int],
        engine,
        batcher: MicroBatcher,
        metrics: ServingMetrics,
        request_timeout_s: float = 30.0,
        response_cache: ResponseCache | None = None,
        sink=None,
        rollout=None,
    ):
        super().__init__(address, ServingHandler)
        self.engine = engine
        self.batcher = batcher
        self.metrics = metrics
        self.request_timeout_s = request_timeout_s
        self.response_cache = response_cache
        self.sink = sink
        self.rollout = rollout
        metrics.ensure_wire()

    def snapshot(self) -> dict:
        # Pool mode: the router's depth/in-flight sums and its per-replica
        # block.  ``compiles``: the kernel libraries this process built
        # with nvcc (0 on a warm start off the store, and on the CPU);
        # ``programs``: what a request at an unwarmed rung would move.
        stats = getattr(self.batcher, "replica_stats", None)
        return self.metrics.snapshot(
            queue_depth=self.batcher.depth(),
            compiles=_build.BUILDS,
            buckets=self.engine.buckets,
            inflight=self.batcher.inflight(),
            max_inflight=self.batcher.max_inflight,
            linger_ms=self.batcher.current_linger_ms,
            replicas=stats() if stats is not None else None,
            programs={"rungs": self.metrics.programs_built(),
                      "library_builds": _build.BUILDS, "library_loads": _build.LOADS},
        )


def make_server(
    engine,
    metrics: ServingMetrics,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout_s: float = 30.0,
    response_cache: int | ResponseCache | None = None,
    sink=None,
    rollout=None,
    batcher=None,
    **batcher_kwargs,
) -> ServingHTTPServer:
    """Engine + metrics + a started :class:`MicroBatcher` -> a server ready
    for ``serve_forever`` (port 0 = OS-assigned; the bound port is
    ``server.server_address[1]``).  ``response_cache`` is an entry
    capacity or a built :class:`ResponseCache`; ``rollout`` a
    :class:`~.rollout.RolloutController`.  Stop with ``server.shutdown()``,
    then ``server.batcher.stop(drain=True)`` and ``server.server_close()``.

    ``batcher`` injects a started admission front instead: the pool's
    :class:`~.router.Router`, with the :class:`~.pool.EnginePool` as
    ``engine`` (its batcher settings go to the pool's ``start()``)."""
    if isinstance(response_cache, int):
        response_cache = ResponseCache(
            response_cache, model_digest=engine.weights_digest, metrics=metrics,
            sink=sink, scope="server",
        )
    if rollout is not None and rollout.cache is None:
        rollout.cache = response_cache
    injected = batcher is not None
    if injected and batcher_kwargs:
        raise ValueError("pass batcher kwargs to the pool's start(), not make_server, "
                         "when injecting a router")
    if not injected:
        batcher = MicroBatcher(engine, metrics=metrics, sink=sink, **batcher_kwargs).start()
    try:
        return ServingHTTPServer(
            (host, port), engine, batcher, metrics,
            request_timeout_s=request_timeout_s, response_cache=response_cache,
            sink=sink, rollout=rollout,
        )
    except BaseException:
        if not injected:
            batcher.stop(drain=False)
        raise
