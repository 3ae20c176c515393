"""Standard-library HTTP endpoint over ``http.server``.

- ``POST /predict`` — body ``{"instances": [...]}``, each instance a flat
  784-list or a 28x28 (optionally ...x1) nested list.  Instances are RAW
  pixels (0..255) by default and get the training pipeline's
  ToTensor∘Normalize affine; ``"normalized": true`` submits pre-normalized
  floats verbatim.  ``"dtype": "int8"`` selects the int8 variant (400 when
  not served, 503 until its parity gate passes).  Response
  ``{"predictions": [digit, ...]}``, plus ``"log_probs"`` when
  ``"return_log_probs": true``.
- ``GET /metrics`` — the ServingMetrics snapshot as JSON; with
  ``?format=prom`` or ``Accept: text/plain``, the same registry as
  Prometheus text.
- ``GET /healthz`` — liveness plus the warmed/dtype/device summary.
- ``GET /readyz`` — 200 once warmed, else 503.

Status mapping: 400 malformed input, 503 admission rejected (queue full or
draining), 504 deadline expired, 500 engine failure.  Handler threads only
parse, submit to the batcher and wait; the batcher's one dispatch worker
owns the device.  Every connection carries a socket timeout, so a silent
client cannot pin a handler thread.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..data.transforms import normalize
from ..models.net import INPUT_SHAPE
from ..obs.registry import render_prometheus
from .batcher import MicroBatcher, RejectedError, RequestTimeout
from .metrics import ServingMetrics


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
        if url.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "warmed": engine.warmed,
                "device": str(engine.device),
                "buckets": list(engine.buckets),
                "dtypes": {d: engine.variant_verified(d) for d in engine.dtypes},
            })
        elif url.path == "/readyz":
            ready = bool(engine.warmed)
            self._send_json(200 if ready else 503, {
                "status": "ready" if ready else "unready", "warmed": engine.warmed,
            })
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

    def do_POST(self):  # noqa: N802 - stdlib casing
        srv: ServingHTTPServer = self.server  # type: ignore[assignment]
        if self.path != "/predict":
            self._send_json(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._send_json(400, {"error": "malformed Content-Length"})
            return
        try:
            raw = self.rfile.read(length)
        except OSError:
            # Headers then silence mid-body: answer 408 (best effort) and
            # drop the connection so the thread frees now.
            self.close_connection = True
            try:
                self._send_json(408, {"error": "request body read timed out"})
            except OSError:
                pass
            return
        try:
            body = json.loads(raw or b"{}")
            x = decode_instances(body)
            dtype = body.get("dtype")
            if dtype is not None and (
                not isinstance(dtype, str) or dtype not in srv.engine.dtypes
            ):
                raise ValueError(
                    f"unknown dtype {dtype!r}; served dtypes: {list(srv.engine.dtypes)}"
                )
            return_log_probs = bool(body.get("return_log_probs", False))
        except ValueError as e:  # JSONDecodeError subclasses ValueError
            self._send_json(400, {"error": str(e)})
            return
        try:
            logits = srv.batcher.submit(x, dtype=dtype).result()
        except RejectedError as e:
            self._send_json(503, {"error": str(e)})
            return
        except RequestTimeout as e:
            self._send_json(504, {"error": str(e)})
            return
        except Exception as e:  # engine failure propagated by a worker
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        payload: dict = {"predictions": [int(p) for p in logits.argmax(axis=1)]}
        if return_log_probs:
            payload["log_probs"] = [[float(v) for v in row] for row in logits]
        self._send_json(200, payload)


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the serving objects for its handlers."""

    daemon_threads = True

    def __init__(
        self,
        address: tuple[str, int],
        engine,
        batcher: MicroBatcher,
        metrics: ServingMetrics,
        request_timeout_s: float = 30.0,
    ):
        super().__init__(address, ServingHandler)
        self.engine = engine
        self.batcher = batcher
        self.metrics = metrics
        self.request_timeout_s = request_timeout_s

    def snapshot(self) -> dict:
        return self.metrics.snapshot(
            queue_depth=self.batcher.depth(),
            buckets=self.engine.buckets,
            inflight=self.batcher.inflight(),
            max_inflight=self.batcher.max_inflight,
        )


def make_server(
    engine,
    metrics: ServingMetrics,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout_s: float = 30.0,
    **batcher_kwargs,
) -> ServingHTTPServer:
    """Engine + metrics + a started :class:`MicroBatcher` -> a server ready
    for ``serve_forever`` (port 0 = OS-assigned; the bound port is
    ``server.server_address[1]``).  Stop with ``server.shutdown()``, then
    ``server.batcher.stop(drain=True)`` and ``server.server_close()``."""
    batcher = MicroBatcher(engine, metrics=metrics, **batcher_kwargs).start()
    try:
        return ServingHTTPServer(
            (host, port), engine, batcher, metrics,
            request_timeout_s=request_timeout_s,
        )
    except BaseException:
        batcher.stop(drain=False)
        raise
