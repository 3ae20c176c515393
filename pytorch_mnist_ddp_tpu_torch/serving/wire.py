"""Binary wire protocol: the host hot path's zero-copy request format
(the JAX package's ``serving/wire.py``, byte for byte the same layout).

The JSON ``/predict`` surface pays a host tax per request that has
nothing to do with the model: the client renders every pixel as decimal
text, the server re-parses ~784·n Python numbers back into floats, and
the response walks the same road in reverse.  At high request rates on
a small host that encode/decode is the bottleneck.  This module is the flat alternative —
``Content-Type: application/x-mnist-f32`` — designed so the server's
entire parse is ONE ``np.frombuffer`` view (zero copy; the only copy a
binary request ever pays is the batcher's staging memcpy, which the
JSON path pays too), and the response is the raw float32 logits bytes.

Request layout (all integers little-endian)::

    offset  size  field        meaning
    0       4     magic        b"MNW1" (format + version in one tag)
    4       2     header_size  bytes before the payload (>= 24; a newer
                               writer may append fields — readers skip)
    6       2     flags        bit 0: rows are pre-normalized floats
                               (the JSON "normalized" field); other
                               bits reserved, must be zero
    8       4     count        number of rows (>= 1)
    12      4     row_elems    floats per row; must equal 784 (28x28)
    16      1     dtype        served variant: 0=f32, 1=bf16, 2=int8
                               (payload floats are ALWAYS f32; the code
                               picks the engine variant, like the JSON
                               "dtype" field)
    17      1     qos          0=server default, 1=interactive, 2=batch
    18      2     reserved     must be zero
    20      4     deadline_ms  per-request deadline override; 0 = the
                               server's --timeout-ms default
    24      ...   payload      count x row_elems float32, row-major

Registry extension: a request naming a registry ``model`` /
``version`` (the JSON body fields of the same names) appends, AFTER
offset 24 and BEFORE the payload::

    24      2     model_len    UTF-8 bytes of the model name (0 = unset)
    26      2     version_len  UTF-8 bytes of the version (0 = unset)
    28      ...   model name bytes, then version bytes

and sets ``header_size = 28 + model_len + version_len``.  Presence is
keyed on ``header_size > 24`` — NOT on a flag bit, because this decoder
(correctly) rejects unknown flag bits, while the versioning rule below
makes longer headers skippable: a pre-registry reader serves such a
request through its default route, exactly what absent fields mean.  A
request with neither field keeps ``header_size = 24`` — byte-identical
to the pre-registry wire.

Response layout (``application/x-mnist-logits-f32``)::

    offset  size  field        meaning
    0       4     magic        b"MNL1"
    4       2     header_size  >= 16
    6       2     flags        reserved, zero
    8       4     count        rows (== the request's count)
    12      4     classes      logits per row (10)
    16      ...   payload      count x classes float32 log-probs

Versioning/fallback rules: an unknown magic or a header shorter than the
fixed part is a malformed request (HTTP 400, never a hang); a LONGER
header from a future writer is read by ``header_size`` and the extra
bytes are skipped; any ``/predict`` body whose Content-Type is not this
format parses as JSON.  The bytes are the JAX package's in both
directions, so a client of either package talks to a server of the other.

Standard library and numpy only.
"""

from __future__ import annotations

import struct

import numpy as np

from ..data.transforms import normalize

# The /predict content types (the header values on the wire).
WIRE_REQUEST_TYPE = "application/x-mnist-f32"
WIRE_RESPONSE_TYPE = "application/x-mnist-logits-f32"

REQUEST_MAGIC = b"MNW1"
RESPONSE_MAGIC = b"MNL1"

# magic, header_size, flags, count, row_elems, dtype, qos, reserved,
# deadline_ms — 24 bytes (see the module docstring's layout table).
_REQ_HEADER = struct.Struct("<4sHHIIBBHI")
# magic, header_size, flags, count, classes — 16 bytes.
_RESP_HEADER = struct.Struct("<4sHHII")
# model_len, version_len — the registry extension's length prefix at
# offset 24 (present iff header_size > 24; see the layout table).
_REQ_EXT = struct.Struct("<HH")

REQUEST_HEADER_SIZE = _REQ_HEADER.size
RESPONSE_HEADER_SIZE = _RESP_HEADER.size

FLAG_NORMALIZED = 0x1

ROW_ELEMS = 28 * 28

# Wire code <-> name tables.  Codes are append-only: reusing a retired
# code would silently re-route old clients' requests to a different
# variant/class.
DTYPE_CODES = {"f32": 0, "bf16": 1, "int8": 2}
DTYPE_NAMES = {code: name for name, code in DTYPE_CODES.items()}
QOS_CODES = {None: 0, "interactive": 1, "batch": 2}
QOS_NAMES = {code: name for name, code in QOS_CODES.items()}

# Row-count sanity bound: a header claiming 2**31 rows must fail on the
# header check, not on a gigabyte allocation attempt.  Generous vs any
# real bucket ladder (top default 128).
MAX_ROWS = 1 << 20


class WireError(ValueError):
    """Malformed binary request/response — HTTP 400 at the server, a
    client bug at the loadgen.  Subclasses ValueError so the server's
    existing 400 mapping handles it unchanged."""


class WireRequest:
    """One decoded binary request: a zero-copy float32 row view plus the
    sideband fields the JSON surface carries as body keys."""

    __slots__ = ("rows", "normalized", "dtype", "qos", "deadline_ms",
                 "model", "version")

    def __init__(self, rows, normalized, dtype, qos, deadline_ms,
                 model=None, version=None):
        self.rows = rows              # [n, 784] float32 view into the body
        self.normalized = normalized  # bool: skip the serving normalize
        self.dtype = dtype            # served variant name ("f32", ...)
        self.qos = qos                # scheduling class name or None
        self.deadline_ms = deadline_ms  # per-request override or None
        self.model = model            # registry model name or None
        self.version = version        # registry version or None

    @property
    def n(self) -> int:
        return len(self.rows)


def _rows_f32(x, elems: int, what: str) -> np.ndarray:
    """``x`` as a contiguous little-endian ``[n, elems]`` float32 block.

    Accepts the shapes the JSON surface accepts (flat rows, 28x28,
    28x28x1) so callers encode whatever they already hold; the copy
    (if any) happens HERE, once, at encode time — never per send."""
    x = np.asarray(x)
    if x.ndim >= 2 and int(np.prod(x.shape[1:])) == elems:
        x = x.reshape(len(x), elems)
    else:
        raise WireError(
            f"{what} must be [n, {elems}]-shaped rows (flat, 28x28, or "
            f"28x28x1); got array shape {x.shape}"
        )
    return np.ascontiguousarray(x, dtype="<f4")


def encode_request(
    rows,
    dtype: str = "f32",
    qos: str | None = None,
    normalized: bool = False,
    deadline_ms: float | None = None,
    model: str | None = None,
    version: str | None = None,
) -> bytes:
    """Rows + sideband fields -> one wire message (header ++ payload).
    ``model``/``version`` (registry routing, both optional) ride in the
    header extension; omitting both emits the pre-registry 24-byte
    header, bit for bit."""
    x = _rows_f32(rows, ROW_ELEMS, "request rows")
    if len(x) < 1:
        raise WireError("request must carry at least one row")
    if dtype not in DTYPE_CODES:
        raise WireError(
            f"unknown dtype {dtype!r}; wire codes exist for "
            f"{list(DTYPE_CODES)}"
        )
    if qos not in QOS_CODES:
        raise WireError(
            f"unknown qos {qos!r}; wire codes exist for "
            f"{[q for q in QOS_CODES if q is not None]}"
        )
    if deadline_ms is not None:
        # 0 on the wire means "no override" — a requested deadline must
        # never silently become one (sub-ms rounds UP to 1), and a
        # value past the u32 field is the caller's bug named here, not
        # a struct.error escaping the WireError contract.
        if not 0 < deadline_ms < 1 << 32:
            raise WireError(
                f"deadline_ms {deadline_ms!r} outside (0, 2**32) "
                "(omit it for the server default)"
            )
        deadline_field = max(1, int(deadline_ms))
    else:
        deadline_field = 0
    ext = b""
    if model is not None or version is not None:
        model_b = (model or "").encode("utf-8")
        version_b = (version or "").encode("utf-8")
        if max(len(model_b), len(version_b)) >= 1 << 16:
            raise WireError("model/version names exceed the u16 length field")
        ext = _REQ_EXT.pack(len(model_b), len(version_b)) + model_b + version_b
    header = _REQ_HEADER.pack(
        REQUEST_MAGIC,
        REQUEST_HEADER_SIZE + len(ext),
        FLAG_NORMALIZED if normalized else 0,
        len(x),
        ROW_ELEMS,
        DTYPE_CODES[dtype],
        QOS_CODES[qos],
        0,
        deadline_field,
    )
    return header + ext + x.tobytes()


def decode_request(body: bytes) -> WireRequest:
    """One wire message -> :class:`WireRequest`; the returned ``rows``
    are a read-only ``np.frombuffer`` VIEW into ``body`` — no float
    parsing, no copy (the staging memcpy downstream is the first and
    only one).  Raises :class:`WireError` on anything malformed or
    truncated; the message names the defect for the 400 body."""
    if len(body) < REQUEST_HEADER_SIZE:
        raise WireError(
            f"binary request of {len(body)} bytes is shorter than the "
            f"{REQUEST_HEADER_SIZE}-byte header"
        )
    (magic, header_size, flags, count, row_elems, dtype_code, qos_code,
     reserved, deadline_ms) = _REQ_HEADER.unpack_from(body)
    if magic != REQUEST_MAGIC:
        raise WireError(
            f"bad magic {magic!r}; expected {REQUEST_MAGIC!r} "
            "(wrong format or an incompatible future version)"
        )
    if header_size < REQUEST_HEADER_SIZE:
        raise WireError(
            f"header_size {header_size} is shorter than the fixed "
            f"{REQUEST_HEADER_SIZE}-byte layout"
        )
    if flags & ~FLAG_NORMALIZED:
        raise WireError(f"reserved flag bits set: 0x{flags:x}")
    if reserved:
        raise WireError(f"reserved header field set: 0x{reserved:x}")
    if row_elems != ROW_ELEMS:
        raise WireError(
            f"row_elems {row_elems} != {ROW_ELEMS} (28x28 pixels per row)"
        )
    if not 1 <= count <= MAX_ROWS:
        raise WireError(f"row count {count} outside [1, {MAX_ROWS}]")
    expected = header_size + 4 * count * row_elems
    if len(body) != expected:
        raise WireError(
            f"body is {len(body)} bytes; header promises {expected} "
            f"({count} rows x {row_elems} floats after a "
            f"{header_size}-byte header)"
        )
    dtype = DTYPE_NAMES.get(dtype_code)
    if dtype is None:
        raise WireError(
            f"unknown dtype code {dtype_code}; have {DTYPE_NAMES}"
        )
    if qos_code not in QOS_NAMES:
        raise WireError(f"unknown qos code {qos_code}; have {QOS_NAMES}")
    model = version = None
    if header_size > REQUEST_HEADER_SIZE:
        # Registry extension (or a future writer's longer header — the
        # lengths still lead, extra tail bytes are skipped).
        ext_end = REQUEST_HEADER_SIZE + _REQ_EXT.size
        if header_size < ext_end:
            raise WireError(
                f"extended header_size {header_size} is shorter than the "
                f"{ext_end}-byte model/version extension"
            )
        model_len, version_len = _REQ_EXT.unpack_from(
            body, REQUEST_HEADER_SIZE
        )
        if ext_end + model_len + version_len > header_size:
            raise WireError(
                f"model/version lengths ({model_len}, {version_len}) "
                f"overrun the {header_size}-byte header"
            )
        try:
            names = body[ext_end:ext_end + model_len + version_len]
            model = names[:model_len].decode("utf-8") or None
            version = names[model_len:].decode("utf-8") or None
        except UnicodeDecodeError as e:
            raise WireError(f"model/version names are not UTF-8: {e}")
    rows = np.frombuffer(
        body, dtype="<f4", count=count * row_elems, offset=header_size
    ).reshape(count, row_elems)
    return WireRequest(
        rows=rows,
        normalized=bool(flags & FLAG_NORMALIZED),
        dtype=dtype,
        qos=QOS_NAMES[qos_code],
        deadline_ms=float(deadline_ms) if deadline_ms else None,
        model=model,
        version=version,
    )


def to_model_input(req: WireRequest) -> np.ndarray:
    """Decoded rows -> model-ready ``[n, 28, 28, 1]`` float32 — the
    binary twin of :func:`~.server.decode_instances`, sharing its
    normalize so identical pixel values produce BIT-identical model
    inputs (and therefore identical cache keys) on either wire."""
    x = req.rows.reshape(req.n, 28, 28)
    if req.normalized:
        return x[..., None]
    return normalize(x)


def encode_response(logits) -> bytes:
    """``[n, classes]`` float32 log-probs -> raw response bytes."""
    x = np.ascontiguousarray(np.asarray(logits), dtype="<f4")
    if x.ndim != 2:
        raise WireError(f"logits must be [n, classes], got shape {x.shape}")
    header = _RESP_HEADER.pack(
        RESPONSE_MAGIC, RESPONSE_HEADER_SIZE, 0, x.shape[0], x.shape[1]
    )
    return header + x.tobytes()


def decode_response(body: bytes) -> np.ndarray:
    """Raw response bytes -> ``[n, classes]`` float32 logits view."""
    if len(body) < RESPONSE_HEADER_SIZE:
        raise WireError(
            f"binary response of {len(body)} bytes is shorter than the "
            f"{RESPONSE_HEADER_SIZE}-byte header"
        )
    magic, header_size, flags, count, classes = _RESP_HEADER.unpack_from(body)
    if magic != RESPONSE_MAGIC:
        raise WireError(f"bad response magic {magic!r}")
    if header_size < RESPONSE_HEADER_SIZE:
        raise WireError(f"response header_size {header_size} too short")
    if flags:
        raise WireError(f"reserved response flags set: 0x{flags:x}")
    expected = header_size + 4 * count * classes
    if len(body) != expected:
        raise WireError(
            f"response is {len(body)} bytes; header promises {expected}"
        )
    return np.frombuffer(
        body, dtype="<f4", count=count * classes, offset=header_size
    ).reshape(count, classes)
