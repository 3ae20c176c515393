"""The inference engine: checkpoint -> warmed bucket rungs -> log-probs.

Lifecycle: construct (weights placed on the device), :meth:`warmup` (run
every (variant, bucket) rung once), :meth:`verify_parity` (gate the int8
variant against f32), then :meth:`launch`/:meth:`predict_logits` from the
dispatch thread.

Variants: ``f32`` (the eval-mode :class:`~..models.net.Net`) is always
served and is the parity reference; ``dtypes=("int8",)`` adds the
per-channel-quantized forward (models/quant.py).  The port's int8 variant
always runs ``int8_forward_fused``: on the card its dense head is the CUDA
kernel of ``ops/int8_head.py``, and nothing falls back from it.  (The JAX
package's ``--int8-impl dot`` head is XLA arithmetic, which here is the
plain PyTorch version; that version serves only CPU tensors and the
tests.)  A variant is REFUSED (:class:`UnverifiedVariantError`) until its
parity gate passes: logit tolerance plus argmax-identical against f32 on a
fixed, seeded eval slice.

Threading contract: exactly one thread (the micro-batcher's dispatch
worker, or the caller in direct use) calls ``launch``/``predict_logits``.
:meth:`DeviceResult.wait` on a launched batch is safe from a second thread
— the batcher's completion worker — because it waits on that batch's own
CUDA event, not on the whole device.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

from ..data.transforms import normalize
from ..device import resolve_device
from ..models.net import INPUT_SHAPE, NUM_CLASSES, Net
from ..models.quant import qparams_to, quantize_params
from ..utils.checkpoint import load_inference_state
from ..utils.convert import LAYERS
from .buckets import (
    DEFAULT_MAX_BUCKET,
    StagingPool,
    packed_capacities,
    pow2_buckets,
    validate_buckets,
)
from .metrics import ServingMetrics
from .predict import (
    make_int8_predict_step,
    make_packed_int8_predict_step,
    make_packed_predict_step,
    make_predict_step,
)

DEFAULT_DTYPE = "f32"
VARIANT_DTYPES = ("int8",)

# Parity-gate tolerance: max |log_prob_variant - log_prob_f32| over the
# slice.  int8 (per-channel weights, per-row activations) lands around
# 5e-3 on this CNN; argmax-identity is the sharp edge.
PARITY_TOL = {"int8": 1.0}

# Rows in the fixed parity slice (the largest warmed bucket <= this) and
# its seed: a variant that passes once passes every restart.
PARITY_ROWS = 64
PARITY_SEED = 20260803


def weights_digest(state: dict[str, torch.Tensor]) -> str:
    """Content hash of a state dict: key, shape, dtype and raw bytes of
    every tensor in sorted key order."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(state):
        arr = state[key].detach().cpu().contiguous().numpy()
        h.update(f"{key}{arr.shape}{arr.dtype}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class UnverifiedVariantError(RuntimeError):
    """A variant was asked to serve before (or after failing) its parity
    gate."""


class DeviceResult:
    """One launched batch's ``[bucket, 10]`` log-probs, read back later.

    On the card the result is copied into pinned host memory
    asynchronously and a CUDA event is recorded behind the copy;
    :meth:`wait` waits on that event only.  On the CPU the forward already
    ran, and :meth:`wait` returns at once.
    """

    __slots__ = ("_host", "_event")

    def __init__(self, out: torch.Tensor):
        if out.device.type == "cuda":
            self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(out.device))
        else:
            self._host = out
            self._event = None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class _Variant:
    __slots__ = ("name", "predict", "params", "verified", "parity")

    def __init__(self, name, predict, params, verified=False):
        self.name = name
        self.predict = predict
        self.params = params
        self.verified = verified
        self.parity: dict | None = None


class InferenceEngine:
    """Bucket-warmed forward on one device.

    Parameters
    ----------
    state_dict:
        torch-layout weights (``conv1.weight`` ... ``fc2.bias``).
    device:
        ``None`` = ``cuda`` (raises without a card); ``"cpu"`` on request.
    buckets / max_bucket:
        The batch-size ladder (default powers of two up to 128).
    dtypes:
        Extra variants beside f32 (subset of :data:`VARIANT_DTYPES`).
    packed:
        Packed ragged batching: the ladder collapses to one rows-capacity
        and the forward takes a segment-id vector.
    metrics:
        Optional :class:`ServingMetrics`; per-dispatch occupancy is
        recorded when present.
    """

    def __init__(
        self,
        state_dict: dict[str, torch.Tensor],
        device: str | torch.device | None = None,
        buckets: Sequence[int] | None = None,
        max_bucket: int | None = None,
        dtypes: Sequence[str] = (),
        packed: bool = False,
        metrics: ServingMetrics | None = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # cuDNN runs f32 convolutions in TF32 by default (about three
            # decimal digits), which would put the f32 variant — the
            # parity gate's reference — ~1e-3 off the f32 model.  Full f32
            # for convs and matmuls, process-wide.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if buckets is None:
            buckets = pow2_buckets(max_bucket or DEFAULT_MAX_BUCKET)
        elif max_bucket is not None:
            raise ValueError("pass buckets or max_bucket, not both")
        self.buckets = validate_buckets(buckets)
        self.packed = bool(packed)
        if self.packed:
            self.buckets = packed_capacities(self.buckets[-1])
        if any(k.split(".")[0].startswith("bn") for k in state_dict):
            raise ValueError(
                "BatchNorm checkpoints are not served by this port yet"
            )
        state = {
            f"{layer}.{leaf}": state_dict[f"{layer}.{leaf}"]
            .detach().to("cpu", torch.float32).contiguous()
            for layer in LAYERS
            for leaf in ("weight", "bias")
        }
        # Content address of the served weights, hashed once on the host.
        self.weights_digest = weights_digest(state)
        model = Net()
        model.load_state_dict(state)
        model.to(self.device).eval().requires_grad_(False)
        self.metrics = metrics
        self._variants: dict[str, _Variant] = {
            DEFAULT_DTYPE: _Variant(
                DEFAULT_DTYPE,
                make_packed_predict_step() if self.packed else make_predict_step(),
                model,
                verified=True,  # the parity reference itself
            )
        }
        for name in dtypes or ():
            if name == DEFAULT_DTYPE or name in self._variants:
                continue
            if name != "int8":
                raise ValueError(
                    f"unknown serving dtype {name!r}; have "
                    f"{(DEFAULT_DTYPE, *VARIANT_DTYPES)}"
                )
            self._variants[name] = _Variant(
                name,
                make_packed_int8_predict_step()
                if self.packed
                else make_int8_predict_step(),
                qparams_to(quantize_params(state), self.device),
            )
        self.warmed = False
        # Direct-call staging (predict_logits): one slot per bucket, read
        # back before the next chunk stages.
        self._staging = StagingPool(
            self.buckets, INPUT_SHAPE, slots=1, pin=self.device.type == "cuda"
        )

    # -- construction helpers -------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "InferenceEngine":
        """Any checkpoint the JAX package writes (``--save-model`` .pt or
        npz, ``--save-state`` archive) -> engine."""
        return cls(load_inference_state(path), **kwargs)

    @classmethod
    def from_seed(cls, seed: int = 1, **kwargs) -> "InferenceEngine":
        """Fresh torch-default-init weights from ``torch.Generator`` seed
        ``seed`` — the no-checkpoint path of smoke runs and load tests.
        (torch's and JAX's generators differ: these are not the JAX
        package's seed-``seed`` weights.)"""
        net = Net(torch.Generator().manual_seed(seed))
        return cls(net.state_dict(), **kwargs)

    # -- variant surface --------------------------------------------------------

    @property
    def dtypes(self) -> tuple[str, ...]:
        """Served dtype names, default first."""
        return tuple(self._variants)

    @property
    def default_dtype(self) -> str:
        return DEFAULT_DTYPE

    def variant_verified(self, dtype: str | None) -> bool:
        v = self._variants.get(dtype or DEFAULT_DTYPE)
        return v is not None and v.verified

    @property
    def parity_report(self) -> dict[str, dict]:
        return {
            v.name: v.parity for v in self._variants.values() if v.parity is not None
        }

    def _variant_for(self, dtype: str | None) -> _Variant:
        name = dtype or DEFAULT_DTYPE
        v = self._variants.get(name)
        if v is None:
            raise ValueError(f"dtype {name!r} is not served; have {list(self._variants)}")
        return v

    # -- dispatch ---------------------------------------------------------------

    def _run_variant(self, v: _Variant, staged, seg=None) -> torch.Tensor:
        """One bucket-shaped batch through a variant, bypassing the gate
        (warmup and the gate itself come through here).  ``staged`` is a
        host array or tensor; packed mode with ``seg=None`` runs the whole
        buffer as one live segment."""
        x = torch.as_tensor(staged).to(self.device, non_blocking=True)
        with torch.inference_mode():
            if not self.packed:
                return v.predict(v.params, x)
            if seg is None:
                seg = np.zeros(len(x), np.int32)
            seg = torch.as_tensor(seg).to(self.device, non_blocking=True)
            return v.predict(v.params, x, seg)

    def warmup(self, on_rung=None) -> list[tuple[str, int]]:
        """Run every (variant, bucket) rung once — cuDNN's algorithm
        choice, the kernel build and the first launch all happen here, not
        on a request.  ``on_rung(dtype, bucket, rungs_done)`` fires after
        each.  Returns the rungs in order."""
        done: list[tuple[str, int]] = []
        for name, v in self._variants.items():
            for b in self.buckets:
                self._run_variant(v, np.zeros((b, *INPUT_SHAPE), np.float32))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                done.append((name, b))
                if on_rung is not None:
                    on_rung(name, b, len(done))
        self.warmed = True
        return done

    # -- parity gate ------------------------------------------------------------

    def _parity_slice(self) -> tuple[np.ndarray, int]:
        """The fixed, seeded eval slice (raw pixels through the training
        normalize), sized to the largest warmed bucket <= PARITY_ROWS."""
        fits = [b for b in self.buckets if b <= PARITY_ROWS]
        bucket = fits[-1] if fits else self.buckets[0]
        raw = np.random.RandomState(PARITY_SEED).randint(0, 256, (bucket, 28, 28))
        return normalize(raw.astype(np.uint8)), bucket

    def verify_parity(self, tol: dict[str, float] | None = None) -> dict[str, dict]:
        """Gate every unverified variant against the f32 forward.

        A variant passes iff ``max |log_prob - log_prob_f32| <= tol[dtype]``
        (:data:`PARITY_TOL` defaults) AND argmax is identical on every row
        of the slice.  Passing makes it servable; failing leaves it
        refused.  Near-untrained weights can rightly fail int8's argmax
        check: nearly uniform logits put real ties inside the quantization
        error.
        """
        pending = [
            v for v in self._variants.values()
            if v.name != DEFAULT_DTYPE and not v.verified
        ]
        results: dict[str, dict] = {}
        if not pending:
            return results
        x, bucket = self._parity_slice()
        ref = self._run_variant(self._variants[DEFAULT_DTYPE], x).cpu().numpy()
        for v in pending:
            out = self._run_variant(v, x).cpu().numpy()
            max_diff = float(np.abs(out - ref).max())
            argmax_ok = bool((out.argmax(axis=1) == ref.argmax(axis=1)).all())
            tolerance = float((tol or {}).get(v.name, PARITY_TOL.get(v.name, 0.25)))
            passed = argmax_ok and max_diff <= tolerance
            v.verified = passed
            v.parity = {
                "dtype": v.name,
                "rows": int(bucket),
                "max_abs_logit_diff": max_diff,
                "tolerance": tolerance,
                "argmax_identical": argmax_ok,
                "passed": passed,
            }
            results[v.name] = v.parity
            if self.metrics is not None:
                self.metrics.registry.gauge(
                    "serving_variant_verified",
                    help="1 = the dtype variant passed its parity gate and "
                    "may serve; 0 = refused",
                    dtype=v.name,
                ).set(1.0 if passed else 0.0)
        return results

    # -- serving ----------------------------------------------------------------

    def launch(
        self,
        staged,
        n: int,
        dtype: str | None = None,
        seg_ids: np.ndarray | None = None,
    ) -> DeviceResult:
        """Dispatch one bucket-shaped batch WITHOUT waiting for it.

        ``staged`` (``[bucket, 28, 28, 1]``, live rows first) must be a
        warmed bucket shape; ``n`` is the live row count.  Packed mode
        takes the ``seg_ids`` vector too.  An unverified variant raises
        :class:`UnverifiedVariantError`.  Returns a :class:`DeviceResult`.
        """
        v = self._variant_for(dtype)
        bucket = len(staged)
        if seg_ids is not None and not self.packed:
            raise ValueError("seg_ids passed to a bucketed engine")
        if seg_ids is not None and len(seg_ids) != bucket:
            raise ValueError(
                f"seg_ids length {len(seg_ids)} does not match the {bucket}-row buffer"
            )
        if bucket not in self.buckets:
            raise ValueError(
                f"staged batch of {bucket} rows is not a warmed bucket {self.buckets}"
            )
        if not 1 <= n <= bucket:
            raise ValueError(f"live rows {n} outside [1, {bucket}]")
        if not v.verified:
            raise UnverifiedVariantError(
                f"variant {v.name!r} has not passed its parity gate "
                "(engine.verify_parity); refusing to serve it"
            )
        result = DeviceResult(self._run_variant(v, staged, seg=seg_ids))
        if self.metrics is not None:
            self.metrics.record_batch(n, bucket)
        return result

    def predict_logits(self, x: np.ndarray, dtype: str | None = None) -> np.ndarray:
        """``[n, 28, 28, 1]`` normalized float32 -> ``[n, 10]`` log-probs.

        Pads into the preallocated staging buffers, dispatches, slices the
        padding off; ``n`` above the top bucket is chunked.  Serial: each
        chunk is read back before the next stages."""
        x = np.asarray(x, np.float32)
        if x.ndim != 1 + len(INPUT_SHAPE) or x.shape[1:] != INPUT_SHAPE:
            raise ValueError(
                f"expected [n, {', '.join(map(str, INPUT_SHAPE))}] input, "
                f"got shape {x.shape}"
            )
        n = len(x)
        if n == 0:
            raise ValueError("empty batch")
        top = self.buckets[-1]
        outs = []
        for start in range(0, n, top):
            chunk = x[start : start + top]
            staged, bucket = self._staging.stage([chunk])
            try:
                result = self.launch(staged, len(chunk), dtype=dtype)
                outs.append(result.wait()[: len(chunk)].copy())
            finally:
                self._staging.release(staged, bucket)
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        if out.shape != (n, NUM_CLASSES):
            raise RuntimeError(f"forward returned {out.shape}, want {(n, NUM_CLASSES)}")
        return out
