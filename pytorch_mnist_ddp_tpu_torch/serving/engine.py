"""The inference engine: checkpoint -> warmed bucket rungs -> log-probs.

Lifecycle: construct (weights placed on the device), :meth:`warmup` (run
every (variant, bucket) rung once), :meth:`verify_parity` (gate the
reduced-precision variants against f32), then
:meth:`launch`/:meth:`predict_logits` from the dispatch thread.

Variants (the JAX package's): ``f32`` (the eval-mode
:class:`~..models.net.Net`) is always served and is the parity reference;
``dtypes=("bf16",)`` adds the bf16 forward (activations and products in
bf16, parameters f32, the log_softmax tail f32), ``("int8",)`` the
per-channel-quantized forward (models/quant.py) with its dense head from
``int8_impl``: ``"pallas"`` (the default) is the CUDA kernel of
``ops/int8_head.py`` on the card, with no fallback from it, ``"dot"`` two
library int8 GEMMs.  ``compute_dtype=torch.bfloat16`` (the CLI's
``--bf16``) serves the DEFAULT forward in bf16 and then takes no
variants: the gates need their f32 reference.  ``conv_impl`` picks the
f32/bf16 forwards' convolution lowering.  A BatchNorm checkpoint
(``--syncbn``) serves at f32 and bf16, normalizing by its running
averages; the int8 variant refuses it.  A variant is REFUSED
(:class:`UnverifiedVariantError`) until its parity gate passes: logit
tolerance plus argmax-identical against f32 on a fixed, seeded eval
slice.

Versioned weights (the registry's swap and canary, serving/rollout.py):
a dispatch reads its variant's weight reference once, so
:meth:`publish_weights` swaps by reassigning the reference — a batch
already launched runs on the tensors it read, the next one on the new
ones, and nothing is ever copied into tensors a batch in flight reads.
:meth:`install_version` adds ``{dtype}@{version}`` twins beside the
primary variants (the batcher coalesces by variant key, so no batch mixes
versions), :meth:`remove_version` drops them.

Threading contract: one thread (the micro-batcher's dispatch worker, or
the caller in direct use) calls ``launch``/``predict_logits``; the
rollout controller's weight calls arrive from admin threads and only
swap references.  :meth:`DeviceResult.wait` on a launched batch is safe
from a second thread — the batcher's completion worker — because it
waits on that batch's own CUDA event, not on the whole device.

Streams: on the card every engine owns a ``torch.cuda.Stream``, and
everything it puts on the device — the weights' placement, a batch's
staging copy, the forward (the int8 head kernel launches on the current
stream), the read-back copy and its event — goes on that stream.  Two
pool replicas sharing one card therefore never queue behind each other's
work, a completion wait measures its own batch only, and warmup waits on
the engine's stream, not on the whole card.  ``torch.cuda.Stream`` hands
out a card's 32 pooled streams in turn, so 32 streams taken later an
engine's stream comes round again; the pool refuses replicas that share one.

Warmup (``compile/``): every (variant, bucket) rung is a
:class:`~..compile.Program` named as the JAX engine's warmup jobs
(``predict_step[{bucket}]`` for f32, ``predict_step[{dtype}][{bucket}]``
for the others): the kernel libraries it launches (``int8_head`` for the
int8 variant under ``int8_impl="pallas"`` on the card; none on the CPU or
for f32/bf16), loaded through the ``aot_cache`` store when there is one,
and a warm step that runs the rung once and waits on the engine's stream.
The rungs run in ladder order on the calling thread: one engine has one
stream, and at most one library (``int8_head``), which its first int8
rung loads, so it has nothing to build concurrently; that choice is the
replica pool's (``EnginePool.warmup``, ``--serial-warmup``).  Each rung
is a ``compile`` span and lands on ``compile_seconds_total{fn=}`` and
``compile_programs_total{fn=}``.  A rung that a request reaches before
its warmup builds there, on the dispatch thread (:meth:`launch`), as the
JAX engine traces an unwarmed bucket on its first call: the same span
and counters, which the load generator's compile firewall reads.  A
canary twin shares its base variant's Programs (the JAX engine's shared
grid), so ``install_version`` runs no rung and adds no store entry:
libraries do not depend on weights.

Device staging (``device_stage``, on by default, as the JAX engine's auto
default is on for one process): a batch goes from a pinned host buffer to
the card by a ``non_blocking`` copy on the engine's stream.  Off
(``--no-device-stage``), the buffers are pageable and the copy blocks.

Sharded replicas (``shard_kind`` ``"tp"``/``"vtp"``/``"ep"``/``"pp"`` over
a ``mesh`` from ``serving/devices.py``): the engine is one replica over
``k`` devices, its default forward the kind's (``serving/sharded.py``) over
``k`` shard copies of the model, each shard on a stream of its own device,
the batch staged and the answer read back on ``mesh.devices[0]`` on the
engine's stream.  The JAX engine's refusals hold (f32 only, no BatchNorm
tree, the reference conv, the kind's model family), and the default
variant starts UNVERIFIED: :meth:`verify_sharded_parity` holds it to the
family's single-device forward before :meth:`launch` serves it.  An EP
dispatch also returns the per-expert kept-token counts, read into the
``serving_expert_load`` gauges one dispatch late (:meth:`flush_expert_load`
reads the last one).  A sharded replica serves its weights as built: the
registry's swap and canary refuse it.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..analysis.lockwatch import make_lock
from ..compile import ExecutableStore, Program
from ..compile.service import timed
from ..data.transforms import normalize
from ..device import resolve_device
from ..models.net import CONV_IMPLS, INPUT_SHAPE, NUM_CLASSES, Net
from ..models.quant import INT8_IMPLS, qparams_to, quantize_params
from ..ops import _build
from ..parallel.mesh import Lockstep
from ..utils.checkpoint import jax_stats_from_torch, load_inference_state
from ..utils.convert import BN_LAYERS, LAYERS, has_bn, jax_state_from_torch, jax_vit_tree_from_torch
from . import sharded
from .buckets import (
    DEFAULT_MAX_BUCKET,
    StagingPool,
    packed_capacities,
    pow2_buckets,
    validate_buckets,
)
from .devices import SHARD_KINDS, ReplicaMesh, replica_mesh
from .metrics import ServingMetrics
from .predict import (
    make_int8_predict_step,
    make_packed_int8_predict_step,
    make_packed_predict_step,
    make_predict_step,
)

DEFAULT_DTYPE = "f32"

# Separator between a dtype and a pinned model version in a variant key
# ("f32@v2"): the rollout controller installs a canary version's weights
# as parallel variants under these keys.  Client "dtype" fields must not
# contain it (the server refuses them).
VERSION_SEP = "@"

VARIANT_DTYPES = ("bf16", "int8")

# Parity-gate tolerances: max |log_prob_variant - log_prob_f32| over the
# slice.  argmax-identity is the sharp edge.
PARITY_TOL = {"bf16": 0.25, "int8": 1.0}

# Rows in the fixed parity slice (the largest warmed bucket <= this) and
# its seed: a variant that passes once passes every restart.
PARITY_ROWS = 64
PARITY_SEED = 20260803


def _tree_leaves(tree: Mapping[str, Any]) -> list[np.ndarray]:
    """A nested dict's leaves in JAX's tree-flatten order (sorted keys at
    every level)."""
    out: list[np.ndarray] = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            out.extend(_tree_leaves(value))
        else:
            out.append(value)
    return out


def _served_tree(state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """A state dict as the JAX serving engine's served tree: the param tree
    in JAX layout (``utils/convert.py``; a ViT's too), and for a BatchNorm
    state with running averages ``{"params": ..., "batch_stats": ...}``."""
    if any(str(k).startswith("blocks.") for k in state):
        return jax_vit_tree_from_torch(state)
    params = jax_state_from_torch(state)
    stats = jax_stats_from_torch(state) if has_bn(state) else {}
    return {"params": params, "batch_stats": stats} if stats else params


def weights_digest(state: Mapping[str, torch.Tensor]) -> str:
    """Content hash of the served weights, equal to the JAX package's
    ``serving/engine.py:weights_digest`` of the same weights: each leaf of
    :func:`_served_tree`, in JAX's tree order, contributes its shape/dtype
    tag and raw bytes."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in _tree_leaves(_served_tree(state)):
        arr = np.ascontiguousarray(leaf)
        h.update(f"{arr.shape}{arr.dtype}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class UnverifiedVariantError(RuntimeError):
    """A variant was asked to serve before (or after failing) its parity
    gate."""


class ParityError(AssertionError):
    """``verify_sharded_parity(raise_on_failure=True)`` found the gate
    failing."""


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
    __slots__ = ("name", "predict", "params", "verified", "parity", "libraries")

    def __init__(self, name, predict, params, verified=False, libraries=()):
        self.name = name
        self.predict = predict
        self.params = params
        self.verified = verified
        self.parity: dict | None = None
        self.libraries = tuple(libraries)  # kernel libraries its forward launches


class InferenceEngine:
    """Bucket-warmed forward on one device.

    Parameters
    ----------
    state_dict:
        torch-layout weights (``conv1.weight`` ... ``fc2.bias``, and for a
        BatchNorm model ``bnN.weight/bias`` with optional running
        averages, which default to mean 0 / var 1 as in the JAX engine).
    device:
        ``None`` = ``cuda`` (raises without a card); ``"cpu"`` on request.
    buckets / max_bucket:
        The batch-size ladder (default powers of two up to 128).
    compute_dtype:
        The DEFAULT forward's dtype (``torch.bfloat16`` = ``--bf16``);
        refused together with ``dtypes``.
    conv_impl:
        Convolution lowering of the f32/bf16 forwards (``CONV_IMPLS``).
    dtypes:
        Extra variants beside f32 (subset of :data:`VARIANT_DTYPES`).
    packed:
        Packed ragged batching: the ladder collapses to one rows-capacity
        and the forward takes a segment-id vector.
    metrics:
        Optional :class:`ServingMetrics`; per-dispatch occupancy is
        recorded when present.
    int8_impl:
        The int8 variant's dense head: ``"pallas"`` (the kernel) or
        ``"dot"`` (library GEMMs).
    version:
        The registry version of the served weights (``""`` without one).
    aot_cache:
        Directory of the kernel-library store (``compile/aot.py``), or an
        ``ExecutableStore`` to share (the replica pool passes one to every
        engine): a warm start loads the libraries with no ``nvcc`` run.
        Omitted = the build directory (``ops/_build.py``).
    device_stage:
        Stage batches in pinned buffers and copy them ``non_blocking`` on
        the engine's stream (the default); False = pageable buffers and a
        blocking copy.
    shard_kind / mesh:
        ``"dp"`` (the default) is one whole model on ``device``; a sharded
        kind needs a :class:`~.devices.ReplicaMesh` of its kind
        (``devices.replica_mesh``) and serves over its devices, inputs and
        answers on the first (module docstring); ``device`` is then not
        passed.  Every bucket must split over the mesh's data axis.
    vit_cfg:
        The ``vtp``/``ep`` model config (default ``sharded.default_vit_cfg``;
        EP's holds capacity-factor headroom so routing drops no token).
    pp_microbatches:
        The pipeline's microbatch count (``pp``); every bucket must divide
        by it.
    """

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor],
        device: str | torch.device | None = None,
        buckets: Sequence[int] | None = None,
        max_bucket: int | None = None,
        compute_dtype: torch.dtype | None = None,
        conv_impl: str = "conv",
        dtypes: Sequence[str] = (),
        packed: bool = False,
        metrics: ServingMetrics | None = None,
        int8_impl: str = "pallas",
        version: str = "",
        aot_cache: str | ExecutableStore | None = None,
        device_stage: bool = True,
        shard_kind: str = "dp",
        mesh: ReplicaMesh | None = None,
        vit_cfg=None,
        pp_microbatches: int = 2,
    ):
        self.version = str(version)
        self.shard_kind = str(shard_kind)
        if self.shard_kind not in SHARD_KINDS:
            raise ValueError(f"unknown shard kind {self.shard_kind!r}; have {SHARD_KINDS}")
        is_sharded = self.shard_kind != "dp"
        if is_sharded and mesh is None:
            raise ValueError(
                f"shard kind {self.shard_kind!r} needs an explicit replica "
                "mesh (serving.devices.replica_mesh); defaulting to one "
                "device would silently serve the wrong topology"
            )
        if mesh is None:
            mesh = replica_mesh("dp", 1, [resolve_device(device)])
        elif device is not None:
            raise ValueError("pass device or mesh, not both")
        elif mesh.kind != self.shard_kind:
            raise ValueError(f"shard kind {self.shard_kind!r} on a {mesh.kind!r} replica mesh")
        # Asking for a card without one raises, for every shard's device.
        self.mesh = ReplicaMesh(mesh.kind, mesh.k, tuple(resolve_device(d) for d in mesh.devices),
                                mesh.data, mesh.model)
        self.device = self.mesh.devices[0]
        self.device_stage = bool(device_stage)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # Warmup rungs run, ever: a pool's restart or add must run none.
        self.rungs_run = 0
        self._late_build = make_lock("engine.late_build")  # a rung built on a request's path
        if self.device.type == "cuda":
            # cuDNN runs f32 convolutions in TF32 by default (about three
            # decimal digits), which would put the f32 variant — the
            # parity gate's reference — ~1e-3 off the f32 model.  Full f32
            # for convs and matmuls, process-wide.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        n_shards = self.mesh.data
        if buckets is None:
            buckets = pow2_buckets(max_bucket or DEFAULT_MAX_BUCKET, n_shards)
        elif max_bucket is not None:
            raise ValueError("pass buckets or max_bucket, not both")
        self.buckets = validate_buckets(buckets, n_shards)
        self.packed = bool(packed)
        if self.packed:
            self.buckets = packed_capacities(self.buckets[-1], n_shards)
        self.pp_microbatches = int(pp_microbatches)
        if self.shard_kind == "pp":
            if self.pp_microbatches < 1:
                raise ValueError(f"pp_microbatches must be >= 1, got {self.pp_microbatches}")
            bad = [b for b in self.buckets if b % self.pp_microbatches]
            if bad:
                raise ValueError(
                    f"buckets {bad} do not divide by {self.pp_microbatches} "
                    "pipeline microbatches; every warmed rung must split "
                    "evenly into the microbatch schedule"
                )
        if int8_impl not in INT8_IMPLS:
            raise ValueError(f"unknown int8 impl {int8_impl!r} (want dot|pallas)")
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r} not in {CONV_IMPLS}")
        self.int8_impl = int8_impl
        self.conv_impl = conv_impl
        compute_dtype = compute_dtype or torch.float32
        self._vit_cfg = None
        if is_sharded:
            self._refuse_for_sharded(state_dict, dtypes, conv_impl, compute_dtype)
            if self.shard_kind in ("vtp", "ep"):
                self._vit_cfg = vit_cfg if vit_cfg is not None else sharded.default_vit_cfg(
                    self.shard_kind)
        if dtypes and compute_dtype != torch.float32:
            raise ValueError(
                "a non-f32 default compute_dtype cannot anchor the "
                "variants' parity gates; drop the legacy --bf16 flag and "
                "request the reduced-precision path via dtypes=('bf16',) "
                "instead"
            )
        state = (self._served_state(state_dict) if self._vit_cfg is None else
                 {k: v.detach().to("cpu", torch.float32).contiguous()
                  for k, v in state_dict.items()})
        self.use_bn = has_bn(state)
        # Content address of the served weights (the response cache's
        # key), hashed once on the host.
        self.weights_digest = weights_digest(state)
        self._shapes = {k: tuple(v.shape) for k, v in state.items()}
        # A sharded replica: the host weights (the gate's reference reads
        # them), its shards' streams and its shard models.
        self._host_served = state
        self._lockstep = Lockstep(self.mesh.devices) if is_sharded else None
        self._reference_fn = None
        self._pending_expert_load: DeviceResult | None = None
        if is_sharded:
            default_fn = sharded.build_predict_fn(
                self.shard_kind, self._lockstep, vit_cfg=self._vit_cfg,
                pp_microbatches=self.pp_microbatches, packed=self.packed)
            self._model = None
            default_params = sharded.place_params(self.shard_kind, state, self.mesh,
                                                  self._vit_cfg, self._lockstep)
        else:
            make_default = make_packed_predict_step if self.packed else make_predict_step
            default_fn = make_default(compute_dtype, conv_impl)
            self._model = default_params = self._place(state)
        self.metrics = metrics
        self.store = aot_cache
        if aot_cache is not None and not isinstance(aot_cache, ExecutableStore):
            self.store = ExecutableStore(
                aot_cache, registry=metrics.registry if metrics is not None else None)
        # (base variant, bucket) -> its warmup Program; canary twins share them
        self._programs: dict[tuple[str, int], Program] = {}
        # The dp default is the parity reference itself; a sharded default
        # is served only once verify_sharded_parity passes it.
        self._variants: dict[str, _Variant] = {
            DEFAULT_DTYPE: _Variant(DEFAULT_DTYPE, default_fn, default_params,
                                    verified=not is_sharded)
        }
        for name in dtypes or ():
            if name == DEFAULT_DTYPE or name in self._variants:
                continue
            self._variants[name] = self._build_variant(name, state)
        self.warmed = False
        # Direct-call staging (predict_logits): one slot per bucket, read
        # back before the next chunk stages.
        self._staging = StagingPool(self.buckets, INPUT_SHAPE, slots=1,
                                    pin=self.device.type == "cuda" and self.device_stage)

    # -- weights ------------------------------------------------------------------

    def _refuse_for_sharded(self, state_dict, dtypes, conv_impl, compute_dtype) -> None:
        """The JAX engine's refusals of a sharded replica, with its words."""
        if dtypes:
            raise ValueError(
                f"sharded replicas serve f32 only; dtypes="
                f"{tuple(dtypes)} cannot ride shard kind "
                f"{self.shard_kind!r} (the parity anchor is the "
                "single-device f32 forward; mix precisions at the "
                "POOL level with heterogeneous replicas instead)"
            )
        if has_bn(state_dict):
            raise ValueError(
                f"shard kind {self.shard_kind!r} has no BN-aware "
                "sharded forward; serve BN checkpoints on DP replicas"
            )
        if conv_impl != "conv":
            raise ValueError(
                f"shard kind {self.shard_kind!r} serves the reference "
                f"conv impl only; got conv_impl={conv_impl!r}"
            )
        if compute_dtype != torch.float32:
            raise ValueError("sharded replicas serve f32 only; drop compute_dtype")
        sharded.validate_family(self.shard_kind, state_dict)

    @staticmethod
    def _served_state(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The served parameters as float32 CPU tensors; a BatchNorm
        state's missing running averages start at mean 0 / var 1."""
        bn = has_bn(state_dict)
        layers = LAYERS + (tuple(BN_LAYERS) if bn else ())
        keys = [f"{layer}.{leaf}" for layer in layers for leaf in ("weight", "bias")]
        missing = sorted(k for k in keys if k not in state_dict)
        if missing:
            raise ValueError(f"state dict is missing {missing}")
        state = {k: state_dict[k].detach().to("cpu", torch.float32).contiguous()
                 for k in keys}
        for layer, features in BN_LAYERS.items() if bn else ():
            for leaf, init in (("running_mean", torch.zeros), ("running_var", torch.ones)):
                key = f"{layer}.{leaf}"
                state[key] = (state_dict[key].detach().to("cpu", torch.float32).contiguous()
                              if key in state_dict else init(features))
        return state

    @property
    def streams(self) -> tuple:
        """Every CUDA stream this engine puts work on: its own, then its
        shards' (none on the CPU)."""
        shards = self._lockstep.streams if self._lockstep is not None else ()
        return tuple(s for s in (self.stream, *shards) if s is not None)

    def on_stream(self):
        """A context in which torch's current stream is this engine's (a
        no-op on the CPU)."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def _place(self, state: dict[str, torch.Tensor]) -> Net:
        model = Net(torch.Generator(), use_bn=self.use_bn)
        model.load_state_dict(state)
        with self.on_stream():
            return model.to(self.device).eval().requires_grad_(False)

    def _variant_weights(self, name: str, state: dict, model: Net):
        """A variant's weights for a served state: int8 quantizes, f32 and
        bf16 share the placed model."""
        if name.split(VERSION_SEP)[0] != "int8":
            return model
        with self.on_stream():
            return qparams_to(quantize_params(state), self.device)

    def _build_variant(self, name: str, state: dict) -> _Variant:
        if name == "bf16":
            make = make_packed_predict_step if self.packed else make_predict_step
            return _Variant(name, make(torch.bfloat16, self.conv_impl), self._model)
        if name == "int8":
            if self.use_bn:
                raise ValueError(
                    "int8 variant does not support BatchNorm checkpoints; "
                    "serve BN checkpoints at f32 or bf16"
                )
            make = make_packed_int8_predict_step if self.packed else make_int8_predict_step
            kernel = self.int8_impl == "pallas" and self.device.type == "cuda"
            return _Variant(name, make(self.int8_impl),
                            self._variant_weights(name, state, self._model),
                            libraries=("int8_head",) if kernel else ())
        raise ValueError(
            f"unknown serving dtype {name!r}; have {(DEFAULT_DTYPE, *VARIANT_DTYPES)}"
        )

    # -- construction helpers -------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "InferenceEngine":
        """Any checkpoint the JAX package writes (``--save-model`` .pt or
        npz, ``--save-state`` archive, with or without BatchNorm) ->
        engine."""
        return cls(load_inference_state(path), **kwargs)

    @classmethod
    def from_seed(cls, seed: int = 1, **kwargs) -> "InferenceEngine":
        """Fresh torch-default-init weights from ``torch.Generator`` seed
        ``seed`` — the no-checkpoint path of smoke runs and load tests.
        (torch's and JAX's generators differ: these are not the JAX
        package's seed-``seed`` weights.)  A sharded ``shard_kind`` seeds
        the family it serves: the ViT for vtp, the MoE ViT for ep, the CNN
        otherwise."""
        kind = kwargs.get("shard_kind", "dp")
        if kind in ("vtp", "ep") and kwargs.get("vit_cfg") is None:
            kwargs["vit_cfg"] = sharded.default_vit_cfg(kind)
        return cls(sharded.seed_params(kind, seed, kwargs.get("vit_cfg")), **kwargs)

    # -- variant surface --------------------------------------------------------

    @property
    def libraries(self) -> tuple[str, ...]:
        """The kernel libraries this engine's forwards launch."""
        return tuple(sorted({lib for v in self._variants.values() for lib in v.libraries}))

    @property
    def dtypes(self) -> tuple[str, ...]:
        """Served variant keys, default first (canary twins included)."""
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
        buffer as one live segment.  The variant's weights are read once."""
        params = v.params
        with self.on_stream(), torch.inference_mode():
            x = torch.as_tensor(staged).to(self.device, non_blocking=self.device_stage)
            if not self.packed:
                out = v.predict(params, x)
            else:
                if seg is None:
                    seg = np.zeros(len(x), np.int32)
                seg = torch.as_tensor(seg).to(self.device, non_blocking=self.device_stage)
                out = v.predict(params, x, seg)
            if self.shard_kind == "ep":
                out, load = out
                self._stash_expert_load(load)
            return out

    def _stash_expert_load(self, load: torch.Tensor) -> None:
        """An EP dispatch's expert counts: read back behind the batch on the
        engine's stream, recorded into the gauges at the next dispatch (by
        then it is on the host), so the dispatch thread never waits on its
        own batch for them."""
        self.flush_expert_load()
        self._pending_expert_load = DeviceResult(load)

    def flush_expert_load(self) -> None:
        """Record the last EP dispatch's expert counts (the one-dispatch lag
        would otherwise hold them back): the drain and shutdown hook."""
        prev, self._pending_expert_load = self._pending_expert_load, None
        if prev is not None and self.metrics is not None:
            self.metrics.record_expert_load(prev.wait())

    def _warm_rung(self, name: str, b: int) -> None:
        """A rung's warm step: variant ``name`` once on a zero batch of
        ``b`` rows, waited on this engine's stream only."""
        self._run_variant(self._variants[name], np.zeros((b, *INPUT_SHAPE), np.float32))
        if self.stream is not None:
            self.stream.synchronize()
        self.rungs_run += 1

    def _program_for(self, name: str, b: int) -> Program:
        """The (variant, bucket) rung as a :class:`~..compile.Program`; a
        canary twin's is its base variant's."""
        base = name.split(VERSION_SEP)[0]
        prog = self._programs.get((base, b))
        if prog is None:
            label = f"predict_step[{b}]" if base == DEFAULT_DTYPE else f"predict_step[{base}][{b}]"
            prog = Program(label, self._variants[base].libraries, warm=self._warm_rung,
                           example_args=(base, b), store=self.store)
            self._programs[(base, b)] = prog
        return prog

    def warmup(self, on_rung=None, sink=None) -> list[tuple[str, int]]:
        """Build every (variant, bucket) rung's Program once, in ladder
        order: its kernel libraries (through the store with ``aot_cache``),
        then its warm step (cuDNN's plan choice and the first launch happen
        here, not on a request), which waits on this engine's stream only.
        ``on_rung(dtype, bucket, rungs_done)`` fires after each.  ``sink``
        takes the ``compile`` spans.  Returns the rungs in order."""
        registry = self.metrics.registry if self.metrics is not None else None
        done: list[tuple[str, int]] = []
        for name in self._variants:
            for b in self.buckets:
                prog = self._program_for(name, b)
                if not prog.built:
                    timed(prog.name, prog.build, registry=registry, sink=sink)
                done.append((name, b))
                if on_rung is not None:
                    on_rung(name, b, len(done))
        # The warm steps' zero batches routed somewhere; keep that out of
        # the expert-load gauges.
        self._pending_expert_load = None
        self.warmed = True
        return done

    def _build_late(self, prog: Program) -> None:
        """Build a rung no warmup built, on the request's path (module
        docstring): its span and counters move, as a JAX retrace does."""
        with self._late_build:
            if not prog.built:
                timed(prog.name, prog.build,
                      registry=self.metrics.registry if self.metrics is not None else None)

    # -- parity gate ------------------------------------------------------------

    def _parity_slice(self) -> tuple[np.ndarray, int]:
        """The fixed, seeded eval slice (raw pixels through the training
        normalize), sized to the largest warmed bucket <= PARITY_ROWS."""
        fits = [b for b in self.buckets if b <= PARITY_ROWS]
        bucket = fits[-1] if fits else self.buckets[0]
        raw = np.random.RandomState(PARITY_SEED).randint(0, 256, (bucket, 28, 28))
        return normalize(raw.astype(np.uint8)), bucket

    def verify_parity(self, tol: dict[str, float] | None = None, sink=None) -> dict[str, dict]:
        """Gate every unverified variant against the f32 forward.

        A variant passes iff ``max |log_prob - log_prob_f32| <= tol[dtype]``
        (:data:`PARITY_TOL` defaults) AND argmax is identical on every row
        of the slice.  Passing makes it servable; failing leaves it
        refused.  Near-untrained weights can rightly fail int8's argmax check:
        nearly uniform logits put real ties inside the quantization
        error.  ``sink`` gets one ``parity_gate`` event a variant.
        """
        pending = [
            v for v in self._variants.values()
            if v.name != DEFAULT_DTYPE and not v.verified
        ]
        results: dict[str, dict] = {}
        if not pending:
            return results
        x, bucket = self._parity_slice()
        with self.on_stream():  # the copies back wait on the forwards
            ref = self._run_variant(self._variants[DEFAULT_DTYPE], x).cpu().numpy()
            outs = {v.name: self._run_variant(v, x).cpu().numpy() for v in pending}
        for v in pending:
            out = outs[v.name]
            max_diff = float(np.abs(out - ref).max())
            argmax_ok = bool((out.argmax(axis=1) == ref.argmax(axis=1)).all())
            base = v.name.split(VERSION_SEP)[0]
            tolerance = float((tol or {}).get(v.name, PARITY_TOL.get(base, 0.25)))
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
            if sink:
                sink.emit("parity_gate", **v.parity)
        return results

    def verify_sharded_parity(self, tol: float | None = None, raise_on_failure: bool = False,
                              sink=None) -> dict:
        """Gate a sharded replica against the single-device forward of its
        model family (JAX ``verify_sharded_parity``): the parity slice
        through the sharded forward at a warmed bucket and through the
        reference (``sharded.reference_fn``) on the host weights, both on
        the replica's first device.  It passes iff ``max |logp_sharded -
        logp_reference| <= tol`` (default ``sharded.SHARDED_PARITY_TOL``,
        pp at exactly 0.0) AND argmax is identical on every row.  Passing
        makes the default variant servable, failing refuses it.  ``{}`` on
        a dp engine.  Returns (and records in :attr:`parity_report`) the
        result; ``raise_on_failure`` raises :class:`ParityError`."""
        if self.shard_kind == "dp":
            return {}
        v = self._variants[DEFAULT_DTYPE]
        x, bucket = self._parity_slice()
        if self._reference_fn is None:
            self._reference_fn = sharded.reference_fn(self.shard_kind, self._vit_cfg,
                                                      self.pp_microbatches)
        with self.on_stream():
            out = self._run_variant(v, x).cpu().numpy()
            ref = self._reference_fn(self._host_served,
                                     torch.from_numpy(x).to(self.device)).cpu().numpy()
        max_diff = float(np.abs(out - ref).max())
        argmax_ok = bool((out.argmax(axis=1) == ref.argmax(axis=1)).all())
        tolerance = float(sharded.SHARDED_PARITY_TOL[self.shard_kind] if tol is None else tol)
        passed = argmax_ok and max_diff <= tolerance
        v.verified = passed
        v.parity = {
            "dtype": v.name,
            "shard_kind": self.shard_kind,
            "devices": len(self.mesh.devices),
            "rows": int(bucket),
            "max_abs_logit_diff": max_diff,
            "tolerance": tolerance,
            "argmax_identical": argmax_ok,
            "passed": passed,
        }
        if self.metrics is not None:
            self.metrics.registry.gauge(
                "serving_variant_verified",
                help="1 = the dtype variant passed its parity gate and "
                "may serve; 0 = refused",
                dtype=f"{v.name}/{self.shard_kind}",
            ).set(1.0 if passed else 0.0)
        if sink:
            sink.emit("parity_gate", **v.parity)
        if raise_on_failure and not passed:
            raise ParityError(
                f"sharded parity gate failed: {self.shard_kind} "
                f"max|dlogp|={max_diff:.4g} (tol {tolerance:g}), "
                f"argmax_identical={argmax_ok}"
            )
        return v.parity

    # -- the registry's swap surface (serving/registry.py, rollout.py) ---------

    def _prepare_weights(self, state_dict: Mapping[str, torch.Tensor]):
        """Validate and place incoming weights against the served ones:
        the same BatchNorm-ness, keys and shapes.  A sharded replica
        refuses."""
        if self.shard_kind != "dp":
            raise ValueError(
                f"weight publish into a sharded ({self.shard_kind}) "
                "replica is not supported: a swap would have to re-place "
                "the tree over the replica's shards and re-gate "
                "parity mid-serve; drain the replica and rebuild it on "
                "the new checkpoint instead"
            )
        bn = has_bn(state_dict)
        if bn != self.use_bn:
            raise ValueError(
                f"cannot publish a {'BN' if bn else 'non-BN'} "
                f"checkpoint into a {'BN' if self.use_bn else 'non-BN'} "
                "engine: the warmed executables are specialized to the "
                "served tree"
            )
        state = self._served_state(state_dict)
        if {k: tuple(v.shape) for k, v in state.items()} != self._shapes:
            raise ValueError(
                "published variable tree does not match the served tree "
                "(structure or leaf shapes differ); versions of one "
                "model must share an architecture — register a new "
                "model name for a new architecture instead"
            )
        return state, weights_digest(state), self._place(state)

    def publish_weights(self, state_dict: Mapping[str, torch.Tensor],
                        version: str | None = None) -> str:
        """Republish the PRIMARY served weights: every primary variant's
        weight reference is replaced (int8 re-quantized); version-pinned
        canary variants keep theirs.  A batch in flight completes on the
        tensors it read; the next dispatch reads the new ones.  Returns
        the new weights digest (the response cache's invalidation key)."""
        state, digest, model = self._prepare_weights(state_dict)
        for key, v in list(self._variants.items()):
            if VERSION_SEP not in key:
                v.params = self._variant_weights(key, state, model)
        self._model = model
        self.weights_digest = digest
        if version is not None:
            self.version = str(version)
        return digest

    def install_version(self, version: str, state_dict: Mapping[str, torch.Tensor],
                        verified: bool | None = None) -> str:
        """Install VERSION's weights as ``{dtype}@{version}`` twins beside
        each primary variant (the canary).  ``verified`` overrides the gate
        state (default: the base variant's).  Returns the digest."""
        version = str(version)
        if not version or VERSION_SEP in version:
            raise ValueError(
                f"bad version {version!r}: must be non-empty and free of "
                f"{VERSION_SEP!r}"
            )
        state, digest, model = self._prepare_weights(state_dict)
        variants = dict(self._variants)
        for name, base in list(variants.items()):
            if VERSION_SEP in name:
                continue
            key = f"{name}{VERSION_SEP}{version}"
            variants[key] = _Variant(
                key, base.predict, self._variant_weights(name, state, model),
                verified=base.verified if verified is None else verified,
                libraries=base.libraries,
            )
        # One reference swap: a reader sees the old table or the new one.
        self._variants = variants
        return digest

    def remove_version(self, version: str) -> int:
        """Drop VERSION's pinned variants (rollback, or after a promote).
        Batches already dispatched on them complete normally.  Returns the
        number removed."""
        suffix = VERSION_SEP + str(version)
        variants = {k: v for k, v in self._variants.items() if not k.endswith(suffix)}
        removed = len(self._variants) - len(variants)
        self._variants = variants
        return removed

    def version_divergence(self, version: str) -> dict:
        """Max |dlogit| and argmax agreement between the primary f32
        forward and VERSION's pinned f32 variant on the parity slice (the
        canary's drift probe)."""
        key = f"{DEFAULT_DTYPE}{VERSION_SEP}{version}"
        v = self._variants.get(key)
        if v is None:
            raise ValueError(
                f"version {version!r} is not installed; have "
                f"{[k for k in self._variants if VERSION_SEP in k]}"
            )
        x, bucket = self._parity_slice()
        with self.on_stream():
            ref = self._run_variant(self._variants[DEFAULT_DTYPE], x).cpu().numpy()
            out = self._run_variant(v, x).cpu().numpy()
        return {
            "version": version,
            "rows": int(bucket),
            "max_abs_logit_diff": float(np.abs(out - ref).max()),
            "argmax_identical": bool((out.argmax(axis=1) == ref.argmax(axis=1)).all()),
        }

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
        prog = self._program_for(v.name, bucket)
        if not prog.built:
            self._build_late(prog)
        with self.on_stream():  # the read-back copy and its event too
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
                outs.append(result.wait()[: len(chunk)].copy())  # jaxlint: disable=JL009 -- serial direct-call path: each chunk is read inline by contract; the overlapped read lives in the batcher's completion worker
            finally:
                self._staging.release(staged, bucket)
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        if out.shape != (n, NUM_CLASSES):
            raise RuntimeError(f"forward returned {out.shape}, want {(n, NUM_CLASSES)}")
        return out
