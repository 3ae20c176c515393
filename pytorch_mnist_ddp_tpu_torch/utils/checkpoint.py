"""Checkpoints: load any trained-model artifact of the JAX package as a
torch state dict, and save the port's own.

Three formats, the same ones the JAX serving engine reads:

- a ``torch.save`` zip (``--save-model`` where torch is importable, or the
  original reference's ``mnist_cnn.pt``) — already in torch's layout, so
  it loads as it is, with the distributed-mode ``module.`` key prefix
  stripped;
- a model-only npz (``--save-model`` without torch): torch-style dotted
  keys, JAX tensor layouts;
- a ``--save-state`` training archive: ``params.<layer>.<leaf>`` keys in
  JAX layout beside optimizer state, of which only the params are kept.

The npz forms go through :func:`~.convert.torch_state_from_jax`.
BatchNorm checkpoints (``mnist_ddp.py --syncbn``) carry
``bnN.weight/bias/running_mean/running_var/num_batches_tracked`` in the
JAX package's naming; :func:`load_resume_state` reads them for training,
:func:`load_inference_state` for serving (at f32 and bf16; the int8
variant refuses them).

``--save-model`` writes through :func:`save_state_dict`: a ``torch.save``
file of the model's state dict (``module.`` prefixed in distributed mode,
as the reference's DDP wrapper saves it), which the JAX package's
``load_state_dict`` and :func:`load_inference_state` both read.

The ViT family saves its JAX-layout param tree as an npz of dotted keys
with a ``__format__`` tag (:func:`save_params_tree`, the JAX package's
``save_params_tree`` format), so either package reads the other's file.

``--save-state`` archives (:func:`save_train_state`,
:func:`load_train_state_full`) use the JAX package's on-disk format, so
an archive written by either package resumes in the other and no reader
asks which package wrote it: ``params.<layer>.<kernel|bias>`` in JAX
layout; the accumulators as ``opt_flat.square_avg``/``opt_flat.acc_delta``
(JAX's padded ``[rows, 128]`` ``ravel_pytree`` buffers) or per leaf as
``opt.square_avg.<layer>.<leaf>``/``opt.acc_delta.<layer>.<leaf>``;
``step`` (int32), ``epoch`` (epochs completed, int64), BatchNorm running
averages as ``batch_stats.<bnN>.mean|var`` and, in a mid-epoch archive,
integer ``meta.*`` extras.  In memory they are the port's:
torch layouts, ``named_parameters`` order (``utils/convert.py``).  The
ViT's archives (``vit_mnist.py --save-state``, :func:`save_vit_train_state`)
are the same format over the ViT's param tree, accumulators per leaf.
"""

from __future__ import annotations

import collections
import io
import json
import os
import tempfile
import zipfile
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from ..ops.adadelta import AdadeltaState
from ..ops.adadelta_flat import FlatAdadeltaState, is_flat_state
from .convert import (
    BN_LAYERS,
    LAYERS,
    has_bn,
    jax_flat_from_torch,
    jax_state_from_torch,
    jax_vit_tree_from_torch,
    torch_flat_from_jax,
    torch_state_from_jax,
    torch_vit_state_from_jax,
)

# Read once at import rather than per write: probing the umask sets it
# process-wide for a moment, and a file another thread created inside
# that window would be world-writable.
_UMASK = os.umask(0)
os.umask(_UMASK)


def _is_torch_zip(path: str) -> bool:
    """torch's zip holds a ``data.pkl`` member; npz does not."""
    try:
        with zipfile.ZipFile(path) as z:
            return any(n.split("/")[-1] == "data.pkl" for n in z.namelist())
    except zipfile.BadZipFile:
        return False


def _strip_prefix(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


# BatchNorm running averages: the JAX package's batch_stats leaves -> torch.
_STATS = {"mean": "running_mean", "var": "running_var"}


def _check_keys(keys, check_bn: Callable[[bool], None]) -> None:
    keys = set(keys)
    bn = has_bn(keys)
    check_bn(bn)
    layers = LAYERS + (tuple(BN_LAYERS) if bn else ())
    want = {f"{layer}.{leaf}" for layer in layers for leaf in ("weight", "bias")}
    missing = sorted(want - keys)
    if missing:
        raise ValueError(f"checkpoint is missing {missing}")


def _batches_tracked(state: Mapping[str, Any]) -> int:
    """The largest ``num_batches_tracked`` (a BN checkpoint's step count)."""
    return max((int(np.asarray(v).ravel()[0]) for k, v in state.items()
                if k.endswith(".num_batches_tracked")), default=0)


def _from_torch_file(path: str, check_bn) -> tuple[dict[str, torch.Tensor], int]:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state = {_strip_prefix(k): v for k, v in raw.items()}
    _check_keys(state, check_bn)
    layers = LAYERS + tuple(BN_LAYERS)
    return {
        k: state[k].detach().to(torch.float32).contiguous()
        for k in sorted(state)
        if k.split(".")[0] in layers and not k.endswith(".num_batches_tracked")
    }, _batches_tracked(state)


def _params_tree(flat: dict[str, np.ndarray], prefix: str, leaf_names) -> dict:
    """Flat dotted keys -> ``{layer: {"kernel", "bias"}}`` (JAX layout)."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        layer, leaf = _strip_prefix(key[len(prefix):]).split(".", 1)
        tree.setdefault(layer, {})[leaf_names.get(leaf, leaf)] = value
    return tree


def _torch_stats(stats: Mapping[str, Mapping[str, np.ndarray]]) -> dict[str, torch.Tensor]:
    """JAX ``batch_stats`` ``{bnN: {"mean", "var"}}`` -> ``bnN.running_mean``
    / ``bnN.running_var`` float32 CPU tensors."""
    return {f"{layer}.{_STATS[leaf]}": torch.tensor(np.asarray(v, np.float32))
            for layer in sorted(stats) for leaf, v in stats[layer].items()}


def jax_stats_from_torch(state: Mapping[str, torch.Tensor]) -> dict[str, dict[str, np.ndarray]]:
    """The inverse of :func:`_torch_stats`: a state dict's BN running
    averages as the JAX package's ``batch_stats`` tree (empty without BN)."""
    inv = {v: k for k, v in _STATS.items()}
    tree: dict[str, dict[str, np.ndarray]] = {}
    for key in sorted(state):
        layer, leaf = key.split(".", 1)
        if leaf in inv:
            tree.setdefault(layer, {})[inv[leaf]] = state[key].detach().to(
                "cpu", torch.float32).numpy()
    return {layer: dict(sorted(leaves.items())) for layer, leaves in tree.items()}


def _load_model_file(path: str, check_bn) -> tuple[dict[str, torch.Tensor], int]:
    """Any trained-model artifact -> float32 CPU state dict in torch
    layout (parameters, and BatchNorm running averages where saved) and
    its ``num_batches_tracked`` (0 without).  ``check_bn(has_bn)`` runs on
    the file's keys before any conversion."""
    if _is_torch_zip(path):
        return _from_torch_file(path, check_bn)
    try:
        with np.load(path) as archive:
            flat = {k: archive[k] for k in archive.files}
    except ValueError:
        # Not an npz at all: a legacy (pre-zip) torch.save pickle.
        return _from_torch_file(path, check_bn)
    if "step" in flat and any(k.startswith("params.") for k in flat):
        tree = _params_tree(flat, "params.", {})
        check_bn(has_bn(tree))
        return {**torch_state_from_jax(tree),
                **_torch_stats(_params_tree(flat, "batch_stats.", {}))}, 0
    # A model-only npz: torch names, JAX layouts.
    flat = {_strip_prefix(k): v for k, v in flat.items()}
    _check_keys(flat, check_bn)
    tree: dict[str, dict[str, np.ndarray]] = {}
    stats: dict[str, torch.Tensor] = {}
    for key, value in sorted(flat.items()):
        layer, leaf = key.split(".", 1)
        if leaf in _STATS.values():
            stats[key] = torch.tensor(np.asarray(value, np.float32))
        elif leaf in ("weight", "bias"):
            if leaf == "weight":
                leaf = "scale" if layer in BN_LAYERS else "kernel"
            tree.setdefault(layer, {})[leaf] = value
    return {**torch_state_from_jax(tree), **stats}, _batches_tracked(flat)


def load_inference_state(path: str) -> dict[str, torch.Tensor]:
    """Any supported checkpoint -> float32 CPU state dict in torch layout
    (``conv1.weight`` OIHW ... ``fc1.weight`` with NCHW-ordered columns),
    for serving.  A BatchNorm checkpoint (``--syncbn``, either package's)
    keeps its ``bnN.weight``/``bnN.bias`` and, where the file has them, its
    running averages; the JAX package's ``load_inference_variables``
    reads the same files."""
    return _load_model_file(path, lambda bn: None)[0]


def load_resume_state(path: str, syncbn: bool) -> tuple[dict[str, torch.Tensor], int]:
    """A ``--resume`` checkpoint for a model with (``syncbn``) or without
    BatchNorm: ``(state dict, step)``, the JAX trainer's
    ``_load_resume_variables``.  The step is the checkpoint's
    ``num_batches_tracked`` (0 without BN), so a resumed ``--syncbn`` run
    keeps torch's cumulative batch counter; BN running averages missing
    from the file start from their init.  A checkpoint whose BatchNorm
    does not match ``syncbn`` raises with the JAX trainer's text."""

    def check(bn: bool) -> None:
        if syncbn and not bn:
            raise ValueError(
                f"--resume checkpoint {path!r} has no BatchNorm parameters; "
                "drop --syncbn or resume a checkpoint saved by a --syncbn run"
            )
        if bn and not syncbn:
            raise ValueError(
                f"--resume checkpoint {path!r} carries BatchNorm parameters; "
                "add --syncbn (a mnist_ddp.py flag) to resume it"
            )

    state, step = _load_model_file(path, check)
    for layer, features in BN_LAYERS.items() if syncbn else ():
        state.setdefault(f"{layer}.running_mean", torch.zeros(features))
        state.setdefault(f"{layer}.running_var", torch.ones(features))
    return state, step


def model_state_dict(
    model: torch.nn.Module | Mapping[str, torch.Tensor], ddp_prefix: bool = False,
    num_batches: int | None = None,
) -> dict[str, torch.Tensor]:
    """The model's state (a module, or its state dict: ``--tp``'s gathered
    one) as CPU float32 tensors under the reference's keys
    (``conv1.weight`` ... ``fc2.bias``), torch layout.  ``ddp_prefix``
    prefixes ``module.`` (the reference's distributed-mode save);
    ``num_batches`` adds each BatchNorm's int64 ``num_batches_tracked``
    after its running averages, as ``torch.nn.BatchNorm2d`` keeps it."""
    out: dict[str, torch.Tensor] = collections.OrderedDict()
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    for k, v in state.items():
        out[k] = v.detach().to("cpu", torch.float32).contiguous()
        if num_batches is not None and k.endswith(".running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(
                num_batches, dtype=torch.int64)
    if ddp_prefix:
        out = collections.OrderedDict(("module." + k, v) for k, v in out.items())
    return out


def _atomic_write(path: str, write: Callable) -> None:
    """``write(f)`` into a private temporary file in ``path``'s directory,
    flushed to disk, then renamed over ``path``: a reader sees the old
    file or the whole new one, never a torn one."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o666 & ~_UMASK)  # mkstemp made it 0600
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_state_dict(state: dict[str, torch.Tensor], path: str) -> None:
    """``torch.save`` to ``path`` atomically."""
    _atomic_write(path, lambda f: torch.save(state, f))


def _atomic_npz_write(flat: Mapping[str, np.ndarray], path: str) -> None:
    buf = io.BytesIO()
    np.savez(buf, **flat)
    _atomic_write(path, lambda f: f.write(buf.getvalue()))


# Params-tree archive format.  2 = head-major qkv (``[t, heads, 3,
# head_dim]``); a format-1 archive's qkv kernels have the same shape with
# every head's q/k/v scrambled, so only the tag tells them apart.
PARAMS_TREE_FORMAT = 2


# The model registry's manifest (serving/registry.py): its only durable
# state, a JSON document in the registry directory naming every (model,
# version) entry and the default aliases.  Written atomically like every
# checkpoint, so a reader sees an absent or a complete manifest, never a
# torn one.  The JAX package's utils/checkpoint.py writes the same bytes.
REGISTRY_MANIFEST = "registry.json"
REGISTRY_FORMAT = 1


def registry_manifest_path(directory: str) -> str:
    return os.path.join(directory, REGISTRY_MANIFEST)


def save_registry_manifest(manifest: Mapping[str, Any], directory: str) -> str:
    """Atomically publish the registry manifest into ``directory``: the
    format tag stamped, sorted keys and a trailing newline, so identical
    state gives identical bytes."""
    manifest = dict(manifest)
    manifest["format"] = REGISTRY_FORMAT
    path = registry_manifest_path(directory)
    payload = (json.dumps(manifest, indent=2, sort_keys=True) + "\n").encode()
    _atomic_write(path, lambda f: f.write(payload))
    return path


def load_registry_manifest(directory: str) -> dict[str, Any]:
    """Read the registry manifest back; ``FileNotFoundError`` when the
    directory holds none (a fresh registry), ``ValueError`` on one this
    code cannot interpret (a future format is refused, not half-read)."""
    path = registry_manifest_path(directory)
    with open(path, "rb") as f:
        try:
            manifest = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path!r} is not valid JSON ({e}); the registry writes "
                "manifests atomically, so this file was likely produced "
                "by a non-atomic writer or damaged in transit"
            ) from e
    if not isinstance(manifest, dict):
        raise ValueError(f"{path!r} must hold a JSON object manifest")
    fmt = int(manifest.get("format", 0))
    if fmt != REGISTRY_FORMAT:
        raise ValueError(
            f"{path!r} is a format-{fmt} registry manifest; this build "
            f"reads format {REGISTRY_FORMAT} — upgrade the reader or "
            "re-publish the registry"
        )
    return manifest


def _flatten_raw(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> flat dotted keys, no leaf renamed."""
    out: dict[str, np.ndarray] = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten_raw(value, prefix + name + "."))
        else:
            out[prefix + name] = np.asarray(value)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *parts, leaf = key.split(".")
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def save_params_tree(tree: Mapping[str, Any], path: str) -> None:
    """A nested param tree (JAX layout) as an npz of dotted keys plus
    ``__format__``, written atomically; :func:`load_params_tree` and the
    JAX package's ``load_params_tree`` read it."""
    flat = _flatten_raw(tree)
    flat["__format__"] = np.int64(PARAMS_TREE_FORMAT)
    _atomic_npz_write(flat, path)


def load_params_tree(path: str) -> dict[str, Any]:
    """Inverse of :func:`save_params_tree`.  Refuses an archive older than
    format 2 that holds qkv weights (same shapes, scrambled heads)."""
    try:
        with np.load(path) as archive:
            flat = {k: archive[k] for k in archive.files}
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise ValueError(f"{path!r} is not an npz params archive: {e}") from e
    fmt = int(flat.pop("__format__", 1))
    if fmt < 2 and any(key.split(".")[-2:-1] == ["qkv"] for key in flat):
        raise ValueError(
            f"{path!r} is a format-{fmt} archive with qkv weights saved in "
            "the pre-head-major layout; it cannot be loaded (same shapes, "
            "scrambled heads) — re-save it from the run that produced it"
        )
    return _unflatten(flat)


class CorruptCheckpointError(ValueError):
    """A checkpoint file that exists but does not parse (truncated or torn).

    Apart from plain ValueError so that :func:`load_latest_train_state`
    falls back to the previous rotation for a damaged file, and never for
    the wrong kind of file (a model-only checkpoint given to
    ``--resume-state``), which must reach the operator."""


# Suffix of the previous rotation of a mid-epoch archive: the writer puts
# the new archive in a temporary file, renames <path> to <path> +
# PREV_SUFFIX, then renames the temporary file onto <path>, so a kill at
# any point leaves one whole archive where load_latest_train_state looks.
PREV_SUFFIX = ".prev"


class TrainArchive(NamedTuple):
    """A ``--save-state`` archive in the port's layouts, CPU tensors:
    parameters keyed ``conv1.weight`` ..., the Adadelta accumulators as
    saved (flat or per parameter), the optimizer-step counter, and the
    BatchNorm running averages (``bn1.running_mean`` ...; empty without
    BN)."""

    params: dict[str, torch.Tensor]
    opt: AdadeltaState | FlatAdadeltaState
    step: int
    batch_stats: dict[str, torch.Tensor] = {}


def save_train_state(
    params: Mapping[str, torch.Tensor],
    opt: AdadeltaState | FlatAdadeltaState,
    step: int,
    path: str,
    epoch: int = 0,
    extras: Mapping[str, int] | None = None,
    batch_stats: Mapping[str, torch.Tensor] | None = None,
) -> None:
    """Write the whole training state (parameters, both accumulators in
    their layout, the step counter, ``epoch`` epochs completed, a
    ``--syncbn`` model's running averages from ``batch_stats``) as one npz
    archive in the JAX package's format, atomically.  ``extras`` (a
    mid-epoch archive's position) are stored as int64 ``meta.<key>``; a
    final archive has none.  Restoring it continues training bit for bit:
    the accumulators travel, the schedule and shuffle follow ``epoch``,
    and the dropout seeds follow ``step``."""
    flat = _flatten_raw(jax_state_from_torch(params), "params.")
    if is_flat_state(opt):
        bn = has_bn(params)
        flat["opt_flat.square_avg"] = jax_flat_from_torch(opt.square_avg, bn)
        flat["opt_flat.acc_delta"] = jax_flat_from_torch(opt.acc_delta, bn)
    else:
        for name in ("square_avg", "acc_delta"):
            flat.update(_flatten_raw(jax_state_from_torch(getattr(opt, name)),
                                     f"opt.{name}."))
    flat["step"] = np.asarray(step, np.int32)
    flat["epoch"] = np.asarray(int(epoch))
    flat.update(_flatten_raw(jax_stats_from_torch(batch_stats or {}), "batch_stats."))
    for key, value in (extras or {}).items():
        flat[f"meta.{key}"] = np.asarray(int(value), np.int64)
    _atomic_npz_write(flat, path)


def save_vit_train_state(
    params: Mapping[str, torch.Tensor],
    opt: AdadeltaState,
    step: int,
    path: str,
    epoch: int = 0,
) -> None:
    """:func:`save_train_state` for the ViT: its param tree and per-leaf
    accumulator trees in the JAX package's layout
    (:func:`~.convert.jax_vit_tree_from_torch`), ``step`` and ``epoch``
    epochs completed, the file the JAX ViT CLI's ``--save-state`` writes."""
    flat = _flatten_raw(jax_vit_tree_from_torch(params), "params.")
    for name in ("square_avg", "acc_delta"):
        flat.update(_flatten_raw(jax_vit_tree_from_torch(getattr(opt, name)), f"opt.{name}."))
    flat["step"] = np.asarray(step, np.int32)
    flat["epoch"] = np.asarray(int(epoch))
    _atomic_npz_write(flat, path)


def _prefixed(flat: Mapping[str, np.ndarray], prefix: str) -> dict[str, Any]:
    return _unflatten({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})


def _read_train_archive(path: str) -> dict[str, np.ndarray]:
    """A ``--save-state`` archive's arrays by key.  A missing file raises
    FileNotFoundError, a torn one :class:`CorruptCheckpointError`, any other
    file a ValueError (a model-only checkpoint's naming ``--resume``)."""
    try:
        with np.load(path) as archive:
            flat = {k: archive[k] for k in archive.files}
    except FileNotFoundError:
        raise
    except zipfile.BadZipFile as e:
        raise CorruptCheckpointError(
            f"{path!r} is corrupt or truncated ({e}); a checkpoint this "
            "package wrote cannot be torn (mkstemp + fsync + atomic replace), "
            "so this file was likely produced by a killed non-atomic writer "
            "or damaged in transit — re-save it from the run that produced it"
        ) from e
    except (OSError, ValueError) as e:
        raise ValueError(f"{path!r} is not a --save-state archive (npz): {e}") from e
    if "step" not in flat or not any(k.startswith("params.") for k in flat):
        raise ValueError(
            f"{path!r} is not a --save-state archive (missing 'step'/"
            "'params.*' entries) — model-only checkpoints (--save-model) "
            "resume via --resume instead"
        )
    return flat


def load_vit_train_state(path: str) -> tuple[TrainArchive, int]:
    """A ``--save-state`` archive of either package read as a ViT's:
    ``(TrainArchive, epochs completed)`` with the params and per-leaf
    accumulators as ``ViT`` state-dict trees (CPU tensors; empty trees
    where the archive holds no per-leaf accumulators).  The caller checks
    the tree against its model: another model's archive reads without
    error and fails there.  A file that is no training archive raises as
    :func:`load_train_state_full` does."""
    flat = _read_train_archive(path)
    opt = AdadeltaState(*(torch_vit_state_from_jax(_prefixed(flat, f"opt.{name}."))
                          for name in ("square_avg", "acc_delta")))
    state = TrainArchive(params=torch_vit_state_from_jax(_prefixed(flat, "params.")), opt=opt,
                         step=int(flat["step"]))
    return state, int(flat.get("epoch", 0))


def load_train_state_full(
    path: str, syncbn: bool = False
) -> tuple[TrainArchive, int, dict[str, int]]:
    """The inverse of :func:`save_train_state`, for an archive written by
    either package: ``(TrainArchive, epochs completed, extras)``, the
    extras a ``{key: int}`` dict (empty for a final archive).  A missing
    file raises FileNotFoundError, a torn one
    :class:`CorruptCheckpointError`, a model-only checkpoint a ValueError
    naming ``--resume``, and an archive whose BatchNorm state does not
    match ``syncbn`` the JAX trainer's ``--syncbn`` message."""
    flat = _read_train_archive(path)
    saved_bn = any(k.startswith("batch_stats.") for k in flat)
    if saved_bn != syncbn:
        raise ValueError(
            f"--resume-state {path!r} was saved "
            f"{'with' if saved_bn else 'without'} BatchNorm state; "
            + ("add" if saved_bn else "drop") + " --syncbn to match"
        )
    params = torch_state_from_jax(_params_tree(flat, "params.", {}))
    opt: AdadeltaState | FlatAdadeltaState
    if "opt_flat.square_avg" in flat:
        opt = FlatAdadeltaState(
            square_avg=torch_flat_from_jax(flat["opt_flat.square_avg"], syncbn),
            acc_delta=torch_flat_from_jax(flat["opt_flat.acc_delta"], syncbn),
        )
    else:
        opt = AdadeltaState(*(
            torch_state_from_jax(_params_tree(flat, f"opt.{name}.", {}))
            for name in ("square_avg", "acc_delta")
        ))
    extras = {k[len("meta."):]: int(np.asarray(v).ravel()[0])
              for k, v in flat.items() if k.startswith("meta.")}
    state = TrainArchive(params=params, opt=opt, step=int(flat["step"]),
                         batch_stats=_torch_stats(_params_tree(flat, "batch_stats.", {})))
    return state, int(flat.get("epoch", 0)), extras


def load_latest_train_state(
    path: str, syncbn: bool = False
) -> tuple[TrainArchive, int, dict[str, int], str]:
    """:func:`load_train_state_full` of ``path`` or, when ``path`` is
    missing or torn, of ``path + PREV_SUFFIX`` (a writer killed between its
    two renames leaves only that).  Returns the three results and the path
    read.  Any other error surfaces: an older rotation must never hide an
    operator's mistake."""
    try:
        return (*load_train_state_full(path, syncbn), path)
    except (FileNotFoundError, CorruptCheckpointError) as main_err:
        prev = path + PREV_SUFFIX
        if not os.path.exists(prev):
            raise
        try:
            return (*load_train_state_full(prev, syncbn), prev)
        except Exception:
            raise main_err
