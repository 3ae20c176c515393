"""Multi-tenant model registry: named (model, version) serving entries
(the JAX package's ``serving/registry.py``; a registry directory written
by either package loads in the other).

A directory holding checkpoints plus ONE durable manifest
(``registry.json``, written atomically — utils/checkpoint.py
``save_registry_manifest``) that names every ``(model, version)`` entry:

- the checkpoint path (registry-relative when inside the directory, so
  the whole directory relocates);
- the **weights digest** (serving/engine.py ``weights_digest``, equal to
  the JAX package's for the same weights) recorded at publish time and
  re-verified at load time, so a checkpoint file swapped or corrupted
  behind the manifest's back is REFUSED, never silently served;
- the **model family** (``net``);
- the **parity record** — the version's gate verdicts, where validated.

Routing state lives in the same manifest: ``default_model`` plus each
model's ``default_version`` are the aliases a ``/predict`` with absent
``model``/``version`` fields resolves through.

Serving code reaches checkpoints only through :meth:`ModelRegistry.resolve`
/ :meth:`ModelRegistry.load` and publishes only through
:meth:`ModelRegistry.publish`.  The live-traffic half (routing, canary,
swap, rollback) is :class:`~.rollout.RolloutController`.
"""

from __future__ import annotations

import os
import threading

import torch

from ..utils.checkpoint import (
    load_inference_state,
    load_registry_manifest,
    registry_manifest_path,
    save_registry_manifest,
)
from .engine import weights_digest

# The family every checkpoint this repo trains today belongs to
# (models/net.py).  Recorded per entry for forward-compatibility; the
# engine refuses families it cannot serve at load time.
DEFAULT_FAMILY = "net"


class RegistryError(ValueError):
    """A registry operation that cannot proceed — unknown model/version,
    digest mismatch, malformed manifest.  Subclasses ValueError so the
    server's 400 mapping handles unknown-name resolution unchanged."""


class ModelVersion:
    """One immutable (model, version) manifest entry."""

    __slots__ = ("model", "version", "checkpoint", "digest", "family",
                 "parity")

    def __init__(self, model, version, checkpoint, digest, family, parity):
        self.model = model
        self.version = version
        self.checkpoint = checkpoint  # registry-relative or absolute
        self.digest = digest          # weights_digest at publish time
        self.family = family
        self.parity = parity          # per-dtype gate record or None

    def path(self, directory: str) -> str:
        return (
            self.checkpoint
            if os.path.isabs(self.checkpoint)
            else os.path.join(directory, self.checkpoint)
        )

    def describe(self) -> dict:
        return {
            "model": self.model,
            "version": self.version,
            "checkpoint": self.checkpoint,
            "digest": self.digest,
            "family": self.family,
            "parity": self.parity,
        }


class ModelRegistry:
    """The durable (model, version) -> checkpoint catalog over one
    directory.

    Construction loads the manifest when one exists; a directory without
    one is a valid EMPTY registry (the first :meth:`publish` creates
    it).  All mutation goes through publish/set_default, each of which
    rewrites the whole manifest atomically — a reader (another backend
    mid-rolling-swap, an operator's inspection) only ever sees a
    complete manifest.
    """

    def __init__(self, directory: str, sink=None):
        self.directory = os.path.abspath(directory)
        self._sink = sink
        self._lock = threading.Lock()
        self._default_model: str | None = None
        self._models: dict[str, dict] = {}
        if os.path.exists(registry_manifest_path(self.directory)):
            self._read_manifest()

    # -- manifest I/O ---------------------------------------------------------

    def _read_manifest(self) -> None:
        manifest = load_registry_manifest(self.directory)
        models: dict[str, dict] = {}
        for model, spec in (manifest.get("models") or {}).items():
            versions = {}
            for version, entry in (spec.get("versions") or {}).items():
                versions[version] = ModelVersion(
                    model=model,
                    version=version,
                    checkpoint=entry["checkpoint"],
                    digest=entry.get("digest", ""),
                    family=entry.get("family", DEFAULT_FAMILY),
                    parity=entry.get("parity"),
                )
            models[model] = {
                "default_version": spec.get("default_version"),
                "versions": versions,
            }
        self._models = models
        self._default_model = manifest.get("default_model")

    def _manifest_dict(self) -> dict:
        return {
            "default_model": self._default_model,
            "models": {
                model: {
                    "default_version": spec["default_version"],
                    "versions": {
                        v: {
                            "checkpoint": e.checkpoint,
                            "digest": e.digest,
                            "family": e.family,
                            "parity": e.parity,
                        }
                        for v, e in spec["versions"].items()
                    },
                }
                for model, spec in self._models.items()
            },
        }

    def _write_manifest(self) -> None:
        save_registry_manifest(self._manifest_dict(), self.directory)

    # -- reads ----------------------------------------------------------------

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def versions(self, model: str) -> list[str]:
        with self._lock:
            spec = self._models.get(model)
            if spec is None:
                raise RegistryError(
                    f"unknown model {model!r}; registered: "
                    f"{sorted(self._models)}"
                )
            return sorted(spec["versions"])

    def resolve(
        self, model: str | None = None, version: str | None = None
    ) -> ModelVersion:
        """THE routing lookup: absent
        ``model`` resolves to the default model, absent ``version`` to
        that model's default version — so a request carrying neither
        field serves exactly the pre-registry checkpoint.  Unknown
        names raise :class:`RegistryError` (-> HTTP 400)."""
        with self._lock:
            name = model if model is not None else self._default_model
            if name is None or name not in self._models:
                raise RegistryError(
                    f"unknown model {name!r}; registered: "
                    f"{sorted(self._models)}"
                )
            spec = self._models[name]
            v = version if version is not None else spec["default_version"]
            if v is None or v not in spec["versions"]:
                raise RegistryError(
                    f"unknown version {v!r} of model {name!r}; registered: "
                    f"{sorted(spec['versions'])}"
                )
            return spec["versions"][v]

    def describe(self) -> dict:
        """The admin/status surface: default aliases + every entry."""
        with self._lock:
            return {
                "directory": self.directory,
                "default_model": self._default_model,
                "models": {
                    model: {
                        "default_version": spec["default_version"],
                        "versions": {
                            v: e.describe()
                            for v, e in spec["versions"].items()
                        },
                    }
                    for model, spec in self._models.items()
                },
            }

    # -- weights --------------------------------------------------------------

    def load(self, entry: ModelVersion) -> dict[str, torch.Tensor]:
        """Entry -> the port's state dict, digest-verified: the digest
        recorded at publish time must match what the file hashes to NOW.
        A mismatch means the checkpoint changed behind the manifest's back
        (partial copy, overwrite, corruption) and is refused."""
        path = entry.path(self.directory)
        state = load_inference_state(path)
        if entry.digest:
            actual = weights_digest(state)
            if actual != entry.digest:
                raise RegistryError(
                    f"checkpoint {path!r} hashes to {actual} but the "
                    f"manifest records {entry.digest} for "
                    f"{entry.model}@{entry.version}; the file changed "
                    "behind the manifest — re-publish the version"
                )
        return state

    # -- mutation -------------------------------------------------------------

    def publish(
        self,
        model: str,
        version: str,
        checkpoint: str,
        *,
        family: str = DEFAULT_FAMILY,
        parity: dict | None = None,
        make_default: bool = False,
    ) -> ModelVersion:
        """Register (or re-register) a version and atomically publish
        the manifest — the only write path for serving checkpoints.

        ``checkpoint`` may live anywhere; a path inside the registry
        directory is recorded relative so the directory relocates as a
        unit.  The weights digest is computed HERE, from the actual
        file, so the manifest can never claim a digest the bytes don't
        back.  ``make_default`` (or being the first model/version)
        updates the routing aliases in the same atomic write."""
        if not model or not version:
            raise RegistryError("model and version must be non-empty")
        # "@" is the engine's dtype<->version variant-key separator
        # (engine.VERSION_SEP); a version containing it would mint
        # ambiguous canary keys.
        if "@" in version:
            raise RegistryError(
                f"version {version!r} must not contain '@'"
            )
        path = os.path.abspath(checkpoint)
        if not os.path.exists(path):
            raise RegistryError(f"checkpoint {path!r} does not exist")
        digest = weights_digest(load_inference_state(path))
        rel = os.path.relpath(path, self.directory)
        stored = path if rel.startswith("..") else rel
        entry = ModelVersion(
            model=model, version=version, checkpoint=stored,
            digest=digest, family=family, parity=parity,
        )
        with self._lock:
            spec = self._models.setdefault(
                model, {"default_version": None, "versions": {}}
            )
            spec["versions"][version] = entry
            if make_default or spec["default_version"] is None:
                spec["default_version"] = version
            if make_default or self._default_model is None:
                self._default_model = model
            self._write_manifest()
        if self._sink:
            self._sink.emit(
                "model_publish", model=model, version=version,
                digest=digest, default=bool(
                    make_default or spec["default_version"] == version
                ),
            )
        return entry

    def set_default(self, model: str, version: str) -> ModelVersion:
        """Point the routing aliases at (model, version) — the durable
        half of a swap promotion, in one atomic manifest write."""
        with self._lock:
            spec = self._models.get(model)
            if spec is None or version not in spec["versions"]:
                raise RegistryError(
                    f"cannot default to unregistered {model}@{version}"
                )
            spec["default_version"] = version
            self._default_model = model
            self._write_manifest()
            return spec["versions"][version]
