"""A gated store of the built kernel libraries: a warm start loads what a
cold one built, with no ``nvcc`` run (the JAX package's ``compile/aot.py``).

The JAX package stores serialized XLA executables.  The port compiles
nothing at run time but its kernel libraries: each ``csrc/<name>.cu`` is
built by ``nvcc`` into a shared library and loaded with ``ctypes``
(``ops/_build.py``), and those builds are its startup cost on the card.
So one entry of this store is ONE KERNEL LIBRARY, not one program: the
JAX store's ``load_or_compile(name, config, build)`` becomes
:meth:`ExecutableStore.load_or_build` ``(name, build, load)``.  Every
library the port loads comes through such a store: the one
``--aot-cache`` names, with outcomes on its registry, or else the build
directory's (``ops/_build.py``; ``--compile-cache-dir``/``--cache-dir``),
which records none.

Keying: the key must change whenever the library, or what loading it
depends on, could.

- the **library's name** (one entry a ``csrc`` source);
- a **source digest** over every ``.py`` file of the port package and
  every file under ``csrc/``: any commit that touches a kernel, its
  wrapper or its launch plan invalidates every entry;
- ``ops/_build.NVCC_FLAGS``;
- the environment a load depends on: ``torch.__version__``,
  ``torch.version.cuda``, the CUDA driver's version, the card's name and
  compute capability, and the number of cards.

The toolkit that built a library (``nvcc --version``) is recorded in its
header at build time, not keyed on: asking it means a child process, and
a hit must need no compiler at all, so that a host without ``nvcc``
loads what another host built (the trainer-to-server handoff).

An entry is three files: the library (``<name>-<key>-<sha>.so``, named by
its own content hash), ptxas's report beside it (``.log``), and a header
(``<name>-<key>.json``) holding the key material, the toolkit's version,
the library's file name and its sha256.  A load checks the header against this process's key
material and the library's bytes against the sha256 BEFORE ``ctypes``
opens it: loading a shared library runs its initializers, so a gate
after ``dlopen`` would come too late.  Any mismatch, a torn or missing
file, or an injected ``aot_load`` fault becomes a fresh build under a
new file name (a fresh build's bytes differ, and so does its name, so
``dlopen`` never hands back a stale mapping of the old path), whose
header then replaces the entry.  Outcomes land on
``aot_executables_total{outcome=hit|miss|fallback}`` and as
``aot_executable`` JSONL events (``fn`` = the library), under the JAX
package's names.  The store is an optimization, never a correctness
surface, but there is no fallback from a failed BUILD: it raises.

A process records one outcome a library, at its first load:
``ops/_build.py`` keeps each loaded library for the life of the process,
and later users (another engine, a pool replica, the warmup after the
trainer's startup) reuse it and record nothing.

Concurrency: readers and writers of one directory in several processes
are safe (pool replicas share one store in a process; launcher ranks and
fleet backends share its directory).  A writer builds into a private
``mkstemp`` file and renames it into place, then publishes the header
the same way, so a reader only ever sees absent or complete files.  Two
processes that miss together both run ``nvcc`` (the per-source locks of
``ops/_build.py`` work within one process); each loads the library it
built, and the last header written wins with an equal library.

Trust model: the gate checks that an entry is the one this environment
would build, not who wrote it.  Anyone who can write the directory can
write a library and a header that match, and loading a library runs its
code.  Point ``--aot-cache`` only at a directory you own (the store
creates a missing one mode 0700); never at a shared world-writable
location on a multi-user host.  The build directory is a store under
the same rule.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

_FORMAT = 1
_PKG_ROOT = Path(__file__).resolve().parents[1]


def _fault_point(site: str) -> None:
    """Dormant chaos hook (``serving/faults.py``).

    Resolved through ``sys.modules`` so this module never imports the
    serving package: if nobody imported the faults module, nobody
    installed an injector, and the hook is one dict lookup."""
    faults = sys.modules.get("pytorch_mnist_ddp_tpu_torch.serving.faults")
    if faults is not None:
        faults.fault_point(site)


@functools.cache
def source_digest() -> str:
    """SHA-256 over every ``.py`` file of the port package and every file
    under ``csrc/`` (sorted relative paths and contents).  Cached per
    process: the tree does not change under a running program."""
    paths = [p for p in _PKG_ROOT.rglob("*")
             if p.is_file() and (p.suffix == ".py" or "csrc" in p.relative_to(_PKG_ROOT).parts)]
    digest = hashlib.sha256()
    for path in sorted(paths):
        digest.update(str(path.relative_to(_PKG_ROOT)).encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()


@functools.cache
def _nvcc_version() -> str:
    """The toolkit that builds this process's libraries; asked on the
    build path only (a build has just proved ``nvcc`` is there)."""
    from ..ops._build import nvcc_path

    return subprocess.run([nvcc_path(), "--version"], check=True, capture_output=True,
                          text=True).stdout.strip()


def _driver_version() -> int:
    """The CUDA driver's version, as ``cuDriverGetVersion`` gives it (e.g.
    12040); the driver library is already loaded on the card."""
    import ctypes

    version = ctypes.c_int()
    rc = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version))
    if rc != 0:
        raise RuntimeError(f"cuDriverGetVersion failed: CUresult {rc}")
    return version.value


def _environment() -> dict:
    """What loading a library depends on beyond its source and flags: the
    torch build, the driver and the cards.  No child process: a hit needs
    no ``nvcc``.  Only asked where a library is loaded, that is on the
    card."""
    import torch

    return {
        "torch_version": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "driver": _driver_version(),
        "device_kind": torch.cuda.get_device_name(0),
        "capability": ".".join(map(str, torch.cuda.get_device_capability(0))),
        "num_devices": torch.cuda.device_count(),
    }


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class ExecutableStore:
    """Directory of built kernel libraries, one entry a library.

    ``load_or_build(name, build, load)`` is the whole API: ``build(path)``
    compiles the library into ``path`` and returns nvcc's report,
    ``load(path)`` loads it (``ctypes.CDLL``); the store either loads a
    prior run's library for the same key ("hit") or builds fresh and
    keeps it ("miss"; "fallback" when an entry existed but failed its
    gate).
    """

    MAX_ENTRIES = 8  # newest headers kept; key churn (source edits) orphans the rest
    TMP_GRACE_S = 600.0  # crashed writers' .tmp files and orphans older than this go

    def __init__(self, directory: str, registry=None, sink=None):
        self.directory = str(directory)
        self._registry = registry
        self._sink = sink
        # 0700 on creation: an entry is code this process will run (see
        # the module's trust model).  A directory that exists keeps its
        # mode: the operator owns that decision.
        os.makedirs(self.directory, mode=0o700, exist_ok=True)
        # Entry files honor the process umask as a plain open() would
        # (mkstemp alone gives 0600, which breaks a cache directory an
        # operator deliberately shares).  Probed once here, while
        # construction is single-threaded: os.umask's read-and-restore is
        # process-global and would race concurrent warmups.
        umask = os.umask(0)
        os.umask(umask)
        self._entry_mode = 0o666 & ~umask

    # -- keying ---------------------------------------------------------------

    def material(self, name: str) -> dict:
        """Everything the key digests for library ``name``."""
        from ..ops._build import NVCC_FLAGS

        return {"format": _FORMAT, "library": name, "source_digest": source_digest(),
                "nvcc_flags": list(NVCC_FLAGS), **_environment()}

    def key_for(self, name: str) -> str:
        """Deterministic key: library + source digest + flags + environment."""
        blob = json.dumps(self.material(name), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def header_path(self, name: str, key: str | None = None) -> str:
        return os.path.join(self.directory, f"{name}-{key or self.key_for(name)}.json")

    def _record(self, name: str, outcome: str, seconds: float) -> None:
        if self._registry is not None:
            self._registry.counter(
                "aot_executables_total",
                help="kernel-library store outcomes per load_or_build",
                outcome=outcome,
            ).inc()
        if self._sink is not None:
            self._sink.emit("aot_executable", fn=name, outcome=outcome, seconds=seconds)

    # -- the API --------------------------------------------------------------

    def load_or_build(self, name: str, build: Callable[[str], str],
                      load: Callable[[str], Any]) -> tuple[Any, str]:
        """Return ``(library, outcome)``; outcome is hit, miss or fallback.

        A "hit" ran no build in this process and loaded the very file a
        cold build wrote (same sha256).  Any problem with the stored entry
        (missing, wrong header, bytes that are not the header's, an
        ``aot_load`` fault) silently becomes a fresh build whose library
        replaces the entry.  A build that fails raises."""
        t0 = time.perf_counter()
        material = self.material(name)
        key = hashlib.sha256(json.dumps(material, sort_keys=True).encode()).hexdigest()
        header = self.header_path(name, key)
        outcome = "miss"
        if os.path.exists(header):
            try:
                lib = load(self._gate(header, material, key))
            except Exception:
                # A changed environment, a torn write, a tampered header or
                # library, an injected fault: all one answer, build afresh.
                outcome = "fallback"
            else:
                self._record(name, "hit", time.perf_counter() - t0)
                return lib, "hit"
        path = self._save(name, key, material, build)
        self._prune()
        lib = load(path)
        self._record(name, outcome, time.perf_counter() - t0)
        return lib, outcome

    def entry(self, name: str) -> dict | None:
        """The header of ``name``'s current entry, or None."""
        try:
            with open(self.header_path(name)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    # -- disk format ----------------------------------------------------------

    def _gate(self, header: str, material: dict, key: str) -> str:
        """The library's path if the entry is this key's and its bytes are
        the header's; raises otherwise.  Nothing of the entry runs here."""
        # An injected aot_load failure is indistinguishable from a torn or
        # tampered entry: load_or_build's fallback (a fresh build, the
        # entry rewritten) is exactly what a chaos schedule exercises.
        _fault_point("aot_load")
        with open(header) as f:
            entry = json.load(f)
        for field, want in {**material, "key": key}.items():
            if entry.get(field) != want:
                raise ValueError(
                    f"store entry {os.path.basename(header)} gate mismatch on "
                    f"{field!r}: stored {entry.get(field)!r}, need {want!r}"
                )
        path = os.path.join(self.directory, os.path.basename(entry["file"]))
        got = _sha256(path)
        if got != entry["sha256"]:
            raise ValueError(f"{os.path.basename(path)} is not the library its header "
                             f"names: sha256 {got}, header {entry['sha256']}")
        return path

    def _write(self, name: str, suffix: str, fill: Callable[[str], Any]) -> tuple[str, Any]:
        """``(path, fill(path))`` for a private temporary file in the
        directory, given the umask's mode; removed if filling raises."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f"{name}.", suffix=suffix)
        os.close(fd)
        try:
            out = fill(tmp)
            os.chmod(tmp, self._entry_mode)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return tmp, out

    def _save(self, name: str, key: str, material: dict,
              build: Callable[[str], str]) -> str:
        """Build ``name`` into the directory and publish its entry; returns
        the library's final path.  Concurrent writers each build into a
        private file; ``os.replace`` is atomic, so the last header written
        wins and every header names a complete library."""
        tmp_lib, report = self._write(name, ".so.tmp", build)
        sha = _sha256(tmp_lib)
        stem = f"{name}-{key[:16]}-{sha[:16]}"
        lib_path = os.path.join(self.directory, stem + ".so")
        os.replace(tmp_lib, lib_path)
        tmp_log, _ = self._write(name, ".log.tmp",
                                 lambda p: Path(p).write_text(report or ""))
        os.replace(tmp_log, os.path.join(self.directory, stem + ".log"))
        entry = {**material, "key": key, "file": stem + ".so", "sha256": sha,
                 "log": stem + ".log", "bytes": os.path.getsize(lib_path),
                 "nvcc": _nvcc_version()}
        tmp_header, _ = self._write(
            name, ".json.tmp", lambda p: Path(p).write_text(json.dumps(entry, sort_keys=True)))
        os.replace(tmp_header, self.header_path(name, key))
        return lib_path

    def _prune(self) -> None:
        """Keep the newest :attr:`MAX_ENTRIES` headers.  Key churn (every
        source edit changes the digest) orphans the previous entries;
        without a bound, an iterating developer's directory grows a
        library per edit, forever.  A library or report no kept header
        names goes once it is older than :attr:`TMP_GRACE_S`, as do the
        temporary files of a writer that died: the grace spares a live
        writer between its library's rename and its header's."""
        now = time.time()
        headers, files = [], []
        for fname in os.listdir(self.directory):
            full = os.path.join(self.directory, fname)
            try:
                mtime = os.path.getmtime(full)
            except OSError:
                continue
            if fname.endswith(".json"):
                headers.append((mtime, full))
            elif fname.endswith((".so", ".log", ".tmp")):
                files.append((mtime, full))
        headers.sort(reverse=True)
        kept = set()
        for i, (_, full) in enumerate(headers):
            if i >= self.MAX_ENTRIES:
                _remove(full)
                continue
            try:
                with open(full) as f:
                    entry = json.load(f)
                kept.update((entry["file"], entry["log"]))
            except (OSError, ValueError, KeyError):
                continue
        for mtime, full in files:
            if os.path.basename(full) not in kept and now - mtime > self.TMP_GRACE_S:
                _remove(full)


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
