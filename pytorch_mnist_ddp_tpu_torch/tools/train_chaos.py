#!/usr/bin/env python
"""Trainer chaos harness: kill -> resume -> verify bit-exact, with real OS
processes (the JAX package's ``tools/train_chaos.py`` over the port's CLIs):
``python -m pytorch_mnist_ddp_tpu_torch.tools.train_chaos [--device cuda|cpu]``.

The resilient runtime's bar is not "it resumed" but "the resumed run is
byte-identical to a run that was never killed".  The tool runs an
uninterrupted baseline of ``python -m pytorch_mnist_ddp_tpu_torch.mnist``,
then for each scheduled kill point the same trainer under deterministic
chaos (``--chaos kill:step:after=K``, fired at an exact step-event count,
so there is no timer race), asserts that the process died with the
SIGKILL-convention code 137, resumes from the mid-epoch archive (the
rotated ``.prev`` when the kill landed inside the checkpoint publish
window: the port leaves ``X.npz.new`` and ``X.npz.prev`` there) and
verifies:

- the resumed run's final ``--save-state`` archive equals the baseline's
  array for array, bit for bit (parameters, Adadelta accumulators, step
  counter, BN statistics; the port writes the JAX package's npz format);
- every ``(epoch, step) -> loss`` telemetry event of the killed and the
  resumed runs matches the baseline's exactly.

Optional rounds: a real SIGTERM preemption (``--preempt-after-s``: a
nondeterministic kill position, the same bar; the emergency-save path),
and a NaN injection (``--nan-step``) that the LossGuard must heal with no
numeric divergence and exactly one ``train_anomalies_total{kind="nan"}``
in the exposition.

    python -m pytorch_mnist_ddp_tpu_torch.tools.train_chaos --device cpu \\
        --synthetic 768 --epochs 2 --checkpoint-every-steps 3 \\
        --kill-steps 4,9,save --nan-step 5

Exit 0 when every scheduled round passed; 1 with per-round ``FAIL`` lines
otherwise.  ``save`` in ``--kill-steps`` schedules the mid-save kill
(``kill:ckpt_save:after=1``: die between the rotation and the publish of
the second periodic checkpoint).

**Distributed mode** (``--distributed --nproc N``) drives the elastic
runtime through the supervising launcher (``python -m
pytorch_mnist_ddp_tpu_torch.parallel.launch --nprocs N``) over
``mnist_ddp``: an uninterrupted baseline; a rank-scoped kill round
(``--chaos kill:step:rank=1:after=4``) that must gang-restart from the
coordinated mid-epoch archive and finish on the baseline's bytes
(``launch_restarts_total`` >= 1, ``rank_death`` and ``gang_restart``
events); a ``--restart-budget 0`` round that must escalate to a non-zero
launcher exit with exactly one ``launch: gang failed`` line (at ``--nproc
1`` the launcher is transparent, in both packages: the rank's code 137
passes through with no such line, which the round then requires; the
JAX tool has no case for it); and a resume
of the exhausted gang's archive under ``--elastic`` through a fresh
launcher (one process a rank, where JAX resumes in one process driving N
devices), held within the JAX tool's tolerances.

``--device cuda`` (the default) trains on the card and raises without one;
two NCCL ranks cannot share one card, so there the distributed rounds run
as a world of one (``--nproc 1 --chaos kill:step:rank=0:after=4``).
``--device cpu`` passes ``--no-accel`` to the trainers and ``--backend
cpu`` (gloo) to the launcher.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import struct
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAINER = "pytorch_mnist_ddp_tpu_torch.mnist"
DDP_TRAINER = "pytorch_mnist_ddp_tpu_torch.mnist_ddp"
LAUNCHER = "pytorch_mnist_ddp_tpu_torch.parallel.launch"

EXIT_KILLED = 137    # os._exit at the injected kill point (128+SIGKILL)


def _env() -> dict:
    """The trainers' environment: this one, the repository on the path."""
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (REPO, path) if p)}


def _write_synthetic_idx(root: str, n_train: int, n_test: int) -> None:
    from ..data.mnist import synthetic_mnist

    os.makedirs(root, exist_ok=True)
    xi, yi = synthetic_mnist("train", n=n_train)
    xt, yt = synthetic_mnist("test", n=n_test)
    for name, arr in (
        ("train-images-idx3-ubyte", xi), ("train-labels-idx1-ubyte", yi),
        ("t10k-images-idx3-ubyte", xt), ("t10k-labels-idx1-ubyte", yt),
    ):
        with open(os.path.join(root, name), "wb") as f:
            if arr.ndim == 3:
                f.write(struct.pack(">iiii", 2051, *arr.shape))
            else:
                f.write(struct.pack(">ii", 2049, len(arr)))
            f.write(arr.tobytes())


def _device_flags(args) -> list[str]:
    return ["--no-accel"] if args.device == "cpu" else []


def _common_flags(args, epochs) -> list[str]:
    return [
        "--data-root", args.data_root,
        "--epochs", str(epochs),
        "--batch-size", str(args.batch_size),
        "--test-batch-size", str(args.test_batch_size),
        "--seed", str(args.seed),
        "--log-interval", "1000000",
    ]


def _trainer_cmd(args, *, epochs, extra):
    return [sys.executable, "-m", TRAINER, *_device_flags(args),
            *_common_flags(args, epochs), *extra]


def _run(cmd, *, cwd=REPO, check_code=None, label=""):
    proc = subprocess.run(
        cmd, cwd=cwd, env=_env(), capture_output=True, text=True
    )
    if check_code is not None and proc.returncode != check_code:
        raise RuntimeError(
            f"{label}: expected exit {check_code}, got {proc.returncode}\n"
            f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
        )
    return proc


def _step_losses(tel_dir: str) -> dict[tuple[int, int], float]:
    from ..obs.events import read_events

    out: dict[tuple[int, int], float] = {}
    for path in sorted(glob.glob(os.path.join(tel_dir, "*.jsonl"))):
        for e in read_events(path):
            if e.get("event") == "step":
                out[(e["epoch"], e["step"])] = e["loss"]
    return out


def _archive_arrays(path: str) -> dict:
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files if not k.startswith("meta.")}


def _archives_bit_equal(a: str, b: str) -> list[str]:
    """[] when bit-identical; else human-readable mismatch lines."""
    import numpy as np

    za, zb = _archive_arrays(a), _archive_arrays(b)
    problems = []
    if set(za) != set(zb):
        problems.append(
            f"key sets differ: only-in-{a}: {sorted(set(za) - set(zb))}, "
            f"only-in-{b}: {sorted(set(zb) - set(za))}"
        )
    for k in sorted(set(za) & set(zb)):
        va, vb = za[k], zb[k]
        if va.dtype != vb.dtype or va.shape != vb.shape:
            problems.append(f"{k}: {va.dtype}{va.shape} vs {vb.dtype}{vb.shape}")
        elif va.tobytes() != vb.tobytes():
            diff = np.max(np.abs(va.astype(np.float64) - vb.astype(np.float64)))
            problems.append(f"{k}: bytes differ (max |delta| {diff:g})")
    return problems


def _archives_close(a: str, b: str, atol: float) -> list[str]:
    """Same keys/dtypes/shapes and every array within ``atol``: the
    cross-topology bar (sample-exact continuation, reassociated
    reductions; see the reshard-resume round)."""
    import numpy as np

    za, zb = _archive_arrays(a), _archive_arrays(b)
    problems = []
    if set(za) != set(zb):
        problems.append(
            f"key sets differ: only-in-{a}: {sorted(set(za) - set(zb))}, "
            f"only-in-{b}: {sorted(set(zb) - set(za))}"
        )
    for k in sorted(set(za) & set(zb)):
        va, vb = za[k], zb[k]
        if va.dtype != vb.dtype or va.shape != vb.shape:
            problems.append(f"{k}: {va.dtype}{va.shape} vs {vb.dtype}{vb.shape}")
            continue
        diff = float(
            np.max(np.abs(va.astype(np.float64) - vb.astype(np.float64)))
        ) if va.size else 0.0
        if diff > atol:
            problems.append(f"{k}: max |delta| {diff:g} > atol {atol:g}")
    return problems


def _curve_close_to(sub: dict, base: dict, label: str,
                    atol: float) -> list[str]:
    """Every (epoch, step) of ``sub`` exists in ``base`` within ``atol``:
    the loss-curve bar for re-sharded continuations."""
    problems = []
    for key, loss in sorted(sub.items()):
        if key not in base:
            problems.append(f"{label}: step {key} not in baseline curve")
        elif not (abs(loss - base[key]) <= atol
                  or (loss != loss and base[key] != base[key])):
            problems.append(
                f"{label}: loss at {key} = {loss!r} vs baseline "
                f"{base[key]!r} (|delta| > {atol:g})"
            )
    return problems


def _curve_subset_of(sub: dict, base: dict, label: str) -> list[str]:
    problems = []
    for key, loss in sorted(sub.items()):
        if key not in base:
            problems.append(f"{label}: step {key} not in baseline curve")
        elif not (loss == base[key] or (loss != loss and base[key] != base[key])):
            problems.append(
                f"{label}: loss at {key} = {loss!r} != baseline {base[key]!r}"
            )
    return problems


def _epochs_completed(state_path: str) -> int | None:
    """Epochs completed per the archive (or its rotation); None when no
    archive survived (a kill before the first cadence): resume is then a
    fresh start, which reproduces the baseline from the same seed."""
    import numpy as np

    for candidate in (state_path, state_path + ".prev"):
        try:
            with np.load(candidate) as z:
                if "epoch" in z.files:
                    return int(z["epoch"])
        except Exception:
            continue
    return None


def _kill_round(args, name: str, chaos: str, results: list) -> None:
    rd = os.path.join(args.workdir, name)
    os.makedirs(rd, exist_ok=True)
    state = os.path.join(rd, "state.npz")
    final = os.path.join(rd, "final.npz")
    tel_killed = os.path.join(rd, "tel_killed")
    tel_resumed = os.path.join(rd, "tel_resumed")

    _run(
        _trainer_cmd(args, epochs=args.epochs, extra=[
            "--chaos", chaos,
            "--checkpoint-every-steps", str(args.checkpoint_every_steps),
            "--save-state", state,
            "--telemetry-dir", tel_killed,
        ]),
        check_code=EXIT_KILLED, label=f"{name}: killed run",
    )
    if "ckpt_save" in chaos:
        # The mid-save kill must land inside the publish window: no
        # <state>, a complete rotation at <state>.prev, the archive the
        # resume is about to prove loadable.
        if os.path.exists(state) or not os.path.exists(state + ".prev"):
            results.append((name, [
                "mid-save kill did not land in the rotation window "
                f"(state exists={os.path.exists(state)}, "
                f"prev exists={os.path.exists(state + '.prev')})"
            ]))
            return
    done = _epochs_completed(state)
    if done is None:
        # Killed before the first cadence: nothing to resume, rerun from
        # scratch (same seed, same run).
        resume_extra = []
        epochs = args.epochs
    else:
        resume_extra = ["--resume-state", state]
        epochs = args.epochs - done
    _run(
        _trainer_cmd(args, epochs=epochs, extra=[
            *resume_extra,
            "--save-state", final,
            "--telemetry-dir", tel_resumed,
        ]),
        check_code=0, label=f"{name}: resumed run",
    )
    problems = _archives_bit_equal(final, args.baseline_final)
    base_curve = _step_losses(args.baseline_tel)
    problems += _curve_subset_of(
        _step_losses(tel_killed), base_curve, "killed-run curve"
    )
    problems += _curve_subset_of(
        _step_losses(tel_resumed), base_curve, "resumed-run curve"
    )
    results.append((name, problems))


def _preempt_round(args, results: list) -> None:
    name = f"preempt@{args.preempt_after_s:g}s"
    rd = os.path.join(args.workdir, "preempt")
    os.makedirs(rd, exist_ok=True)
    state = os.path.join(rd, "state.npz")
    final = os.path.join(rd, "final.npz")
    tel_resumed = os.path.join(rd, "tel_resumed")
    proc = subprocess.Popen(
        _trainer_cmd(args, epochs=args.epochs, extra=[
            "--checkpoint-every-steps", str(args.checkpoint_every_steps),
            "--save-state", state,
        ]),
        cwd=REPO, env=_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    time.sleep(args.preempt_after_s)
    proc.send_signal(signal.SIGTERM)
    code = proc.wait(timeout=120)
    if code == 0:
        print(f"  note: {name}: run finished before the SIGTERM landed; "
              "verifying its own final archive instead")
        results.append((name, _archives_bit_equal(state, args.baseline_final)))
        return
    if code != 128 + signal.SIGTERM:
        results.append((name, [
            f"expected exit {128 + signal.SIGTERM} (emergency save + clean "
            f"exit) or 0, got {code}"
        ]))
        return
    done = _epochs_completed(state)
    if done is None:
        results.append((name, ["SIGTERM landed but no archive was written"]))
        return
    _run(
        _trainer_cmd(args, epochs=args.epochs - done, extra=[
            "--resume-state", state,
            "--save-state", final,
            "--telemetry-dir", tel_resumed,
        ]),
        check_code=0, label=f"{name}: resumed run",
    )
    problems = _archives_bit_equal(final, args.baseline_final)
    problems += _curve_subset_of(
        _step_losses(tel_resumed), _step_losses(args.baseline_tel),
        "resumed-run curve",
    )
    results.append((name, problems))


def _nan_round(args, results: list) -> None:
    name = f"nan@step{args.nan_step}"
    rd = os.path.join(args.workdir, "nan")
    os.makedirs(rd, exist_ok=True)
    final = os.path.join(rd, "final.npz")
    tel = os.path.join(rd, "tel")
    _run(
        _trainer_cmd(args, epochs=args.epochs, extra=[
            "--chaos", f"nan:step:after={args.nan_step}",
            "--loss-guard",
            "--save-state", final,
            "--telemetry-dir", tel,
        ]),
        check_code=0, label=f"{name}: guarded run",
    )
    problems = _archives_bit_equal(final, args.baseline_final)
    prom_path = os.path.join(tel, "metrics.prom")
    try:
        prom = open(prom_path).read()
    except OSError:
        prom = ""
    if 'train_anomalies_total{kind="nan"} 1' not in prom:
        problems.append(
            f"{prom_path}: expected exactly one "
            'train_anomalies_total{kind="nan"}; got: '
            + repr([l for l in prom.splitlines() if "anomal" in l])
        )
    results.append((name, problems))


# ---------------------------------------------------------------------------
# Distributed mode: a real multi-rank gang through the supervising launcher.


def _free_port() -> int:
    """A TCP port on 127.0.0.1 free now, below the ephemeral range, and
    never one this process handed out before: the launcher binds it
    seconds later, and meanwhile every client connection on the host
    takes an ephemeral port as its source port."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    for port in random.Random().sample(range(10000, low), 200):
        if port in _HANDED_OUT:
            continue
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port))
        except OSError:
            continue
        _HANDED_OUT.add(port)
        return port
    raise RuntimeError(f"no free port under {low}")


_HANDED_OUT: set[int] = set()


def _backend_flags(args) -> list[str]:
    return ["--backend", "cpu"] if args.device == "cpu" else []


def _launcher_cmd(args, *, port, launch_extra, trainer_extra):
    """One supervised world: N rank processes, one device each."""
    return [
        sys.executable, "-m", LAUNCHER,
        "--nprocs", str(args.nproc), "--nproc_per_node", "1",
        *_backend_flags(args), "--master_port", str(port),
        "--rdzv-timeout-s", "120",
        *launch_extra,
        "-m", DDP_TRAINER, *_device_flags(args),
        *_common_flags(args, args.epochs),
        *trainer_extra,
    ]


def _read_events(tel_dir: str, name: str) -> list[dict]:
    from ..obs.events import read_events

    out = []
    for path in sorted(glob.glob(os.path.join(tel_dir, "*.jsonl"))):
        out.extend(e for e in read_events(path) if e.get("event") == name)
    return out


def _distributed_main(args) -> int:
    """Baseline -> rank-kill gang-restart -> budget-0 escalation ->
    resume of the exhausted gang's archive."""
    print(f"train_chaos[distributed]: {args.nproc}-rank gang, "
          f"workdir {args.workdir}, chaos {args.chaos!r}")
    results: list[tuple[str, list[str]]] = []

    base_dir = os.path.join(args.workdir, "dist_baseline")
    base_tel = os.path.join(base_dir, "tel")
    baseline_final = os.path.join(base_dir, "final.npz")
    os.makedirs(base_dir, exist_ok=True)
    t0 = time.perf_counter()
    _run(
        _launcher_cmd(args, port=_free_port(), launch_extra=[], trainer_extra=[
            "--save-state", baseline_final,
            "--telemetry-dir", base_tel,
        ]),
        check_code=0, label="distributed baseline",
    )
    base_curve = _step_losses(base_tel)
    print(f"  baseline: {args.epochs} epoch(s) x {args.nproc} ranks, "
          f"{len(base_curve)} steps ({time.perf_counter() - t0:.1f} s)")

    # Round 1: rank-scoped kill -> supervisor gang-restart -> resume ->
    # byte-identical finish.
    name = f"gang-kill[{args.chaos}]"
    rd = os.path.join(args.workdir, "dist_kill")
    tel = os.path.join(rd, "tel")
    state = os.path.join(rd, "state.npz")
    os.makedirs(rd, exist_ok=True)
    _run(
        _launcher_cmd(
            args, port=_free_port(),
            launch_extra=[
                "--restart-budget", "2", "--grace-s", "10",
                "--backoff-base-s", "0.1", "--telemetry-dir", tel,
            ],
            trainer_extra=[
                "--chaos", args.chaos,
                "--preempt-grace-s", "5",
                "--checkpoint-every-steps",
                str(args.checkpoint_every_steps),
                "--save-state", state,
                "--telemetry-dir", tel,
            ],
        ),
        check_code=0, label=f"{name}: supervised run",
    )
    problems = _archives_bit_equal(state, baseline_final)
    gang_curve = _step_losses(tel)
    problems += _curve_subset_of(gang_curve, base_curve, "gang curve")
    if base_curve and max(base_curve) not in gang_curve:
        problems.append(
            f"gang curve never reached the baseline's final step "
            f"{max(base_curve)} (resume did not finish the run)"
        )
    deaths = _read_events(tel, "rank_death")
    restarts = _read_events(tel, "gang_restart")
    if not deaths:
        problems.append("no rank_death event: the kill never fired "
                        "(vacuous green)")
    if not restarts:
        problems.append("no gang_restart event: the supervisor never "
                        "restarted the world")
    prom_path = os.path.join(tel, "launcher.prom")
    try:
        prom = open(prom_path).read()
    except OSError:
        prom = ""
    if not any(
        line.startswith("launch_restarts_total ")
        and float(line.split()[-1]) >= 1
        for line in prom.splitlines()
    ):
        problems.append(f"{prom_path}: launch_restarts_total >= 1 missing")
    results.append((name, problems))

    # Round 2: the same kill with --restart-budget 0 must escalate to a
    # clean non-zero exit with exactly one diagnostic.
    name0 = "gang-budget0"
    rd0 = os.path.join(args.workdir, "dist_budget0")
    tel0 = os.path.join(rd0, "tel")
    os.makedirs(rd0, exist_ok=True)
    proc0 = _run(
        _launcher_cmd(
            args, port=_free_port(),
            launch_extra=[
                "--restart-budget", "0", "--grace-s", "10",
                "--telemetry-dir", tel0,
            ],
            trainer_extra=[
                "--chaos", args.chaos,
                "--preempt-grace-s", "5",
                "--checkpoint-every-steps",
                str(args.checkpoint_every_steps),
                "--save-state", os.path.join(rd0, "state.npz"),
            ],
        ),
    )
    problems0 = []
    if proc0.returncode == 0:
        problems0.append("budget-0 launcher exited 0: the kill never "
                         "escalated")
    diags = [
        line for line in proc0.stderr.splitlines()
        if line.startswith("launch: gang failed")
    ]
    if args.nproc == 1:
        # A world of one without a budget is transparent in both
        # packages' launchers: the killed rank's code passes through and
        # no gang diagnostic is printed.
        if proc0.returncode != EXIT_KILLED or diags:
            problems0.append(
                f"expected the rank's exit {EXIT_KILLED} passed through with no "
                f"gang diagnostic, got exit {proc0.returncode} and {diags!r}"
            )
    elif len(diags) != 1:
        problems0.append(
            f"expected exactly one 'launch: gang failed' diagnostic, got "
            f"{len(diags)}: {diags!r}"
        )
    results.append((name0, problems0))

    # Round 3: the archive the exhausted gang left behind, coordinated at
    # world size N, resumed under --elastic by a fresh launcher of N
    # ranks.  JAX resumes it in one process driving N devices, whose
    # reductions reassociate, so its bar is sample-exact and
    # loss-curve-compatible within a tolerance; the same bar holds here.
    name1 = "reshard-resume"
    state0 = os.path.join(rd0, "state.npz")
    problems1: list[str] = []
    if not (os.path.exists(state0) or os.path.exists(state0 + ".prev")):
        problems1.append(
            "the exhausted gang left no coordinated archive to resume"
        )
    else:
        _run(
            [
                sys.executable, "-m", LAUNCHER,
                "--nproc_per_node", str(args.nproc), *_backend_flags(args),
                "--master_port", str(_free_port()),
                "-m", DDP_TRAINER, *_device_flags(args),
                *_common_flags(args, args.epochs),
                "--elastic",  # resume own archive, epochs-as-total
                "--save-state", state0,
                "--telemetry-dir", tel0,
            ],
            check_code=0, label=f"{name1}: resume",
        )
        problems1 += _archives_close(state0, baseline_final, atol=0.15)
        reshard_curve = _step_losses(tel0)
        problems1 += _curve_close_to(
            reshard_curve, base_curve, "reshard curve", atol=0.35
        )
        if base_curve and max(base_curve) not in reshard_curve:
            problems1.append(
                "reshard curve never reached the baseline's final step"
            )
    results.append((name1, problems1))

    failed = False
    for rname, rproblems in results:
        if rproblems:
            failed = True
            print(f"FAIL {rname}:")
            for line in rproblems:
                print(f"    {line}")
        else:
            print(f"PASS {rname}")
    return 1 if failed else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.tools.train_chaos",
        description="trainer chaos harness: kill -> resume -> verify "
        "bit-exact params + loss curve"
    )
    p.add_argument("--workdir", default=None,
                   help="scratch directory (default: a fresh temp dir)")
    p.add_argument("--data-root", default=None,
                   help="MNIST IDX directory (default: generate --synthetic)")
    p.add_argument("--synthetic", type=int, default=768, metavar="N",
                   help="generate an N-sample synthetic train set "
                        "(N//3 test) when no --data-root (default: 768)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--test-batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--checkpoint-every-steps", type=int, default=3)
    p.add_argument("--kill-steps", default="4,9,save",
                   help="comma list of deterministic kill points: step-event "
                        "counts and/or 'save' (mid-checkpoint-publish kill); "
                        "default: 4,9,save")
    p.add_argument("--preempt-after-s", type=float, default=0.0, metavar="T",
                   help="also run a real-SIGTERM preemption round T seconds "
                        "into the run (0 = skip; timing-dependent by design)")
    p.add_argument("--nan-step", type=int, default=5, metavar="K",
                   help="NaN-injection round: poison step K under "
                        "--loss-guard and require a bit-exact heal "
                        "(-1 = skip; default: 5)")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="elastic-runtime mode: drive a real --nproc-rank "
                        "gang through the supervising launcher, kill one "
                        "rank mid-epoch (--chaos), and require gang-restart "
                        "+ byte-identical finish")
    p.add_argument("--nproc", type=int, default=2, metavar="N",
                   help="rank processes in the distributed gang "
                        "(default: 2; 1 on the card, which NCCL ranks "
                        "cannot share)")
    p.add_argument("--chaos", default="kill:step:rank=1:after=4",
                   metavar="SPEC",
                   help="distributed-round chaos clause (rank-scoped "
                        "trainer grammar; default: kill rank 1 before its "
                        "5th step)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the trainers run: the card (the default; "
                        "raises without one), or the CPU (--no-accel, and "
                        "gloo ranks under --distributed)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from ..device import resolve_device

    # --device cuda on a host without a card raises here, not in every
    # trainer process one round at a time
    resolve_device(args.device)

    if args.workdir is None:
        import tempfile

        args.workdir = tempfile.mkdtemp(prefix="train_chaos_")
    os.makedirs(args.workdir, exist_ok=True)
    if args.data_root is None:
        args.data_root = os.path.join(args.workdir, "data")
        _write_synthetic_idx(args.data_root, args.synthetic,
                             max(args.synthetic // 3, args.test_batch_size))
    if args.distributed:
        return _distributed_main(args)
    print(f"train_chaos: workdir {args.workdir}, data {args.data_root}")

    base_dir = os.path.join(args.workdir, "baseline")
    os.makedirs(base_dir, exist_ok=True)
    args.baseline_final = os.path.join(base_dir, "final.npz")
    args.baseline_tel = os.path.join(base_dir, "tel")
    t0 = time.perf_counter()
    _run(
        _trainer_cmd(args, epochs=args.epochs, extra=[
            "--save-state", args.baseline_final,
            "--telemetry-dir", args.baseline_tel,
        ]),
        check_code=0, label="baseline run",
    )
    n_steps = len(_step_losses(args.baseline_tel))
    print(f"  baseline: {args.epochs} epoch(s), {n_steps} steps "
          f"({time.perf_counter() - t0:.1f} s)")

    results: list[tuple[str, list[str]]] = []
    for spec in [s.strip() for s in args.kill_steps.split(",") if s.strip()]:
        if spec == "save":
            _kill_round(args, "kill@ckpt_save", "kill:ckpt_save:after=1",
                        results)
        else:
            k = int(spec)
            if not 0 <= k < n_steps:
                print(f"  note: kill step {k} outside the run's "
                      f"{n_steps} steps; it would never fire — skipping")
                continue
            _kill_round(args, f"kill@step{k}", f"kill:step:after={k}", results)
    if args.preempt_after_s > 0:
        _preempt_round(args, results)
    if args.nan_step >= 0:
        _nan_round(args, results)

    failed = False
    for name, problems in results:
        if problems:
            failed = True
            print(f"FAIL {name}:")
            for line in problems:
                print(f"    {line}")
        else:
            print(f"PASS {name}: resumed run bit-identical to baseline")
    if not results:
        print("train_chaos: nothing ran (empty schedule?)")
        return 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
