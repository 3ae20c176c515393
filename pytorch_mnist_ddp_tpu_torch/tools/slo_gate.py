"""Machine-checked SLO regression gate over the port's serving stack:
``python -m pytorch_mnist_ddp_tpu_torch.tools.slo_gate``.

The JAX package's ``tools/slo_gate.py`` over the port.  It replays the
canned open-loop trace of ``slo_budgets.json`` (beside this file: seeded
Poisson arrivals + seeded sizes — the trace is fully determined by the
protocol block) through the port's load generator
(``python -m pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen``, a
subprocess a round, on ``--device``: ``cuda`` by default, ``cpu`` on
request) against a two-replica ``dp,dp`` pool, then asserts the budget
table **straight from the run's artifacts**:

==========================  =============================================
budget                      asserted from
==========================  =============================================
client p99                  the loadgen report (open-loop, coordinated-
                            omission-free latency)
server p99                  telemetry JSONL ``serving_request`` events
batch fill ratio (mean)     Prometheus dump ``serving_batch_fill_ratio``
                            ``_sum``/``_count``
pipeline stall (total s)    Prometheus dump ``serving_pipeline_stall_
                            seconds_sum``
zero post-warmup compiles   Prometheus dump ``compile_programs_total`` ==
                            replicas x rungs (the warmed rung Programs,
                            exactly; rungs = the pow2 ladder, or the
                            packed capacity ladder of
                            ``serving/buckets.packed_capacities`` when the
                            protocol sets ``"packed": true``) + the
                            report's ``additional_compiles`` (the load
                            generator's compile firewall: rung Programs
                            built and kernel libraries built or loaded
                            after warmup)
recovery (mean s, count)    recovery-round telemetry ``replica_restart``
                            events under the committed chaos clause
zero-downtime weight swap   swap-round registry report (loadgen
                            ``--swap-at-s`` + ``--canary-sweep``): zero
                            lost/torn responses, zero added compiles,
                            the new weights actually served
==========================  =============================================

Each run appends one row to the trajectory (``--trajectory``, by default
``build/loadgen/BENCH_slo.json`` under the working directory: measured
values + verdict).

``--inject p99`` arms the committed regression schedule (per-dispatch
hang on every replica — a server that got slower) and skips the
recovery and swap rounds: the gate must then exit non-zero with a p99
breach, which is how the gate proves it bites.

Usage:
    python -m pytorch_mnist_ddp_tpu_torch.tools.slo_gate [--device cpu]
        [--budgets slo_budgets.json] [--trajectory PATH] [--no-append]
        [--inject p99] [--workdir DIR] [--keep]

Exit 0 = every budget met; 1 = at least one budget breached (or a
round's loadgen verdict failed); 2 = infrastructure/usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# The directory that holds the package: the loadgen subprocesses import
# it whatever the working directory.
PKG_ROOT = os.path.dirname(os.path.dirname(HERE))
LOADGEN = "pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen"


def _read_prom(path: str) -> dict[str, float]:
    """Flat ``{sample_name{labels}: value}`` map of a Prometheus text
    exposition (comments skipped); the gate reads raw samples, not a
    scrape library's interpretation."""
    out: dict[str, float] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, _, value = line.rpartition(" ")
                try:
                    out[name] = float(value)
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def _prom_sum(prom: dict[str, float], family: str) -> float:
    """Sum every sample of ``family`` across label sets (exact name or
    ``family{...}``)."""
    pat = re.compile(re.escape(family) + r"(\{|$)")
    return sum(v for k, v in prom.items() if pat.match(k))


def _read_events(directory: str) -> list[dict]:
    import glob

    from ..obs.events import read_events

    events: list[dict] = []
    for path in sorted(glob.glob(os.path.join(directory, "*.jsonl"))):
        events.extend(read_events(path))
    return events


def _percentile(sorted_values: list[float], q: float) -> float:
    from ..obs.registry import percentile

    return percentile(sorted_values, q)


def _run_loadgen(label: str, cli_args: list[str], device: str,
                 timeout_s: float = 600.0) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PKG_ROOT, *filter(None, [env.get("PYTHONPATH")])])
    cmd = [sys.executable, "-m", LOADGEN, "--device", device, *cli_args]
    print(f"slo_gate [{label}]: {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, env=env, timeout=timeout_s)
    return proc.returncode


def _write_trajectory(path: str, row: dict) -> None:
    trajectory: list = []
    try:
        with open(path) as f:
            trajectory = json.load(f)
            if not isinstance(trajectory, list):
                trajectory = [trajectory]
    except (OSError, ValueError):
        trajectory = []
    trajectory.append(row)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trajectory, f, indent=2)
        f.write("\n")


def expected_warmup_compiles(protocol: dict) -> int:
    """The warmed rung Programs the protocol's pool builds: replicas x
    rungs, f32 only; rungs = the pow2 ladder, or the packed capacity
    ladder when the protocol runs packed (counting the pre-collapse
    ladder would flag the collapse itself as a breach)."""
    buckets = [int(b) for b in str(protocol["buckets"]).split(",")]
    if protocol.get("packed"):
        from ..serving.buckets import packed_capacities

        rungs = list(packed_capacities(max(buckets)))
    else:
        rungs = buckets
    return int(protocol["replicas"]) * len(rungs)


def run_gate(args) -> int:
    with open(args.budgets) as f:
        spec = json.load(f)
    protocol, budgets = spec["protocol"], spec["budgets"]
    injected = args.inject
    workdir = args.workdir or tempfile.mkdtemp(prefix="slo_gate_")
    os.makedirs(workdir, exist_ok=True)
    replicas = int(protocol["replicas"])
    packed = bool(protocol.get("packed"))

    common = [
        "--open-loop",
        "--rate", str(protocol["rate_rps"]),
        "--requests", str(protocol["requests"]),
        "--max-request", str(protocol["max_request"]),
        "--buckets", str(protocol["buckets"]),
        "--replicas", str(replicas),
        "--seed", str(protocol["seed"]),
        "--timeout-s", str(protocol.get("client_timeout_s", 30)),
    ]
    if packed:
        common += ["--packed"]
        if protocol.get("fill_wait_ms") is not None:
            common += ["--fill-wait-ms", str(protocol["fill_wait_ms"])]
    if protocol.get("replica_shapes"):
        common += ["--replica-shapes", str(protocol["replica_shapes"])]

    # -- round 1: the steady-state trace --------------------------------------
    steady_report = os.path.join(workdir, "steady_report.json")
    steady_prom = os.path.join(workdir, "steady.prom")
    steady_tel = os.path.join(workdir, "steady_tel")
    steady_args = common + [
        "--report", steady_report,
        "--prom-dump", steady_prom,
        "--telemetry-dir", steady_tel,
    ]
    if injected == "p99":
        # The committed regression: every dispatch on every replica gets
        # slower (the chaos grammar's per-dispatch hang) and the server
        # deadline is opened up so requests complete slowly instead of
        # expiring — the p99 budget, not a 504 flood, must catch it.
        steady_args += [
            "--chaos", protocol["inject_p99_chaos"],
            "--chaos-seed", str(protocol.get("chaos_seed", 0)),
            "--chaos-max-503-rate", "1.0",
            "--chaos-stall-timeout", "30",
            "--timeout-ms", "20000",
        ]
    steady_rc = _run_loadgen("steady", steady_args, args.device)

    measured: dict = {"steady_loadgen_rc": steady_rc}
    failures: list[str] = []
    try:
        with open(steady_report) as f:
            report = json.load(f)
    except (OSError, ValueError) as e:
        print(f"slo_gate: steady round produced no report ({e})")
        return 2

    prom = _read_prom(steady_prom)
    events = _read_events(steady_tel)

    # p99, client side (open-loop scheduled-arrival latency — the
    # coordinated-omission-free number) and server side (JSONL).
    measured["client_p99_ms"] = float(report["latency_ms"]["p99"])
    server_lats = sorted(
        e["latency_s"] for e in events
        if e.get("event") == "serving_request" and "latency_s" in e
    )
    measured["server_p99_ms"] = (
        1e3 * _percentile(server_lats, 99) if server_lats else None
    )
    measured["goodput_rps"] = report.get("goodput_rps")

    # Fill ratio + stall, straight from the Prometheus dump.
    fill_sum = _prom_sum(prom, "serving_batch_fill_ratio_sum")
    fill_count = _prom_sum(prom, "serving_batch_fill_ratio_count")
    measured["mean_fill_ratio"] = (
        fill_sum / fill_count if fill_count else None
    )
    measured["stall_seconds_total"] = _prom_sum(
        prom, "serving_pipeline_stall_seconds_sum"
    )

    # Zero post-warmup compiles: the rung Programs built must be EXACTLY
    # the warmup grid, and the report's firewall delta must be zero.
    measured["compile_programs_total"] = _prom_sum(prom, "compile_programs_total")
    measured["expected_warmup_compiles"] = expected_warmup_compiles(protocol)
    measured["additional_compiles"] = report.get("additional_compiles")
    programs = (report.get("server_metrics_after") or {}).get("programs") or {}
    measured["library_builds"] = programs.get("library_builds")

    def check(name: str, ok: bool, detail: str) -> None:
        verdict = "ok" if ok else "BREACH"
        print(f"slo_gate: {name:<28} {detail:<44} [{verdict}]")
        if not ok:
            failures.append(name)

    check(
        "client_p99_ms",
        measured["client_p99_ms"] <= budgets["client_p99_ms"],
        f"{measured['client_p99_ms']:.1f} <= {budgets['client_p99_ms']}",
    )
    check(
        "server_p99_ms",
        measured["server_p99_ms"] is not None
        and measured["server_p99_ms"] <= budgets["server_p99_ms"],
        f"{measured['server_p99_ms'] and round(measured['server_p99_ms'], 1)}"
        f" <= {budgets['server_p99_ms']}",
    )
    check(
        "mean_fill_ratio",
        measured["mean_fill_ratio"] is not None
        and measured["mean_fill_ratio"] >= budgets["min_mean_fill_ratio"],
        f"{measured['mean_fill_ratio'] and round(measured['mean_fill_ratio'], 3)}"
        f" >= {budgets['min_mean_fill_ratio']}",
    )
    check(
        "stall_seconds_total",
        measured["stall_seconds_total"] <= budgets["max_stall_seconds_total"],
        f"{measured['stall_seconds_total']:.3f} <= "
        f"{budgets['max_stall_seconds_total']}",
    )
    check(
        "post_warmup_compiles",
        measured["compile_programs_total"] == measured["expected_warmup_compiles"]
        and measured["additional_compiles"] == 0,
        f"{measured['compile_programs_total']:.0f} == "
        f"{measured['expected_warmup_compiles']} and delta "
        f"{measured['additional_compiles']} == 0",
    )
    if injected is None and steady_rc != 0:
        check("steady_loadgen_verdict", False, f"rc {steady_rc} != 0")

    # -- round 2: recovery under the committed chaos clause --------------------
    if injected is None:
        rec_report = os.path.join(workdir, "recovery_report.json")
        rec_tel = os.path.join(workdir, "recovery_tel")
        rec_rc = _run_loadgen(
            "recovery",
            common + [
                "--report", rec_report,
                "--telemetry-dir", rec_tel,
                "--chaos", protocol["recovery_chaos"],
                "--chaos-seed", str(protocol.get("chaos_seed", 0)),
                "--chaos-max-503-rate", "0.25",
                "--chaos-stall-timeout", "2.0",
            ],
            args.device,
        )
        rec_events = _read_events(rec_tel)
        recoveries = [
            float(e["recovery_s"]) for e in rec_events
            if e.get("event") == "replica_restart"
            and e.get("outcome") == "restarted" and "recovery_s" in e
        ]
        measured["recovery_loadgen_rc"] = rec_rc
        measured["restarts"] = len(recoveries)
        measured["mean_recovery_s"] = (
            sum(recoveries) / len(recoveries) if recoveries else None
        )
        check(
            "recovery_restarts",
            measured["restarts"] >= budgets["min_restarts"],
            f"{measured['restarts']} >= {budgets['min_restarts']}",
        )
        check(
            "mean_recovery_s",
            measured["mean_recovery_s"] is not None
            and measured["mean_recovery_s"] <= budgets["max_mean_recovery_s"],
            f"{measured['mean_recovery_s'] and round(measured['mean_recovery_s'], 3)}"
            f" <= {budgets['max_mean_recovery_s']}",
        )
        check(
            "recovery_loadgen_verdict", rec_rc == 0, f"rc {rec_rc} == 0"
        )

    # -- round 3: zero-downtime weight swap + canary sweep ---------------------
    # Registry drive: a live /admin/swap fired mid-trace plus the
    # committed canary rungs, all on one engine (the drive owns its own
    # registry stack).  The budget is absolute: zero lost requests, zero
    # torn responses, zero post-warmup compiles — a weight swap that
    # drops or rebuilds is an outage, not a degradation.
    if injected is None:
        swap_report_path = os.path.join(workdir, "registry_report.json")
        swap_rc = _run_loadgen(
            "swap",
            [
                "--swap-at-s", str(protocol.get("swap_at_s", 1.0)),
                "--canary-sweep", str(protocol.get("canary_pcts", "25,50")),
                "--requests", str(protocol["requests"]),
                "--max-request", str(protocol["max_request"]),
                "--buckets", str(protocol["buckets"]),
                "--seed", str(protocol["seed"]),
                "--timeout-s", str(protocol.get("client_timeout_s", 30)),
                "--registry-report", swap_report_path,
            ],
            args.device,
        )
        try:
            with open(swap_report_path) as f:
                swap_report = json.load(f)
        except (OSError, ValueError) as e:
            print(f"slo_gate: swap round produced no report ({e})")
            return 2
        swap = swap_report.get("swap", {})
        sweep = swap_report.get("canary_sweep", {})
        measured["swap_loadgen_rc"] = swap_rc
        measured["swap_requests"] = swap.get("requests")
        measured["swap_lost"] = swap.get("lost_or_failed")
        measured["swap_torn"] = swap.get("torn")
        measured["swap_served_new"] = swap.get("served_new")
        measured["swap_added_compiles"] = swap_report.get(
            "additional_compiles"
        )
        measured["canary_misrouted"] = sum(
            r.get("misrouted", 0) + r.get("failed", 0)
            for r in sweep.get("rungs", [])
        )
        check(
            "swap_lost_requests",
            measured["swap_lost"] == budgets["max_swap_lost"] == 0,
            f"{measured['swap_lost']} == 0",
        )
        check(
            "swap_torn_responses",
            measured["swap_torn"] == budgets["max_swap_torn"] == 0,
            f"{measured['swap_torn']} == 0",
        )
        check(
            "swap_served_new_weights",
            (measured["swap_served_new"] or 0) > 0,
            f"{measured['swap_served_new']} > 0",
        )
        check(
            "swap_added_compiles",
            measured["swap_added_compiles"]
            == budgets["max_swap_added_compiles"] == 0,
            f"{measured['swap_added_compiles']} == 0",
        )
        check(
            "canary_exact_split",
            measured["canary_misrouted"] == 0,
            f"{measured['canary_misrouted']} misrouted/failed == 0",
        )
        check("swap_loadgen_verdict", swap_rc == 0, f"rc {swap_rc} == 0")

    passed = not failures
    row = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "injected": injected,
        "device": args.device,
        "pass": passed,
        "failures": failures,
        "measured": measured,
        "budgets": budgets,
        "protocol": protocol,
    }
    if not args.no_append:
        _write_trajectory(args.trajectory, row)
        print(f"slo_gate: appended run to {args.trajectory}")
    if not args.keep and args.workdir is None:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    print(
        f"SLO GATE: {'PASS' if passed else 'FAIL'}"
        + (f" (breached: {', '.join(failures)})" if failures else "")
        + (f" [injected={injected}]" if injected else "")
    )
    return 0 if passed else 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.tools.slo_gate",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where every round's loadgen serves (its --device): cuda "
        "raises without a card, cpu on request",
    )
    p.add_argument(
        "--budgets", default=os.path.join(HERE, "slo_budgets.json"),
        help="protocol + budget table (slo_budgets.json beside this file)",
    )
    p.add_argument(
        "--trajectory", default=os.path.join("build", "loadgen", "BENCH_slo.json"),
        help="SLO trajectory this run appends to",
    )
    p.add_argument(
        "--no-append", action="store_true",
        help="don't append this run to the trajectory (the "
        "injected-regression proof uses this)",
    )
    p.add_argument(
        "--inject", default=None, choices=("p99",),
        help="arm the committed regression schedule; the gate must then "
        "FAIL — the proof that the gate bites",
    )
    p.add_argument(
        "--workdir", default=None,
        help="where the run artifacts land (default: a temp dir, "
        "removed unless --keep)",
    )
    p.add_argument("--keep", action="store_true",
                   help="keep the artifacts directory")
    args = p.parse_args(argv)
    try:
        return run_gate(args)
    except subprocess.TimeoutExpired as e:
        print(f"slo_gate: round timed out: {e}")
        return 2


if __name__ == "__main__":
    sys.exit(main())
