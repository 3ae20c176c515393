#!/usr/bin/env python
"""The JAX package's ``tools/perf_report.py``, both halves.

With ``--telemetry DIR``, an operator summary of a telemetry directory:
``python -m pytorch_mnist_ddp_tpu_torch.tools.perf_report --telemetry DIR``.

:func:`summarize_telemetry` digests every ``*.jsonl`` event file that a
``--telemetry-dir`` run wrote (``obs/events.py``; the port writes the JAX
package's event names and fields) into the JAX tool's text, section for
section: steps (count and latency percentiles, by the repo-shared linear
interpolation), epochs and evaluation, startup, anomalies and
checkpoints, tail latency, resilience, the fleet, and the host and device
paths.  For the same directory it prints the same text as JAX's.
Stdout only; exit 1 when no event parses.

Without ``--telemetry`` it is the JAX tool's verdict half,
``python -m pytorch_mnist_ddp_tpu_torch.tools.perf_report [--no-write]``:
:func:`build_report` reads whichever attribution artifacts exist under
``ARTIFACT_DIR`` (``build/perf/`` of the checkout; never the JAX
package's artifacts at the repo root), all under the newest round's
prefix ``bench_rN_`` (a round-5 artifact shadows its round-4 namesake):

- ``bench_rN_stepattr.json``, the step ladder
  (``tools/step_attr_bench.py``'s line, promoted onto it by
  ``tools/window_promote.py rungs``), which must exist;
- its variants ``_bf16``, ``_im2col_c1``, ``_im2col`` and ``_b1000``
  (``--bf16``, ``--conv-impl``, ``--batch 1000``; ``_b1000`` promoted by
  ``rungs`` too, so the batch-scaling ratio divides two minima);
- ``bench_rN_attr.json``, ``tools/trace_attr.py``'s JSON over a fused
  step's trace;
- ``bench_rN_warm.json``, a benchmark's warm headline row (``run_s``,
  ``cache``): only then is the reconciliation line printed.

It prints JAX's text line for line: the rung table, the attribution
table, the ``run_s`` the ladder reconstructs, and the verdicts (the
pregather, the fwd+bwd share, bf16, both conv lowerings, batch scaling,
the trace).  Without ``--no-write`` the block is also appended to
``ARTIFACT_DIR/PERF.md``.  Exit 0 with a block; 1 without a ladder.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Where the verdict reads its artifacts and appends its block: build/ is
# untracked, so no run writes a tracked file.
ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "perf")

# The headline protocol (the JAX package's bench.py): 20 epochs of 300
# steps, 10 eval batches an epoch.
TRAIN_STEPS = 6000
EVAL_BATCHES = 200
EPOCHS = 20


def _detect_prefix():
    """The newest round whose ladder exists (``bench_rN_stepattr.json``);
    every companion artifact is then read under the SAME prefix, so no
    verdict mixes rounds."""
    import glob
    import re

    rounds = []
    for path in glob.glob(os.path.join(ARTIFACT_DIR, "bench_r*_stepattr.json")):
        m = re.match(r"bench_r(\d+)_stepattr\.json$", os.path.basename(path))
        if m:
            rounds.append(int(m.group(1)))
    return f"bench_r{max(rounds)}_" if rounds else None


def _load(suffix, prefix):
    try:
        with open(os.path.join(ARTIFACT_DIR, prefix + suffix)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fmt_us(v):
    return "—" if v is None else f"{v:,.0f} µs"


def build_report() -> str | None:
    """The verdict block for the artifacts under ``ARTIFACT_DIR``, or None
    without a ladder (or a ladder without its ``full`` rung)."""
    prefix = _detect_prefix()
    if prefix is None:
        return None
    ladder = _load("stepattr.json", prefix)
    if not ladder or ladder.get("full") is None:
        return None
    bf16 = _load("stepattr_bf16.json", prefix)
    attr = _load("attr.json", prefix)
    warm = _load("warm.json", prefix)
    conv_c1 = _load("stepattr_im2col_c1.json", prefix)
    conv_all = _load("stepattr_im2col.json", prefix)
    b1000 = _load("stepattr_b1000.json", prefix)

    g = ladder.get  # µs per iteration, or None
    lines = []
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    lines.append(f"### Window analysis — {stamp} "
                 f"({ladder.get('device_kind', '?')}; artifacts {prefix}*)")
    lines.append("")
    lines.append("| Rung | µs/iter |")
    lines.append("|---|---|")
    for k in ("empty_scan", "gather_norm", "gather_epoch", "fwd",
              "fwd_bwd", "full_nodrop", "full", "full_nogather",
              "full_pregather", "eval"):
        if g(k) is not None:
            lines.append(f"| {k} | {g(k):,.1f} |")
    lines.append("")

    def delta(a, b):
        return None if g(a) is None or g(b) is None else g(a) - g(b)

    attrib = [
        ("scan-loop overhead", g("empty_scan")),
        ("input (per-step gather+normalize)", delta("gather_norm",
                                                    "empty_scan")),
        ("input (pregather alternative)", delta("gather_epoch",
                                                "empty_scan")),
        ("forward compute", delta("fwd", "empty_scan")),
        ("backward extra", delta("fwd_bwd", "fwd")),
        ("optimizer + input (full_nodrop − fwd_bwd)",
         delta("full_nodrop", "fwd_bwd")),
        ("dropout/RNG (full − full_nodrop)", delta("full", "full_nodrop")),
        ("gather cross-check (full − full_nogather)",
         delta("full", "full_nogather")),
        ("pregather end-to-end win (full − full_pregather)",
         delta("full", "full_pregather")),
    ]
    lines.append("| Attribution | µs/step |")
    lines.append("|---|---|")
    for name, v in attrib:
        lines.append(f"| {name} | {_fmt_us(v)} |")
    lines.append("")

    # run_s reconciliation against the warm headline row, if present.
    if g("full") is not None and g("eval") is not None:
        pred = (TRAIN_STEPS * g("full") + EVAL_BATCHES * g("eval")) / 1e6
        lines.append(f"Reconstructed run_s from the ladder: "
                     f"{TRAIN_STEPS}×full + {EVAL_BATCHES}×eval = "
                     f"**{pred:.2f} s**.")
        if warm and warm.get("run_s"):
            got = warm["run_s"]
            lines.append(f"Measured warm `run_s` ({warm.get('cache')} row): "
                         f"**{got:.2f} s** — "
                         f"{'reconciles' if abs(pred - got) / got < 0.25 else 'DOES NOT reconcile'} "
                         f"({pred / got:,.2f}×); residual outside the step "
                         f"program: {got - pred:+.2f} s.")
        lines.append("")

    # The decision rules.
    verdicts = []
    win = delta("full", "full_pregather")
    if win is not None and g("full"):
        share = win / g("full")
        if share > 0.05:
            verdicts.append(
                f"**Flip to pregather**: the pregather step is "
                f"{share:.0%} faster ({win:,.1f} µs/step); confirm with "
                f"`bench.py --pregather` then make it the default and "
                f"re-warm in-window."
            )
        else:
            verdicts.append(
                f"Input path verdict: pregather wins only {share:.0%} "
                f"per step — keep the shipped per-step gather."
            )
    fb, fu = g("fwd_bwd"), g("full")
    if fb is not None and fu:
        if fb / fu > 0.8:
            verdicts.append(
                f"The step is {fb / fu:.0%} fwd+bwd compute: the floor is "
                f"compute/layout-bound at these conv shapes, not overhead "
                f"— see the per-op table ({'bench_r*_attr.json' if attr else 'trace pending'}) "
                f"for the conv1/conv2 split."
            )
        else:
            verdicts.append(
                f"fwd+bwd is only {fb / fu:.0%} of the full step — "
                f"{fu - fb:,.1f} µs/step rides input/optimizer/dropout; "
                f"see the attribution rows above."
            )
    if bf16 and bf16.get("full") and fu:
        verdicts.append(
            f"bf16 ladder: full {bf16['full']:,.1f} µs vs f32 {fu:,.1f} µs "
            f"({1 - bf16['full'] / fu:+.0%})."
        )
    for label, lad in (("im2col_c1", conv_c1), ("im2col", conv_all)):
        if lad and lad.get("full") and fu:
            win = 1 - lad["full"] / fu
            verdicts.append(
                f"conv ladder ({label}): full {lad['full']:,.1f} µs vs "
                f"native-conv {fu:,.1f} µs ({win:+.0%})"
                + (f"; fwd {lad['fwd']:,.1f} vs {g('fwd'):,.1f} µs"
                   if lad.get("fwd") and g("fwd") else "")
                + (" — flip `--conv-impl` after an end-to-end "
                   "`bench.py --conv-impl` row confirms" if win > 0.05
                   else " — keep the native conv.")
            )
    if b1000 and b1000.get("full") and fu and b1000.get("batch"):
        base_batch = ladder.get("batch") or 200
        ratio = b1000["full"] / fu
        scale = b1000["batch"] / base_batch
        if ratio < 0.4 * scale:
            verdicts.append(
                f"Batch-scaling: full at batch {b1000['batch']} is only "
                f"{ratio:.1f}x the batch-{base_batch} step "
                f"({scale:.0f}x the work) — the step is dominated by "
                f"per-op/latency overhead inside the scan body; fewer, "
                f"larger ops (or bigger per-step batches) are the lever "
                f"(ratio of min-promoted artifacts, both sides)."
            )
        else:
            verdicts.append(
                f"Batch-scaling: full scales {ratio:.1f}x for {scale:.0f}x "
                f"batch — the step is bandwidth/compute-bound at these "
                f"shapes, not overhead-bound (ratio of min-promoted "
                f"artifacts, both sides)."
            )
    if attr and attr.get("gap_share") is not None:
        verdicts.append(
            f"Trace: device busy {attr.get('busy_s')}s over "
            f"{attr.get('span_s')}s span — gap share "
            f"{attr['gap_share']:.0%}; top category: "
            f"{next(iter(attr.get('by_category') or {}), '?')}."
        )
    for v in verdicts:
        lines.append(f"- {v}")
    lines.append("")
    return "\n".join(lines)


def summarize_telemetry(directory: str) -> str | None:
    """Digest every ``*.jsonl`` event file in ``directory`` (obs/events
    schema) into an operator summary, or None when nothing parses."""
    import glob

    from ..obs.events import read_events
    from ..obs.registry import percentile

    files = sorted(glob.glob(os.path.join(directory, "*.jsonl")))
    events: list[dict] = []
    for path in files:
        events.extend(read_events(path))
    if not events:
        return None

    lines = [
        f"telemetry summary: {directory} "
        f"({len(events)} events, {len(files)} file(s), "
        f"{len({e.get('run_id') for e in events})} run(s))"
    ]
    steps = [e for e in events if e.get("event") == "step"]
    if steps:
        lats = sorted(e["latency_s"] for e in steps if "latency_s" in e)
        if lats:
            lines.append(
                f"  steps: {len(steps)}, "
                f"mean {1e3 * sum(lats) / len(lats):.2f} ms, "
                f"p50 {1e3 * percentile(lats, 50):.2f} ms, "
                f"p95 {1e3 * percentile(lats, 95):.2f} ms"
            )
        else:
            lines.append(f"  steps: {len(steps)} (no latency fields)")
        losses = [e["loss"] for e in steps if e.get("loss") is not None]
        if losses:
            lines.append(
                f"  loss: first {losses[0]:.6f}, last {losses[-1]:.6f}"
            )
    epochs = [e for e in events if e.get("event") == "epoch_train_end"]
    if epochs:
        last = epochs[-1]
        lines.append(
            f"  epochs: {len(epochs)}, last "
            f"{last.get('samples_per_s', 0.0):.1f} samples/s "
            f"({last.get('samples', 0)} samples in "
            f"{last.get('duration_s', 0.0):.2f} s)"
        )
    evals = [e for e in events if e.get("event") == "eval"]
    if evals:
        lines.append(
            f"  eval: {len(evals)} pass(es), final accuracy "
            f"{evals[-1].get('accuracy', 0.0):.4f} "
            f"(avg loss {evals[-1].get('avg_loss', 0.0):.4f})"
        )
    span_ends = [e for e in events if e.get("event") == "span_end"]
    if span_ends:
        by_span: dict[str, list[float]] = {}
        for e in span_ends:
            by_span.setdefault(e.get("span", "?"), []).append(
                e.get("duration_s", 0.0)
            )
        rendered = ", ".join(
            f"{name} x{len(ds)} ({sum(ds):.2f} s)"
            for name, ds in sorted(by_span.items())
        )
        lines.append(f"  spans: {rendered}")
    # Startup section (docs/COMPILE.md): per-program compile durations
    # (the compile service's spans), the measured overlap win, and the
    # serialized-executable store's hit/miss/fallback tallies — the
    # operator's view of what a cold vs warm start actually paid.
    compiles = [
        e for e in events
        if e.get("event") == "span_end" and e.get("span") == "compile"
    ]
    if compiles:
        by_fn: dict[str, list[float]] = {}
        for e in compiles:
            by_fn.setdefault(e.get("fn", "?"), []).append(
                e.get("duration_s", 0.0)
            )
        rendered = ", ".join(
            f"{fn} x{len(ds)} ({sum(ds):.2f} s)"
            for fn, ds in sorted(by_fn.items())
        )
        lines.append(f"  startup compiles: {rendered}")
    overlaps = [e for e in events if e.get("event") == "startup_overlap"]
    if overlaps:
        last = overlaps[-1]
        tasks = last.get("tasks") or {}
        rendered = ", ".join(
            f"{name} {dur:.2f} s" for name, dur in sorted(tasks.items())
        )
        lines.append(
            f"  startup overlap: ratio {last.get('overlap_ratio', 0.0):.2f} "
            f"(wall {last.get('wall_s', 0.0):.2f} s; {rendered})"
        )
    aots = [e for e in events if e.get("event") == "aot_executable"]
    if aots:
        counts: dict[str, int] = {}
        for e in aots:
            counts[e.get("outcome", "?")] = counts.get(e.get("outcome", "?"), 0) + 1
        lines.append(
            "  aot executables: "
            + ", ".join(
                f"{counts.get(k, 0)} {k}" for k in ("hit", "miss", "fallback")
            )
        )
    # Steady-state input pipeline (data/prefetch.py prefetch_epoch
    # events): the device_run_share-style split of consume wall into
    # data wait vs step time, per pipeline — the number the
    # double-buffered prefetch exists to drive toward zero.
    prefetches = [e for e in events if e.get("event") == "prefetch_epoch"]
    if prefetches:
        by_pipe: dict[str, list[dict]] = {}
        for e in prefetches:
            by_pipe.setdefault(e.get("pipeline", "?"), []).append(e)
        for pipe, evs in sorted(by_pipe.items()):
            batches = sum(e.get("batches", 0) for e in evs)
            wait = sum(e.get("wait_s_total", 0.0) for e in evs)
            wall = sum(e.get("consume_wall_s", 0.0) for e in evs)
            occ = (
                sum(e.get("occupancy_mean", 0.0) * e.get("batches", 0)
                    for e in evs) / batches
                if batches else 0.0
            )
            share = wait / wall if wall > 0 else 0.0
            lines.append(
                f"  steady state [{pipe}]: {batches} batches over "
                f"{len(evs)} epoch(s), data wait {wait:.3f} s of "
                f"{wall:.2f} s consume wall (wait share {share:.1%}, "
                f"step share {1 - share:.1%}), mean buffer occupancy "
                f"{occ:.2f} (depth {evs[-1].get('depth', '?')})"
            )
    # Training resilience (resilience/, docs/ROBUSTNESS.md trainer
    # section): anomalies by kind with the retry/abort split, checkpoint
    # cadence + write durations by reason, stalls, preemptions, resumes,
    # and input-pipeline retries — the operator's receipt of what the
    # run survived.
    anomalies = [e for e in events if e.get("event") == "train_anomaly"]
    checkpoints = [e for e in events if e.get("event") == "checkpoint"]
    ckpt_failures = [e for e in events if e.get("event") == "checkpoint_failed"]
    stalls = [e for e in events if e.get("event") == "train_stall"]
    resumes = [e for e in events if e.get("event") == "train_resume"]
    preempts = [e for e in events if e.get("event") == "preempt_exit"]
    data_retries = [e for e in events if e.get("event") == "data_retry"]
    if (anomalies or checkpoints or ckpt_failures or stalls or resumes
            or preempts or data_retries):
        lines.append(
            f"  training resilience: {len(anomalies)} anomaly(ies), "
            f"{len(checkpoints)} checkpoint(s), {len(stalls)} stall(s), "
            f"{len(resumes)} resume(s), {len(preempts)} preemption(s)"
        )
        if anomalies:
            by_kind: dict[str, int] = {}
            aborted = 0
            for e in anomalies:
                kind = e.get("kind", "?")
                by_kind[kind] = by_kind.get(kind, 0) + 1
                if e.get("action") == "abort":
                    aborted += 1
            lines.append(
                "    anomalies by kind: "
                + ", ".join(
                    f"{kind} x{n}" for kind, n in sorted(by_kind.items())
                )
                + (f"; {aborted} exhausted the retry budget (run aborted)"
                   if aborted else "; all healed by rollback+retry")
            )
        if checkpoints:
            by_reason: dict[str, list] = {}
            for e in checkpoints:
                by_reason.setdefault(e.get("reason", "?"), []).append(e)
            for reason, es in sorted(by_reason.items()):
                durs = [e.get("duration_s", 0.0) for e in es]
                steps = sorted(
                    e["steps_total"] for e in es if "steps_total" in e
                )
                gaps = [b - a for a, b in zip(steps, steps[1:])]
                cadence = (
                    f", cadence {sum(gaps) / len(gaps):.1f} step(s)"
                    if gaps else ""
                )
                lines.append(
                    f"    checkpoints [{reason}]: {len(es)}, mean write "
                    f"{1e3 * sum(durs) / len(durs):.1f} ms{cadence}"
                )
        if ckpt_failures:
            lines.append(
                f"    checkpoint failures (survived): {len(ckpt_failures)} "
                f"(last: {ckpt_failures[-1].get('error', '?')})"
            )
        if stalls:
            ages = [e.get("age_s", 0.0) for e in stalls]
            lines.append(
                f"    stalls: {len(stalls)}, max age {max(ages):.2f} s"
            )
        for e in resumes:
            lines.append(
                f"    resumed: epoch {e.get('epoch', '?')} at batch cursor "
                f"{e.get('batch_cursor', '?')} from {e.get('archive', '?')}"
            )
        for e in preempts:
            lines.append(
                f"    preempted: signal {e.get('signum', '?')} at epoch "
                f"{e.get('epoch', '?')} cursor {e.get('batch_cursor', '?')} "
                f"(exit {e.get('exit_code', '?')})"
            )
        if data_retries:
            by_pipe: dict[str, int] = {}
            for e in data_retries:
                pipe = e.get("pipeline", "?")
                by_pipe[pipe] = by_pipe.get(pipe, 0) + 1
            lines.append(
                "    data retries: "
                + ", ".join(
                    f"{pipe} x{n}" for pipe, n in sorted(by_pipe.items())
                )
            )
    # Distributed resilience (parallel/elastic.py launcher events +
    # parallel/distributed.py rendezvous events): rank deaths
    # by rank, gang restarts with time-to-recover, rendezvous attempt
    # statistics — the elastic runtime's survival receipt.
    rank_deaths = [e for e in events if e.get("event") == "rank_death"]
    gang_restarts = [e for e in events if e.get("event") == "gang_restart"]
    gang_exhausted = [e for e in events if e.get("event") == "gang_exhausted"]
    rdzv = [e for e in events if e.get("event") == "rendezvous"]
    rdzv_retries = [e for e in events if e.get("event") == "rendezvous_retry"]
    if rank_deaths or gang_restarts or gang_exhausted or rdzv or rdzv_retries:
        deaths_by_rank: dict[str, int] = {}
        for e in rank_deaths:
            key = str(e.get("rank", "?"))
            deaths_by_rank[key] = deaths_by_rank.get(key, 0) + 1
        attempts = [e.get("attempts", 1) for e in rdzv]
        mean_attempts = (
            sum(attempts) / len(attempts) if attempts else 0.0
        )
        recoveries = [
            e.get("downtime_s", 0.0) for e in gang_restarts
        ]
        mean_recover = (
            sum(recoveries) / len(recoveries) if recoveries else 0.0
        )
        lines.append(
            f"  distributed resilience: {len(rank_deaths)} rank death(s), "
            f"{len(gang_restarts)} gang restart(s), mean rendezvous "
            f"attempts {mean_attempts:.2f}, mean time-to-recover "
            f"{mean_recover:.2f} s"
        )
        if deaths_by_rank:
            lines.append(
                "    rank deaths: "
                + ", ".join(
                    f"rank {r} x{n} "
                    + "("
                    + "/".join(sorted({
                        e.get("reason", "?") for e in rank_deaths
                        if str(e.get("rank", "?")) == r
                    }))
                    + ")"
                    for r, n in sorted(deaths_by_rank.items())
                )
            )
        for e in gang_restarts:
            lines.append(
                f"    gang restart {e.get('attempt', '?')}: backoff "
                f"{e.get('backoff_s', 0.0):.2f} s, downtime "
                f"{e.get('downtime_s', 0.0):.2f} s (rank "
                f"{e.get('rank', '?')} {e.get('reason', '?')})"
            )
        if rdzv_retries:
            lines.append(
                f"    rendezvous retries: {len(rdzv_retries)} "
                f"(last: {rdzv_retries[-1].get('error', '?')})"
            )
        for e in gang_exhausted:
            lines.append(
                f"    gang EXHAUSTED after {e.get('attempts', '?')} "
                f"attempt(s) (budget {e.get('budget', '?')}, rank "
                f"{e.get('rank', '?')} {e.get('reason', '?')})"
            )
    # Serving pipeline telemetry (serving/batcher.py under --telemetry-dir):
    # per-request latency plus per-batch fill/stall — the operator's view
    # of how well the in-flight window is overlapping.
    sreqs = [e for e in events if e.get("event") == "serving_request"]
    if sreqs:
        lats = sorted(e["latency_s"] for e in sreqs if "latency_s" in e)
        if lats:
            lines.append(
                f"  serving: {len(sreqs)} requests, "
                f"p50 {1e3 * percentile(lats, 50):.2f} ms, "
                f"p95 {1e3 * percentile(lats, 95):.2f} ms, "
                f"p99 {1e3 * percentile(lats, 99):.2f} ms"
            )
        by_dtype: dict[str, list[float]] = {}
        for e in sreqs:
            if "latency_s" in e and e.get("dtype"):
                by_dtype.setdefault(e["dtype"], []).append(e["latency_s"])
        if len(by_dtype) > 1:  # per-variant split only when mixed traffic
            for name, ds in sorted(by_dtype.items()):
                ds.sort()
                lines.append(
                    f"    dtype {name}: {len(ds)} requests, "
                    f"p50 {1e3 * percentile(ds, 50):.2f} ms, "
                    f"p99 {1e3 * percentile(ds, 99):.2f} ms"
                )
    # Tail-latency section (serving/qos.py + the router's hedger,
    # docs/SERVING.md): per-QoS-class request percentiles, load-shed
    # counts, and the hedge dispatch/outcome tallies with win rate —
    # the operator's receipt of what the SLO-aware scheduler did.
    sheds = [e for e in events if e.get("event") == "qos_shed"]
    hedge_dispatches = [
        e for e in events if e.get("event") == "hedge_dispatch"
    ]
    hedge_outcomes = [e for e in events if e.get("event") == "hedge_outcome"]
    qos_tagged = any("qos" in e for e in sreqs)
    if qos_tagged or sheds or hedge_dispatches or hedge_outcomes:
        by_qos: dict[str, list[float]] = {}
        for e in sreqs:
            if "latency_s" in e:
                # Schema note (serving/batcher.py): the default class is
                # untagged so pre-QoS JSONL stays byte-stable.
                by_qos.setdefault(e.get("qos", "interactive"), []).append(
                    e["latency_s"]
                )
        shed_by_qos: dict[str, int] = {}
        for e in sheds:
            name = e.get("qos", "?")
            shed_by_qos[name] = shed_by_qos.get(name, 0) + 1
        lines.append(
            f"  tail latency: {sum(len(v) for v in by_qos.values())} "
            f"classed request(s), {len(sheds)} shed, "
            f"{len(hedge_dispatches)} hedge dispatch(es)"
        )
        for name, ds in sorted(by_qos.items()):
            ds.sort()
            lines.append(
                f"    qos {name}: {len(ds)} requests, "
                f"p50 {1e3 * percentile(ds, 50):.2f} ms, "
                f"p95 {1e3 * percentile(ds, 95):.2f} ms, "
                f"p99 {1e3 * percentile(ds, 99):.2f} ms"
                + (f", {shed_by_qos[name]} shed"
                   if shed_by_qos.get(name) else "")
            )
        for name in sorted(set(shed_by_qos) - set(by_qos)):
            lines.append(
                f"    qos {name}: 0 completed, {shed_by_qos[name]} shed"
            )
        if hedge_outcomes:
            tally: dict[str, int] = {}
            for e in hedge_outcomes:
                tally[e.get("outcome", "?")] = (
                    tally.get(e.get("outcome", "?"), 0) + 1
                )
            placed = tally.get("won", 0) + tally.get("lost", 0)
            lines.append(
                f"    hedges: {tally.get('won', 0)} won, "
                f"{tally.get('lost', 0)} lost, "
                f"{tally.get('cancelled', 0)} cancelled"
                + (f"; win rate {tally.get('won', 0) / placed:.1%}"
                   if placed else "")
            )
    # Scale-out telemetry (serving/pool.py + router.py): per-replica
    # request share, router decision tallies by policy, drain/re-add
    # durations, and the load-imbalance ratio (max/mean replica share) —
    # the operator's view of whether the router is actually spreading.
    # Grouped per run_id: the sweep recipe (serve_loadgen
    # --replicas-sweep) accumulates one run per rung in the same
    # directory, and a cross-run merge would read as imbalance (r0
    # serves in every rung, r3 only in the last) even when each rung's
    # router spread perfectly.
    share_runs: dict[object, dict[str, int]] = {}
    for e in sreqs:
        if e.get("replica"):
            tally = share_runs.setdefault(e.get("run_id"), {})
            tally[e["replica"]] = tally.get(e["replica"], 0) + 1
    # A starved replica served nothing, so it has no serving_request
    # events — but it is exactly the replica the imbalance ratio exists
    # to expose.  Count it as 0 if ANY event in the run names it (a
    # replica with no events at all is undiscoverable from JSONL).
    run_replicas: dict[object, set] = {}
    for e in events:
        if e.get("replica"):
            run_replicas.setdefault(e.get("run_id"), set()).add(e["replica"])
    for rid, by_replica in share_runs.items():
        for name in run_replicas.get(rid, ()):
            by_replica.setdefault(name, 0)
        total = sum(by_replica.values())
        mean = total / len(by_replica)
        imbalance = max(by_replica.values()) / mean if mean else 0.0
        shares = ", ".join(
            f"{name} {100.0 * n / total:.1f}% ({n})"
            for name, n in sorted(by_replica.items())
        )
        # run_id = wall-clock prefix + random hex; the TAIL is what
        # tells two runs in one directory apart.
        suffix = f" [run {str(rid)[-6:]}]" if len(share_runs) > 1 else ""
        lines.append(
            f"  scale-out: {len(by_replica)} replica(s), requests by "
            f"replica: {shares}; load imbalance (max/mean) "
            f"{imbalance:.2f}{suffix}"
        )
    decisions = [e for e in events if e.get("event") == "router_decision"]
    if decisions:
        decision_runs: dict[tuple, dict[str, int]] = {}
        for e in decisions:
            tally = decision_runs.setdefault(
                (e.get("run_id"), e.get("policy", "?")), {}
            )
            name = e.get("replica", "?")
            tally[name] = tally.get(name, 0) + 1
        multi = len({rid for rid, _ in decision_runs}) > 1
        for (rid, policy), tally in decision_runs.items():
            rendered = ", ".join(
                f"{name} {n}" for name, n in sorted(tally.items())
            )
            suffix = f" [run {str(rid)[-6:]}]" if multi else ""
            lines.append(
                f"  router decisions [{policy}]: {rendered}{suffix}"
            )
    # Sharded serving (serving/pool.py + engine.py): pool topology by
    # replica shard shape, request share per shape, the warmup parity
    # gates, EP expert-load imbalance, and the cost policy's decision
    # tallies by request shape class — the operator's view of whether
    # heterogeneous replicas (tp4 next to dp) are earning their devices.
    topologies = [e for e in events if e.get("event") == "pool_topology"]
    sharded_topos = [
        e for e in topologies
        if any(r.get("shard_kind", "dp") != "dp"
               for r in e.get("replicas", {}).values())
    ]
    multi_topo = len({e.get("run_id") for e in sharded_topos}) > 1
    for topo in sharded_topos:
        rid = topo.get("run_id")
        replicas = topo.get("replicas", {})
        shape_of = {
            name: f"{r.get('shard_kind', 'dp')}x{r.get('devices', 1)}"
            for name, r in replicas.items()
        }
        rendered = ", ".join(
            f"{name} {shape}" for name, shape in sorted(shape_of.items())
        )
        suffix = f" [run {str(rid)[-6:]}]" if multi_topo else ""
        lines.append(
            f"  sharded pool: {len(replicas)} replica(s) over "
            f"{sum(r.get('devices', 1) for r in replicas.values())} "
            f"device(s): {rendered}{suffix}"
        )
        # Request share folded by SHAPE, not by replica: a tp4 replica
        # holding 4 devices should be judged against the dp replicas'
        # combined share, and the per-replica line above already exists.
        by_replica = share_runs.get(rid, {})
        if by_replica:
            by_shape: dict[str, int] = {}
            for name, n in by_replica.items():
                by_shape[shape_of.get(name, "dpx1")] = (
                    by_shape.get(shape_of.get(name, "dpx1"), 0) + n
                )
            total = sum(by_shape.values())
            shares = ", ".join(
                f"{shape} {100.0 * n / total:.1f}% ({n})"
                for shape, n in sorted(by_shape.items())
            )
            lines.append(
                f"    requests by replica shape: {shares}{suffix}"
            )
    for e in events:
        if e.get("event") != "expert_load":
            continue
        loads = e.get("loads", {})
        imbalance = e.get("imbalance")
        rendered = ", ".join(
            f"e{k} {v:.0f}" for k, v in sorted(loads.items())
        )
        lines.append(
            "  expert load (final EP dispatch): " + rendered
            + (f"; imbalance (max/mean) {imbalance:.2f}"
               if imbalance is not None else "")
        )
    shaped = [
        e for e in decisions if e.get("shape_class")
    ]
    if shaped:
        shape_runs: dict[tuple, dict[str, int]] = {}
        for e in shaped:
            tally = shape_runs.setdefault(
                (e.get("run_id"), e.get("policy", "?")), {}
            )
            cls = e.get("shape_class", "?")
            tally[cls] = tally.get(cls, 0) + 1
        multi = len({rid for rid, _ in shape_runs}) > 1
        for (rid, policy), tally in shape_runs.items():
            rendered = ", ".join(
                f"{cls} {n}" for cls, n in sorted(
                    tally.items(),
                    key=lambda kv: int(kv[0][1:])
                    if kv[0][1:].isdigit() else 0,
                )
            )
            suffix = f" [run {str(rid)[-6:]}]" if multi else ""
            lines.append(
                f"  shape-class decisions [{policy}]: {rendered}{suffix}"
            )

    def _elastic_lines(kind: str, label: str) -> None:
        # Same per-run grouping as the share/decision lines above.
        ev_runs: dict[object, list] = {}
        for e in events:
            if e.get("event") == kind:
                ev_runs.setdefault(e.get("run_id"), []).append(e)
        for rid, es in ev_runs.items():
            rendered = ", ".join(
                f"{e.get('replica', '?')} {e.get('duration_s', 0.0):.3f} s"
                for e in es
            )
            suffix = f" [run {str(rid)[-6:]}]" if len(ev_runs) > 1 else ""
            lines.append(f"  {label}: {rendered}{suffix}")

    _elastic_lines("replica_drain", "replica drains")
    _elastic_lines("replica_add", "replica re-adds")
    # Resilience section (serving/faults.py + the pool supervisor,
    # docs/ROBUSTNESS.md): quarantines by reason, restarts per replica
    # with mean recovery time (quarantine -> routable again), circuit
    # open/half-open transitions, ejections, and the transparent-retry
    # tally — the operator's view of what the chaos (or production
    # faults) actually cost.
    quarantines = [e for e in events if e.get("event") == "replica_quarantine"]
    restarts = [
        e for e in events
        if e.get("event") == "replica_restart"
        and e.get("outcome") == "restarted"
    ]
    ejections = [e for e in events if e.get("event") == "replica_eject"]
    transitions = [e for e in events if e.get("event") == "circuit_transition"]
    retries = [e for e in events if e.get("event") == "request_retry"]
    if quarantines or restarts or ejections or transitions or retries:
        lines.append(
            f"  resilience: {len(quarantines)} quarantine(s), "
            f"{len(restarts)} restart(s), {len(ejections)} ejection(s), "
            f"{len(retries)} retry(ies)"
        )
        if restarts:
            by_replica: dict[str, int] = {}
            for e in restarts:
                name = e.get("replica", "?")
                by_replica[name] = by_replica.get(name, 0) + 1
            recoveries = [
                e["recovery_s"] for e in restarts if "recovery_s" in e
            ]
            rendered = ", ".join(
                f"{name} x{n}" for name, n in sorted(by_replica.items())
            )
            lines.append(
                f"    restarts by replica: {rendered}"
                + (f" (mean recovery "
                   f"{sum(recoveries) / len(recoveries):.3f} s)"
                   if recoveries else "")
            )
        if quarantines:
            by_reason: dict[str, int] = {}
            for e in quarantines:
                reason = e.get("reason", "?")
                by_reason[reason] = by_reason.get(reason, 0) + 1
            lines.append(
                "    quarantines by reason: "
                + ", ".join(
                    f"{reason} x{n}"
                    for reason, n in sorted(by_reason.items())
                )
            )
        if transitions:
            per_replica: dict[str, dict[str, int]] = {}
            for e in transitions:
                tally = per_replica.setdefault(e.get("replica", "?"), {})
                dst = e.get("dst", "?")
                tally[dst] = tally.get(dst, 0) + 1
            for name, tally in sorted(per_replica.items()):
                rendered = ", ".join(
                    f"->{dst} x{n}"
                    # Stable lifecycle order, not alphabetical: the
                    # open -> half-open -> closed story reads forward.
                    for dst in ("open", "half-open", "closed")
                    if (n := tally.get(dst))
                )
                lines.append(f"    circuit transitions [{name}]: {rendered}")
        for e in ejections:
            lines.append(
                f"    ejected: {e.get('replica', '?')} "
                f"({e.get('reason', '?')}, after {e.get('attempts', '?')} "
                "restart(s))"
            )
    # Fleet section (serving/fleet.py, docs/SERVING.md fleet tier):
    # per-backend placement share with the load-imbalance ratio, the
    # autoscaler's event timeline, and mean backend-replacement time
    # (incident -> serving again) — the operator's receipt of what the
    # fleet control plane did.  Grouped per run_id like the scale-out
    # lines: a sweep accumulates one run per rung in one directory.
    froutes = [e for e in events if e.get("event") == "fleet_route"]
    fdeaths = [e for e in events if e.get("event") == "backend_death"]
    freplaces = [e for e in events if e.get("event") == "backend_replace"]
    fejects = [e for e in events if e.get("event") == "backend_eject"]
    fdrains = [e for e in events if e.get("event") == "backend_drain"]
    fscales = [e for e in events if e.get("event") == "fleet_scale"]
    if froutes or fdeaths or freplaces or fscales or fdrains or fejects:
        lines.append(
            f"  fleet: {len(froutes)} placement(s), {len(fdeaths)} "
            f"backend death(s), {len(freplaces)} replacement(s), "
            f"{len(fscales)} scale event(s), {len(fdrains)} drain-down(s)"
        )
        fshare_runs: dict[object, dict[str, int]] = {}
        for e in froutes:
            tally = fshare_runs.setdefault(e.get("run_id"), {})
            name = e.get("backend", "?")
            tally[name] = tally.get(name, 0) + 1
        for rid, tally in fshare_runs.items():
            total = sum(tally.values())
            mean = total / len(tally)
            imbalance = max(tally.values()) / mean if mean else 0.0
            shares = ", ".join(
                f"{name} {100.0 * n / total:.1f}% ({n})"
                for name, n in sorted(tally.items())
            )
            suffix = (
                f" [run {str(rid)[-6:]}]" if len(fshare_runs) > 1 else ""
            )
            lines.append(
                f"    backend share: {shares}; imbalance (max/mean) "
                f"{imbalance:.2f}{suffix}"
            )
        if freplaces:
            downs = [e.get("downtime_s", 0.0) for e in freplaces]
            by_backend: dict[str, int] = {}
            for e in freplaces:
                name = e.get("backend", "?")
                by_backend[name] = by_backend.get(name, 0) + 1
            lines.append(
                "    replacements: "
                + ", ".join(
                    f"{name} x{n}" for name, n in sorted(by_backend.items())
                )
                + f" (mean replacement {sum(downs) / len(downs):.2f} s)"
            )
        if fscales:
            # Timeline relative to each run's first event, so the
            # up/down story reads in run seconds, not epoch ts.
            run_t0: dict[object, float] = {}
            for e in events:
                rid = e.get("run_id")
                ts = e.get("ts")
                if ts is None:
                    continue
                if rid not in run_t0 or ts < run_t0[rid]:
                    run_t0[rid] = ts
            for e in fscales:
                rel = e.get("ts", 0.0) - run_t0.get(e.get("run_id"), 0.0)
                lines.append(
                    f"    scale {e.get('direction', '?')} at +{rel:.1f}s: "
                    f"{e.get('backends', '?')} backend(s), "
                    f"{e.get('kind', 'depth')} signal "
                    f"{e.get('signal', 0.0):.2f}"
                )
        for e in fejects:
            lines.append(
                f"    ejected: {e.get('backend', '?')} "
                f"({e.get('reason', '?')}, after {e.get('attempts', '?')} "
                "attempt(s))"
            )
    # Host path section (serving/wire.py + serving/cache.py,
    # docs/SERVING.md): the response cache's served-from-cache tally by
    # tier (admission point vs fleet front), invalidations, and any
    # wire_fallback breadcrumbs — a client that THINKS it speaks binary
    # but typo'd the content type shows up here, not as a silent
    # latency regression.
    chits = [e for e in events if e.get("event") == "cache_hit"]
    cinvs = [e for e in events if e.get("event") == "cache_invalidate"]
    wfalls = [e for e in events if e.get("event") == "wire_fallback"]
    if chits or cinvs or wfalls:
        by_scope: dict[str, int] = {}
        for e in chits:
            scope = e.get("scope", "server")
            by_scope[scope] = by_scope.get(scope, 0) + 1
        scopes = ", ".join(
            f"{n} at the {scope}"
            for scope, n in sorted(by_scope.items())
        ) or "0"
        lines.append(
            f"  host path: {len(chits)} cache hit(s) ({scopes}), "
            f"{len(cinvs)} invalidation(s), {len(wfalls)} wire "
            "fallback(s)"
        )
        if wfalls:
            types: dict[str, int] = {}
            for e in wfalls:
                ct = e.get("content_type", "?")
                types[ct] = types.get(ct, 0) + 1
            lines.append(
                "    fallback content types: "
                + ", ".join(
                    f"{ct} x{n}" for ct, n in sorted(types.items())
                )
            )
    gates = [e for e in events if e.get("event") == "parity_gate"]
    if gates:
        for e in gates:
            # Sharded warmup gates (engine.verify_sharded_parity) carry
            # the replica's shard shape next to the dtype variant label.
            label = str(e.get("dtype", "?"))
            if e.get("shard_kind") and e.get("shard_kind") != "dp":
                label += f" {e['shard_kind']}x{e.get('devices', '?')}"
            lines.append(
                f"  parity gate [{label}]: "
                + ("PASS" if e.get("passed") else "FAIL")
                + f" (max|dlogit| {e.get('max_abs_logit_diff', 0.0):.2e}"
                f" <= {e.get('tolerance', 0.0):g}, argmax_identical="
                f"{e.get('argmax_identical')})"
            )
    sbatches = [e for e in events if e.get("event") == "serving_batch"]
    if sbatches:
        fills = [e["fill_ratio"] for e in sbatches if "fill_ratio" in e]
        stalls = [e.get("stall_s", 0.0) for e in sbatches]
        stalled = [s for s in stalls if s > 0]
        lines.append(
            f"  serving batches: {len(sbatches)}, mean fill "
            f"{100.0 * sum(fills) / len(fills):.1f}%, "
            f"{len(stalled)} stalled dispatches "
            f"({sum(stalls):.3f} s total stall)"
            if fills else
            f"  serving batches: {len(sbatches)}"
        )
    # Device path section (docs/SERVING.md packed batching): the
    # packed-vs-bucketed split of what the DEVICE was fed.  Packed
    # dispatches are tagged on the serving_batch event; fill here is
    # live rows over the rows-capacity the device computed, and the
    # warmup-executable tally per mode comes from the compile spans of
    # the runs that produced each mode's batches — the two numbers the
    # packed ladder collapse exists to move (fill up, executables down).
    packed_batches = [e for e in sbatches if e.get("packed")]
    if packed_batches:
        def _mode_line(label, evs):
            fills = [e["fill_ratio"] for e in evs if "fill_ratio" in e]
            pad = sum(
                e["bucket"] - e["real"] for e in evs
                if "bucket" in e and "real" in e
            )
            caps = sorted({e["bucket"] for e in evs if e.get("bucket")})
            rids = {e.get("run_id") for e in evs}
            execs = sum(
                1 for e in events
                if e.get("event") == "span_end"
                and e.get("span") == "compile"
                and e.get("run_id") in rids
            )
            return (
                f"    {label}: {len(evs)} dispatch(es), mean fill "
                f"{100.0 * sum(fills) / len(fills):.1f}%, "
                f"{pad} padding row(s), "
                f"capacities {'/'.join(str(c) for c in caps) or '?'}"
                + (f", {execs} warmup executable(s)" if execs else "")
            )

        bucketed_batches = [e for e in sbatches if not e.get("packed")]
        lines.append(
            f"  device path: {len(packed_batches)} packed of "
            f"{len(sbatches)} dispatch(es)"
        )
        lines.append(_mode_line("packed", packed_batches))
        if bucketed_batches:
            lines.append(_mode_line("bucketed", bucketed_batches))
    runs = [e for e in events if e.get("event") == "run_complete"]
    if runs:
        # Correctly-labeled seconds — the telemetry surface does NOT
        # inherit the stdout line's "ms" label quirk (utils/logging.py).
        lines.append(
            f"  run wall: {runs[-1].get('wall_seconds', 0.0):.2f} s"
        )
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m pytorch_mnist_ddp_tpu_torch.tools.perf_report")
    p.add_argument("--no-write", action="store_true")
    p.add_argument(
        "--telemetry", metavar="DIR", default=None,
        help="summarize a --telemetry-dir JSONL directory (stdout only)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.telemetry:
        summary = summarize_telemetry(args.telemetry)
        if summary is None:
            print(
                f"perf_report: no parseable *.jsonl events in "
                f"{args.telemetry}", file=sys.stderr,
            )
            return 1
        print(summary)
        return 0
    report = build_report()
    if report is None:
        print("perf_report: no ladder artifact (bench_r*_stepattr.json) "
              "yet", file=sys.stderr)
        return 1
    print(report)
    if not args.no_write:
        with open(os.path.join(ARTIFACT_DIR, "PERF.md"), "a") as f:
            f.write("\n" + report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
