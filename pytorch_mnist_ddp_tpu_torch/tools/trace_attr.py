#!/usr/bin/env python
"""Distill a torch.profiler Chrome trace into a per-op attribution JSON
(the JAX package's ``tools/trace_attr.py`` over the port's traces):
``python -m pytorch_mnist_ddp_tpu_torch.tools.trace_attr TRACE [--out
attr.json] [--top N]``.

``TRACE`` is a ``*.pt.trace.json`` file (gzip too), or a directory holding
some (``--profile DIR`` of the training CLIs, ``utils/profiling.trace``;
the newest wins).  The output is small enough to keep: total device-busy
time, the idle-gap share, and a per-category, per-op table.

- **Lines.** A line is one device: the complete events on its CUDA
  streams whose ``cat`` is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``.
  The streams are one timeline, as a TPU core's ops are: a replayed CUDA
  graph runs its kernels on several streams that CUDA picks, and cuDNN
  runs some on streams of its own (``thread`` names them).  Host
  threads (``cpu_op``, ``cuda_runtime``, ...) are ignored, as JAX ignores
  its host threads.
  The ``gpu_user_annotation`` spans that the profiler projects onto the
  streams (``record_function`` ranges, profiler steps) make a line of
  their own, the counterpart of a TPU trace's "Steps" line: eligible as
  the main line only when no device ran an op.
- **Self time.** The JAX tool's stack walk, unchanged, over each stream
  alone: a nested event is charged only the time its children leave
  uncovered, and an overlapping non-nested event splits its charge
  across its ancestors.  Kernels of one stream run one after another, so
  there self time is each kernel's duration.  ``busy_s`` is the time the
  device was busy, the union over its streams; ``kernel_s`` is the ops'
  self times summed, and ``concurrent_s`` the part of it that ran while
  another stream of the device was busy too (cuDNN's FFT convolution
  runs its transforms beside a GEMM), with ``concurrent_events`` the
  events that did.  ``share_of_busy`` is a share of ``kernel_s``, which
  on one stream is ``busy_s``.
- **The main line** is the busiest; the others are reported under
  ``other_op_lines`` and not summed.
- **Categories.** JAX's nine, plus ``other``, first match wins; each
  pattern also takes the CUDA names that mean the same thing (cuDNN's
  convolutions, its FFT convolution's transforms among them; cuBLAS's and
  CUTLASS's GEMMs with their scaling and split-K passes; NCCL's
  collectives; copies and memsets; torch's elementwise, reduction and
  pooling kernels, max pooling's backward a scatter as XLA's
  select-and-scatter).  The port's
  own kernels land where the XLA ops they replace land: ``adadelta``
  (an elementwise update) with the elementwise fusions, ``int8_head``
  and ``flash`` (matmul-led) with the matmuls.

Prints the JSON to stdout (and writes ``--out`` if given).  Exit 1 with an
error JSON when no trace file or no device op events are found: a trace
taken on the CPU has no device line.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict

# Category heuristics over kernel names, first match wins.  JAX's
# patterns, each followed by the CUDA names of the same kind of work.
_CATEGORIES = (
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|winograd|fft|flip_filter")),
    ("matmul", re.compile(r"\bdot|dot_general|matmul|gemm|einsum"
                          r"|gemv|sm90_xmma|cutlass|scal_kernel|splitkreduce"
                          r"|int8_head|flash_kernel|flash_wide_kernel")),
    ("rng", re.compile(r"rng|threefry|philox|erf_inv|random"
                       r"|dropout|bernoulli|curand|distribution")),
    ("collective", re.compile(
        r"all-reduce|all_reduce|all-gather|all_gather|reduce-scatter"
        r"|reduce_scatter|collective|permute|all-to-all|all_to_all"
        r"|nccl")),
    ("gather_scatter", re.compile(r"gather|scatter|dynamic-slice|dynamic_slice"
                                  r"|dynamic-update|dynamic_update"
                                  r"|indexselect|index_select|index_elementwise"
                                  r"|index_put|index_copy|max_pool_backward")),
    ("copy_layout", re.compile(r"copy|transpose|bitcast|reshape|broadcast"
                               r"|convert|slice|concatenate|pad"
                               r"|memcpy|memset|nchwtonhwc|nhwctonchw")),
    ("reduce", re.compile(r"reduce|argmax|argmin|sort|top-k|topk"
                          r"|softmax|pool")),
    ("infeed_outfeed", re.compile(r"infeed|outfeed|send|recv|transfer")),
    ("elementwise_fusion", re.compile(r"fusion|add|multiply|subtract|divide"
                                      r"|maximum|minimum|exp|log|tanh|select"
                                      r"|compare|map"
                                      r"|elementwise|epilogue|adadelta")),
)

# The trace categories of device work on a stream, and of the annotation
# spans the profiler projects onto one.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_CAT = "gpu_user_annotation"


def _categorize(name: str) -> str:
    low = name.lower()
    for cat, pat in _CATEGORIES:
        if pat.search(low):
            return cat
    return "other"


def _load_trace(trace_dir: str) -> dict:
    if os.path.isfile(trace_dir):
        candidates = [trace_dir]
    else:
        candidates = (
            glob.glob(os.path.join(trace_dir, "*.trace.json"))
            + glob.glob(os.path.join(trace_dir, "*.trace.json.gz"))
            + glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.trace.json*"))
        )
        candidates.sort(key=lambda p: (os.path.getmtime(p), p))
    if not candidates:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {trace_dir}")
    path = candidates[-1]  # latest capture wins
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return json.load(f)


def attribute(trace_dir: str, top: int = 25) -> dict:
    data = _load_trace(trace_dir)
    events = data.get("traceEvents", [])
    proc_names: dict = {}
    proc_labels: dict = {}
    thread_names: dict = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            proc_names[e["pid"]] = e["args"]["name"]
        elif e.get("name") == "process_labels":
            proc_labels[e["pid"]] = e["args"]["labels"]
        elif e.get("name") == "thread_name":
            thread_names[(e["pid"], e.get("tid"))] = e["args"]["name"].strip()

    def process_of(pid) -> str:
        return proc_labels.get(pid) or proc_names.get(pid, "?")

    def thread_of(key) -> str:
        tids = sorted(streams[key], key=lambda t: (isinstance(t, str), t))
        names = [thread_names.get((key[0], tid), f"stream {tid}") for tid in tids]
        if len(names) > 1:
            names = ["streams " + ", ".join(n.removeprefix("stream ") for n in names)]
        return names[0] if key[1] == "ops" else f"{names[0]} annotations"

    # Pass 1: collect the device op events of every device's streams, and
    # apart the annotation spans on them.
    raw: dict[tuple, dict] = defaultdict(lambda: defaultdict(list))
    streams: dict[tuple, set] = defaultdict(set)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            kind = "ops"
        elif cat == ANNOTATION_CAT:
            kind = "steps"
        else:
            continue
        key = (e.get("pid"), kind)
        streams[key].add(e.get("tid"))
        raw[key][e.get("tid")].append(
            (float(e.get("ts", 0.0)), float(e.get("dur", 0.0)), e.get("name", "?")))
    if not any(key[1] == "ops" for key in raw):
        raise ValueError("no device op events (kernel, gpu_memcpy, gpu_memset) "
                         "found in trace")

    # Pass 2: per-line self-time attribution, each op charged on its own
    # stream; a line's busy time is the union over its streams.
    per_thread: dict[tuple, dict] = {}
    for key, by_stream in raw.items():
        rec = {"busy": 0.0, "kernel": 0.0, "concurrent": 0.0, "n": 0, "overlap": 0,
               "concurrent_events": 0, "ops": defaultdict(lambda: [0.0, 0])}
        for evs in by_stream.values():
            _walk(evs, rec)
            rec["concurrent"] += _union_us(evs)
        merged = [(ts, dur, tid) for tid, evs in by_stream.items() for ts, dur, _ in evs]
        rec["busy"] = _union_us(merged)
        rec["concurrent"] -= rec["busy"]
        rec["concurrent_events"] = _concurrent_events(merged)
        rec["t0"] = min(ts for ts, _, _ in merged)
        rec["t1"] = max(ts + dur for ts, dur, _ in merged)
        per_thread[key] = rec

    # The busiest device is the timeline; other lines are reported but not
    # summed.  An annotation line spans whole steps, so it would win on
    # busy time; it is eligible only when no device ran an op.
    def _rank(k):
        return (0 if k[1] == "steps" else 1, per_thread[k]["busy"])

    main_key = max(per_thread, key=_rank)
    main = per_thread[main_key]
    span_us = main["t1"] - main["t0"]
    busy_us = main["busy"]
    kernel_us = main["kernel"]

    by_cat: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for op, (dur, n) in main["ops"].items():
        c = by_cat[_categorize(op)]
        c[0] += dur
        c[1] += n
    top_ops = sorted(main["ops"].items(), key=lambda kv: -kv[1][0])[:top]

    return {
        "metric": "trace_attribution",
        "process": process_of(main_key[0]),
        "thread": thread_of(main_key),
        "op_events": main["n"],
        # Non-nested overlapping events seen within one stream of the main
        # line; their spans were redistributed across ancestors during the
        # self-time walk; nonzero flags that per-op attribution is
        # approximate.
        "overlap_events": int(main["overlap"]),
        "span_s": round(span_us / 1e6, 6),
        "busy_s": round(busy_us / 1e6, 6),
        "gap_share": round(1.0 - busy_us / span_us, 3) if span_us else None,
        # The ops' self times summed over the streams (busy_s on one
        # stream), the part of it that ran beside another stream's work,
        # and the events that did.
        "kernel_s": round(kernel_us / 1e6, 6),
        "concurrent_s": round(main["concurrent"] / 1e6, 6),
        "concurrent_share": round(main["concurrent"] / kernel_us, 3) if kernel_us else None,
        "concurrent_events": main["concurrent_events"],
        "by_category": {
            cat: {"time_s": round(d / 1e6, 9), "count": n,
                  "share_of_busy": round(d / kernel_us, 3) if kernel_us else None}
            for cat, (d, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0])
        },
        "top_ops": [
            {"op": op, "time_s": round(d / 1e6, 9), "count": n,
             "share_of_busy": round(d / kernel_us, 3) if kernel_us else None}
            for op, (d, n) in top_ops
        ],
        "other_op_lines": {
            f"{process_of(k[0])}:{thread_of(k)}": round(v["busy"] / 1e6, 6)
            for k, v in per_thread.items() if k != main_key
        },
    }


def _walk(evs: list, rec: dict) -> None:
    """The JAX tool's self-time walk over one stream's ``(ts, dur, name)``
    events, adding to ``rec``'s per-op table, ``kernel``, ``n`` and
    ``overlap``.  Complete events on one line can nest; naive summing
    double-counts the wrapper.  The walk charges each op only the time not
    covered by its children; on a flat line this degrades to self == dur."""
    evs.sort(key=lambda t: (t[0], -t[1]))
    rec["n"] += len(evs)
    stack: list[list] = []  # [end_ts, op, child_time_us, start_ts]

    def _pop(entry):
        end, op, child, start = entry
        self_us = max(end - start - child, 0.0)
        rec["kernel"] += self_us
        slot = rec["ops"][op]
        slot[0] += self_us
        slot[1] += 1
        if stack:
            # Charge this event's span to its ancestors' child-time.
            # Nested events charge the immediate parent in full; an
            # overlapping non-nested event (end outruns the parent's)
            # is split: the in-parent slice to the parent, the
            # overflow to whichever ancestor spans it, so neither the
            # parent's self-time is zeroed nor the overflow
            # double-counted at the grandparent.
            seg_start, overflowed = start, False
            for frame in reversed(stack):
                contrib = min(end, frame[0]) - seg_start
                if contrib > 0:
                    frame[2] += contrib
                if end <= frame[0]:
                    break
                overflowed = True
                seg_start = max(seg_start, frame[0])
            if overflowed:
                rec["overlap"] += 1
    for ts, dur, op in evs:
        while stack and stack[-1][0] <= ts:
            _pop(stack.pop())
        stack.append([ts + dur, op, 0.0, ts])
    while stack:
        _pop(stack.pop())


def _union_us(evs: list) -> float:
    """The time that ``(ts, dur, ...)`` events cover, counted once."""
    total, end = 0.0, float("-inf")
    for ts, dur, *_ in sorted(evs, key=lambda t: t[:2]):
        total += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return total


def _concurrent_events(evs: list) -> int:
    """How many of the ``(ts, dur, stream)`` events overlap an event of
    another stream, nested in it or not."""
    marked: set[int] = set()
    active: list[tuple] = []  # (end, stream, index) of events still running
    for i, (ts, dur, tid) in enumerate(sorted(evs, key=lambda t: t[:2])):
        active = [a for a in active if a[0] > ts]
        others = [a[2] for a in active if a[1] != tid]
        if others and dur > 0:
            marked.add(i)
            marked.update(others)
        active.append((ts + dur, tid, i))
    return len(marked)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m pytorch_mnist_ddp_tpu_torch.tools.trace_attr")
    p.add_argument("trace_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--top", type=int, default=25)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        result = attribute(args.trace_dir, args.top)
    except (OSError, ValueError, KeyError) as e:
        result = {"metric": "trace_attribution", "error": repr(e)}
        print(json.dumps(result))
        return 1
    out = json.dumps(result, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
