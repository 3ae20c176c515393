#!/usr/bin/env python
"""Promotion rules for recorded measurement artifacts (the JAX package's
``tools/window_promote.py``):
``python -m pytorch_mnist_ddp_tpu_torch.tools.window_promote {value|rungs}
SRC.json DST.json``.

A run's throughput varies from run to run, so a recorded artifact is never
latest-wins:

- ``value``: copy SRC over DST only if SRC's ``"value"`` beats (is lower
  than) DST's: the rule for a benchmark row.  The ``.err`` sidecar travels
  with its JSON.  A SRC without a numeric value (a structured-failure row,
  or bytes that do not parse) is NEVER promoted, not even onto an absent
  DST: promoted artifacts hold measurements only.
- ``rungs``: copy SRC over DST only if SRC carries at least as many
  measured ladder rungs: the rule for the step ladder that
  ``tools/perf_report.py`` reads, and for its batch-scaling ``_b1000``
  ladder, so both sides of the report's batch-scaling ratio are minima
  across runs.  Rungs are counted against the known rung-name set
  (``tools/step_attr_bench.py`` ``RUNG_NAMES``; numeric values only, a
  failed rung records None), so a top-level float metadata key can never
  inflate a truncated partial's count and let it clobber a more complete
  ladder, while the FIRST partial still lands.  Ties break toward the
  lower ``full`` rung.

Prints the outcome; exit 0 whether or not it promotes, 2 on bad usage.
Outcome strings, the bytes left at DST and the exit codes are the JAX
tool's.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

from .step_attr_bench import RUNG_NAMES


def _load(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def promote_value(src: str, dst: str) -> str:
    """Min-by-``value`` promotion; returns a human-readable outcome."""
    src_row = _load(src)
    new = src_row.get("value") if isinstance(src_row, dict) else None
    if not isinstance(new, (int, float)):
        return f"kept incumbent (new run has no value: {src})"
    dst_row = _load(dst)
    old = dst_row.get("value") if isinstance(dst_row, dict) else None
    if isinstance(old, (int, float)) and old <= new:
        return f"kept {old} (new run {new} is slower)"
    shutil.copy(src, dst)
    err = src[: -len(".json")] + ".err" if src.endswith(".json") else None
    if err and os.path.exists(err) and dst.endswith(".json"):
        shutil.copy(err, dst[: -len(".json")] + ".err")
    return f"promoted {new} (previous {old})"


def count_rungs(row: dict | None) -> int:
    """Measured-rung count of a ladder artifact: keys of ``RUNG_NAMES``
    holding a numeric measurement (a failed rung's None is not one);
    -1 for no artifact."""
    if not isinstance(row, dict):
        return -1
    return sum(
        1 for k, v in row.items()
        if k in RUNG_NAMES
        and isinstance(v, (int, float)) and not isinstance(v, bool)
    )


def promote_rungs(src: str, dst: str) -> str:
    """Most-measured-rungs promotion, ties toward the lower ``full``
    rung (a complete slow ladder must not clobber a complete fast one);
    returns a human-readable outcome."""
    src_row, dst_row = _load(src), _load(dst)
    n_src, n_dst = count_rungs(src_row), count_rungs(dst_row)
    if n_src <= 0 or n_src < n_dst:
        return f"stepattr kept incumbent ({n_dst} rungs vs new {n_src})"
    if n_src == n_dst:
        old = dst_row.get("full") if isinstance(dst_row, dict) else None
        new = src_row.get("full") if isinstance(src_row, dict) else None
        if (isinstance(old, (int, float)) and
                not (isinstance(new, (int, float)) and new < old)):
            return (f"stepattr kept incumbent (tie at {n_dst} rungs, "
                    f"full {old} <= {new})")
    shutil.copy(src, dst)
    return f"stepattr promoted ({n_src} rungs over {n_dst})"


def main(argv: list[str] | None = None) -> int:
    """``argv`` without the program name (``sys.argv[1:]`` by default)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] not in ("value", "rungs"):
        print("usage: python -m pytorch_mnist_ddp_tpu_torch.tools.window_promote "
              "{value|rungs} SRC.json DST.json", file=sys.stderr)
        return 2
    fn = promote_value if argv[0] == "value" else promote_rungs
    print(fn(argv[1], argv[2]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
