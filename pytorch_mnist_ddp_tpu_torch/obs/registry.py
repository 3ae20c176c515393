"""Named metrics registry: counters, gauges, reservoir histograms, and
their Prometheus text rendering.

Standard library only, so the HTTP handler threads can scrape it without
touching the device.  Every metric is named, optionally labeled, and
thread-safe under one registry-wide lock, so a scrape is a consistent
cut.  A *family* is one metric name with one type and one label-key set;
re-registering a name with a conflicting type or label keys raises.

All percentiles go through :func:`percentile` (linear interpolation,
the numpy default), so a p99 means the same thing on every surface.
"""

from __future__ import annotations

import threading
from collections import deque


def percentile(sorted_values: list[float], q: float) -> float:
    """Linear-interpolation percentile over an ascending-sorted list.

    ``q`` is in [0, 100].  Empty input returns 0.0 (metrics surfaces
    render before the first observation).
    """
    if not sorted_values:
        return 0.0
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile out of range: {q}")
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = (q / 100.0) * (len(sorted_values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


class Counter:
    """Monotonically increasing count."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """A value that goes up and down (queue depth, in-flight batches)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Reservoir histogram: the newest ``reservoir`` observations plus
    lifetime count/sum (Prometheus summary semantics)."""

    def __init__(self, lock: threading.RLock, reservoir: int = 8192):
        self._lock = lock
        self._window: deque[float] = deque(maxlen=reservoir)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._window.append(float(v))
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def values(self) -> list[float]:
        """Snapshot of the current window (insertion order)."""
        with self._lock:
            return list(self._window)


_TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}
_NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


class _Family:
    def __init__(self, name: str, cls, help: str, label_keys: tuple[str, ...]):
        self.name = name
        self.cls = cls
        self.help = help
        self.label_keys = label_keys
        self.children: dict[tuple[str, ...], object] = {}


class Registry:
    """Thread-safe named metric store; ``counter``/``gauge``/``histogram``
    are get-or-create."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def locked(self):
        """The registry-wide (reentrant) lock, for consistent multi-metric
        reads."""
        return self._lock

    def counter(self, name: str, help: str = "", **labels: object) -> Counter:
        return self._child(name, Counter, help, labels)

    def gauge(self, name: str, help: str = "", **labels: object) -> Gauge:
        return self._child(name, Gauge, help, labels)

    def histogram(
        self, name: str, help: str = "", reservoir: int = 8192, **labels: object
    ) -> Histogram:
        return self._child(name, Histogram, help, labels, reservoir=reservoir)

    def _child(self, name, cls, help, labels, **metric_kwargs):
        if not name or not set(name) <= _NAME_OK or name[0].isdigit():
            raise ValueError(f"invalid metric name {name!r}")
        label_keys = tuple(sorted(labels))
        label_values = tuple(str(labels[k]) for k in label_keys)
        with self._lock:
            family = self._families.get(name)
            if family is None:
                family = _Family(name, cls, help, label_keys)
                self._families[name] = family
            elif family.cls is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{_TYPES[family.cls]}, not {_TYPES[cls]}"
                )
            elif family.label_keys != label_keys:
                raise ValueError(
                    f"metric {name!r} registered with labels "
                    f"{list(family.label_keys)}, got {list(label_keys)}"
                )
            child = family.children.get(label_values)
            if child is None:
                child = cls(self._lock, **metric_kwargs)
                family.children[label_values] = child
            return child

    def collect(self):
        """``[(name, type_str, help, [(labels_dict, metric), ...]), ...]``
        sorted by name."""
        with self._lock:
            out = []
            for name in sorted(self._families):
                family = self._families[name]
                children = [
                    (dict(zip(family.label_keys, values)), metric)
                    for values, metric in sorted(family.children.items())
                ]
                out.append((name, _TYPES[family.cls], family.help, children))
            return out


# -- Prometheus text exposition (format 0.0.4) --------------------------------
#
# Counters and gauges render directly; reservoir histograms render as
# summaries (quantile samples plus lifetime _sum/_count), because quantiles
# over the recent window are what the reservoir holds.

_QUANTILES = (("0.5", 50.0), ("0.95", 95.0), ("0.99", 99.0))


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: dict[str, str], extra: tuple[str, str] | None = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items) + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def render_prometheus(registry: Registry) -> str:
    """The full exposition document (trailing newline included), rendered
    under the registry lock so one scrape is a consistent cut."""
    lines: list[str] = []
    with registry.locked():
        for name, type_str, help_text, children in registry.collect():
            if help_text:
                escaped = help_text.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {name} {escaped}")
            kind = "summary" if type_str == "histogram" else type_str
            lines.append(f"# TYPE {name} {kind}")
            for labels, metric in children:
                if type_str != "histogram":
                    lines.append(
                        f"{name}{_labels_str(labels)} {_fmt_value(metric.value)}"
                    )
                    continue
                window = sorted(metric.values())
                for q_label, q in _QUANTILES:
                    lines.append(
                        f"{name}{_labels_str(labels, ('quantile', q_label))} "
                        f"{_fmt_value(percentile(window, q))}"
                    )
                lines.append(f"{name}_sum{_labels_str(labels)} {_fmt_value(metric.sum)}")
                lines.append(
                    f"{name}_count{_labels_str(labels)} {_fmt_value(metric.count)}"
                )
    return "\n".join(lines) + "\n"
