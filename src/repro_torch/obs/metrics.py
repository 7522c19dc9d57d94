"""Process-global metrics registry: counters, gauges, histograms (port of
``repro.obs.metrics``; pure Python, no torch).

One registry for the serving stack's signals: plan-selection counts keyed
(variant, backend, bucket, source), quantized-GEMM routes and kernel
declines, serve retrace / lane-width counters, the scheduler's queue depth
and admissions, the prefix cache's events, the occupancy gauge, the TTFT /
decode-step-latency histograms and the MoE dispatch's tokens per expert.
Everything lands in one place that can be snapshotted (:func:`snapshot` →
JSON), scraped (:func:`prometheus_text` → Prometheus exposition format) and
regressed.  Metric names, label names and both export formats are the
reference's, so a snapshot of either package reads the same.

Contract — **zero overhead when disabled, host-side only**:

  * Every instrument mutation (``inc`` / ``set`` / ``observe``) checks one
    module-level boolean *before* touching any lock or dict.  With metrics
    disabled (the default) an instrumented call site costs a function call
    and a flag test — no dict churn, no allocation, no lock.
  * Instruments are only ever called from host Python with host values
    (plan selection, the serve engine's step loop).  Nothing here reads a
    device tensor: a host read (``.item()``, ``.cpu()``) inside a step would
    add a sync and break a CUDA graph's capture.  Enabling or disabling
    metrics therefore cannot move a bit of any computed output.
  * The one device-fed signal, the MoE dispatch histogram, is accumulated
    by the step itself in persistent device tensors (capturable, so a
    decode graph's replays count) and folded into the host instruments by a
    **collector** (:func:`add_collector`) that :func:`snapshot`,
    :func:`prometheus_text`, :func:`collect` and :func:`reset` run first —
    the only place a device value reaches the registry.

Instruments register lazily at module import of the instrumented code
(idempotent: re-registering the same name with the same kind/labels returns
the existing instrument; a conflicting re-registration raises).  Label
values are positional, matching the declared label names, and are
stringified.  All mutation is thread-safe (one registry lock) — the serve
engine and background threads may hit the same counter concurrently.
"""
from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["enable", "disable", "enabled", "counter", "gauge", "histogram",
           "get", "snapshot", "prometheus_text", "reset", "write_snapshot",
           "collect", "add_collector", "DEFAULT_BUCKETS"]

_lock = threading.RLock()
_enabled = False
# Callables that fold device-side accumulations into the host instruments
# (and zero them); run by collect(), so by snapshot / prometheus_text / reset.
_COLLECTORS: List[Callable[[], None]] = []

# Latency-style default buckets (seconds): spans serve TTFT on smoke configs
# (~10ms) through queueing-dominated arrivals (seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)


def enable() -> None:
    """Turn instrument mutations on (process-global)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


class _Metric:
    """Base: named instrument with fixed label names."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._data: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Tuple) -> Tuple[str, ...]:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(labels)} label values for "
                f"label names {self.label_names}")
        return tuple(str(v) for v in labels)

    def clear(self) -> None:
        with _lock:
            self._data.clear()

    # -- snapshot helpers ----------------------------------------------------

    def _label_str(self, key: Tuple[str, ...]) -> str:
        return ",".join(f"{n}={v}" for n, v in zip(self.label_names, key))

    def _snapshot_values(self) -> Dict[str, object]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically-increasing per-label-set float."""

    kind = "counter"

    def inc(self, *labels, by: float = 1.0) -> None:
        if not _enabled:
            return
        if by < 0:
            raise ValueError(f"{self.name}: counters only go up (by={by})")
        self._add(self._key(labels), by)

    def _add(self, key: Tuple[str, ...], by: float) -> None:
        """Unconditional increment: a collector folding values that were
        recorded on the device while metrics were enabled."""
        with _lock:
            self._data[key] = self._data.get(key, 0.0) + by

    def value(self, *labels) -> float:
        with _lock:
            return float(self._data.get(self._key(labels), 0.0))

    def total(self) -> float:
        with _lock:
            return float(sum(self._data.values()))

    def _snapshot_values(self):
        return {self._label_str(k): v
                for k, v in sorted(self._data.items())}


class Gauge(_Metric):
    """Last-written per-label-set float (set/add semantics)."""

    kind = "gauge"

    def set(self, value: float, *labels) -> None:
        if not _enabled:
            return
        key = self._key(labels)
        with _lock:
            self._data[key] = float(value)

    def add(self, delta: float, *labels) -> None:
        if not _enabled:
            return
        key = self._key(labels)
        with _lock:
            self._data[key] = self._data.get(key, 0.0) + float(delta)

    def value(self, *labels) -> float:
        with _lock:
            return float(self._data.get(self._key(labels), 0.0))

    def _snapshot_values(self):
        return {self._label_str(k): v
                for k, v in sorted(self._data.items())}


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics).

    Per label set: bucket counts for each upper bound in ``buckets`` plus a
    ``+Inf`` overflow bucket, a running sum and a sample count.
    """

    kind = "histogram"

    def __init__(self, name, help, label_names,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        if tuple(sorted(buckets)) != tuple(buckets) or not buckets:
            raise ValueError(f"{name}: buckets must be sorted and non-empty")
        self.buckets = tuple(float(b) for b in buckets)

    def observe(self, value: float, *labels) -> None:
        if not _enabled:
            return
        key = self._key(labels)
        v = float(value)
        with _lock:
            state = self._data.get(key)
            if state is None:
                state = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._data[key] = state
            counts, _, _ = state
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            state[1] += v
            state[2] += 1

    def _merge(self, key: Tuple[str, ...], counts: Sequence[int],
               total: float, n: int) -> None:
        """Fold pre-bucketed observations (per-bucket counts, the ``+Inf``
        overflow last, their sum and number) into label set ``key``:
        unconditional, for collectors."""
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(f"{self.name}: {len(counts)} bucket counts for "
                             f"{len(self.buckets)} bounds + overflow")
        with _lock:
            state = self._data.get(key)
            if state is None:
                state = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._data[key] = state
            for i, c in enumerate(counts):
                state[0][i] += int(c)
            state[1] += float(total)
            state[2] += int(n)

    def count(self, *labels) -> int:
        with _lock:
            state = self._data.get(self._key(labels))
            return int(state[2]) if state else 0

    def sum(self, *labels) -> float:
        with _lock:
            state = self._data.get(self._key(labels))
            return float(state[1]) if state else 0.0

    def _snapshot_values(self):
        out = {}
        for key, (counts, total, n) in sorted(self._data.items()):
            cum, cum_counts = 0, {}
            for bound, c in zip(self.buckets, counts[:-1]):
                cum += c
                cum_counts[repr(bound)] = cum
            cum_counts["+Inf"] = cum + counts[-1]
            out[self._label_str(key)] = {
                "buckets": cum_counts, "sum": total, "count": n}
        return out


_REGISTRY: Dict[str, _Metric] = {}


def _register(cls, name: str, help: str, labels: Sequence[str], **kw):
    label_names = tuple(labels)
    with _lock:
        existing = _REGISTRY.get(name)
        if existing is not None:
            if type(existing) is not cls \
                    or existing.label_names != label_names:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}{existing.label_names}, cannot "
                    f"re-register as {cls.kind}{label_names}")
            return existing
        metric = cls(name, help, label_names, **kw)
        _REGISTRY[name] = metric
        return metric


def counter(name: str, help: str = "",
            labels: Sequence[str] = ()) -> Counter:
    return _register(Counter, name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return _register(Gauge, name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return _register(Histogram, name, help, labels, buckets=buckets)


def get(name: str) -> Optional[_Metric]:
    with _lock:
        return _REGISTRY.get(name)


def add_collector(fn: Callable[[], None]) -> None:
    """Register ``fn`` to fold device-side accumulations into the host
    instruments and zero them (see the module docstring); idempotent."""
    with _lock:
        if fn not in _COLLECTORS:
            _COLLECTORS.append(fn)


def collect() -> None:
    """Run every collector: device-fed instruments become current.  A
    device sync per collector that holds accumulations; nothing when none
    is registered."""
    for fn in list(_COLLECTORS):
        fn()


def reset() -> None:
    """Clear every instrument's recorded values (registrations persist),
    device-side accumulations included.  Test/benchmark seam — call
    between runs for a clean snapshot."""
    collect()
    with _lock:
        for m in _REGISTRY.values():
            m._data.clear()


def snapshot() -> Dict[str, dict]:
    """Deterministic JSON-ready snapshot of every registered instrument.

    Sorted by metric name; label sets sorted within each metric — two
    snapshots of the same state serialize identically (pinned by tests).
    """
    collect()
    with _lock:
        return {
            name: {
                "type": m.kind,
                "help": m.help,
                "labels": list(m.label_names),
                "values": m._snapshot_values(),
            }
            for name, m in sorted(_REGISTRY.items())
        }


def write_snapshot(path: str) -> None:
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True)
        f.write("\n")


def _prom_labels(metric: _Metric, key_str: str, extra: str = "") -> str:
    parts = []
    if key_str:
        for pair in key_str.split(","):
            n, _, v = pair.partition("=")
            v = v.replace("\\", r"\\").replace('"', r'\"')
            parts.append(f'{n}="{v}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text() -> str:
    """Prometheus text exposition of the registry (scrape/snapshot format)."""
    collect()
    lines: List[str] = []
    with _lock:
        for name, m in sorted(_REGISTRY.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, (counts, total, n) in sorted(m._data.items()):
                    ks = m._label_str(key)
                    cum = 0
                    for bound, c in zip(m.buckets, counts[:-1]):
                        cum += c
                        le = 'le="%s"' % bound
                        lines.append(
                            f"{name}_bucket{_prom_labels(m, ks, le)} {cum}")
                    cum += counts[-1]
                    le = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{_prom_labels(m, ks, le)} {cum}")
                    lines.append(f"{name}_sum{_prom_labels(m, ks)} {total}")
                    lines.append(f"{name}_count{_prom_labels(m, ks)} {n}")
            else:
                for key, v in sorted(m._data.items()):
                    ks = m._label_str(key)
                    lines.append(f"{name}{_prom_labels(m, ks)} {v}")
    return "\n".join(lines) + "\n"
