"""Host-side structured span tracer with Chrome-trace / Perfetto export
(port of ``repro.obs.trace``; pure Python, no torch).

Spans are plain host-Python timing records around host-side control flow:
per-request lifetimes and per-engine-step phases in the serve engine, and
per-plan spans around the integer GEMM (``kernels.ops.run_plan`` and the
quantized matmul's ``run_plan_dequant``).  With tracing disabled (the
default) a ``span(...)`` call returns a shared null singleton: no
allocation, no contextvar write, no clock read.  A span never reads a
device tensor, so enabling tracing cannot change any computed value.

**On CUDA a span times the host.**  Kernels launch asynchronously, so a
span that does not end at a host read of the device's result measures the
time to *launch* its work, not the device time of that work: a
``run_plan`` span is a launch time, and so is every span inside a decode
graph's capture (opened once, at the capture; a replay opens none).  The
serve engine's ``decode_step`` span ends after the sampled tokens reach the
host and ``prefill_chunk`` after a sync or the first token's host read, so
those two are device-complete.

Export is the Chrome trace-event JSON format (``chrome://tracing`` /
Perfetto ``ui.perfetto.dev``): synchronous spans as complete events
(``ph: "X"``, microsecond ``ts``/``dur``), request lifetimes as async
begin/end pairs (``ph: "b"``/``"e"`` with an ``id``) so overlapping
requests render as separate tracks.  Nesting depth flows through a
contextvar, so spans opened across threads don't corrupt each other's
parent chain.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["enable", "disable", "enabled", "span", "instant",
           "begin_async", "end_async", "events", "clear", "chrome_trace",
           "export_chrome"]

_lock = threading.Lock()
_enabled = False
_events: List[dict] = []
# Monotonic epoch for the whole process: Chrome-trace ts values are relative
# microseconds, so one shared origin keeps every span on one timeline.
_EPOCH_NS = time.perf_counter_ns()

_span_path: contextvars.ContextVar = contextvars.ContextVar(
    "obs_span_path", default=())


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def _now_us() -> float:
    return (time.perf_counter_ns() - _EPOCH_NS) / 1e3


class _NullSpan:
    """Shared no-op span: the entire disabled-path cost of ``with span(...)``
    is one flag test plus entering/exiting this singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0", "_token")

    def __init__(self, name: str, args: Dict[str, object]):
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._token = None

    def __enter__(self):
        path = _span_path.get()
        self.args["depth"] = len(path)
        if path:
            self.args["parent"] = path[-1]
        self._token = _span_path.set(path + (self.name,))
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now_us()
        _span_path.reset(self._token)
        event = {
            "name": self.name,
            "ph": "X",
            "ts": self._t0,
            "dur": t1 - self._t0,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "cat": "repro",
            "args": self.args,
        }
        with _lock:
            _events.append(event)
        return False

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. chosen lane width)."""
        self.args.update(attrs)


def span(name: str, **attrs):
    """Context manager timing a host-side region.

    ``with trace.span("decode_step", step=i) as sp: ... sp.set(lanes=4)``
    """
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, dict(attrs))


def instant(name: str, **attrs) -> None:
    """Zero-duration marker event (e.g. request finished, fallback taken)."""
    if not _enabled:
        return
    event = {"name": name, "ph": "i", "ts": _now_us(), "pid": os.getpid(),
             "tid": threading.get_ident(), "s": "t", "cat": "repro",
             "args": dict(attrs)}
    with _lock:
        _events.append(event)


def begin_async(name: str, async_id, **attrs) -> None:
    """Open an async span (request lifetime) — pairs with :func:`end_async`
    by (name, id); overlapping ids render as parallel tracks."""
    if not _enabled:
        return
    event = {"name": name, "ph": "b", "id": str(async_id), "ts": _now_us(),
             "pid": os.getpid(), "tid": threading.get_ident(),
             "cat": "repro", "args": dict(attrs)}
    with _lock:
        _events.append(event)


def end_async(name: str, async_id, **attrs) -> None:
    if not _enabled:
        return
    event = {"name": name, "ph": "e", "id": str(async_id), "ts": _now_us(),
             "pid": os.getpid(), "tid": threading.get_ident(),
             "cat": "repro", "args": dict(attrs)}
    with _lock:
        _events.append(event)


def events() -> List[dict]:
    with _lock:
        return list(_events)


def clear() -> None:
    with _lock:
        _events.clear()


def chrome_trace() -> Dict[str, list]:
    """The buffered events as a Chrome trace-event JSON object."""
    return {"traceEvents": events(), "displayTimeUnit": "ms"}


def export_chrome(path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
        f.write("\n")
