"""repro_torch.obs — observability of the port (port of ``repro.obs``).

Three host-side subsystems, all zero-overhead when disabled (the default):

  * :mod:`repro_torch.obs.metrics` — process-global counter/gauge/histogram
    registry (JSON snapshot + Prometheus text export);
  * :mod:`repro_torch.obs.trace`   — structured span tracer exporting
    Chrome-trace/Perfetto JSON;
  * :mod:`repro_torch.obs.traffic` — the analytic memory-traffic model of
    the GEMM paths (the measured side is not ported: see its docstring).

``enable_all()`` / ``disable_all()`` flip metrics and tracing together
(what ``launch/serve.py --metrics-out/--trace-out`` uses).  No instrument
reads a device tensor inside a step: enabling them cannot move a bit of
any computed output.
"""
from repro_torch.obs import metrics, trace, traffic

__all__ = ["metrics", "trace", "traffic", "enable_all", "disable_all"]


def enable_all() -> None:
    metrics.enable()
    trace.enable()


def disable_all() -> None:
    metrics.disable()
    trace.disable()
