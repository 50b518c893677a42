"""repro_torch.obs -- the port of ``repro.obs``, so far the unified
:class:`Telemetry` record (wall clock, steps, steps/s; the legacy
``timings`` dict is derived from it) and the ``obs="none"``
:class:`NullTracer`.  The in-scan taps, ``SpanTracer`` and the
Prometheus text wait for ROADMAP.md, Queue 1 items 4d (``obs/``)
and 5.
"""
from repro_torch.obs.telemetry import (  # noqa: F401
    TELEMETRY_SCHEMA_VERSION, Telemetry, metrics_table,
)
from repro_torch.obs.trace import NullTracer  # noqa: F401
