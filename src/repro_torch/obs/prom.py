"""Prometheus text-exposition exporter for serving telemetry: the port
of ``repro.obs.prom`` (numpy only; the same metric names, types and
help strings).

:func:`prometheus_text` renders a
:class:`~repro_torch.serving.ServeReport`
(or its ``to_dict()`` shape) as Prometheus text format 0.0.4 -- the
``# HELP`` / ``# TYPE`` / sample-line layout any Prometheus scraper or
``promtool check metrics`` accepts:

  repro_serve_submitted_total 12
  repro_serve_latency_seconds_bucket{le="0.005"} 9
  ...
  repro_serve_latency_seconds_sum 0.0421
  repro_serve_latency_seconds_count 12

Counters (``submitted``/``completed``/``rejected``/``evicted``) map to
``_total`` counter samples; level quantities (waiting, occupancy,
cache size, throughput) map to gauges; the per-request ``latency_s``
log folds into one cumulative histogram over static seconds buckets.
The exporter is a pure text renderer over an already-collected report
-- it never touches the server -- so it can run after ``serve()``
returns or inside a scrape handler wrapping a live ``server()``
session's ``report()``.
"""
from __future__ import annotations

import numpy as np

# histogram upper bounds, seconds (cumulative; +Inf appended)
LATENCY_BUCKETS_S = (0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 1.0)

# ServeReport counter key -> (metric suffix, type, help); the help
# strings are the reference's word for word, so equal reports render
# byte-equal in both packages
_COUNTERS = (
    ("submitted", "submitted_total", "counter",
     "Requests submitted to the server."),
    ("completed", "completed_total", "counter",
     "Requests completed (prediction returned)."),
    ("rejected", "rejected_total", "counter",
     "Requests rejected at admission."),
    ("evicted", "evicted_total", "counter",
     "Requests evicted from slots."),
    ("steps", "steps_total", "counter",
     "Jitted serve steps executed."),
    ("step_traces", "step_traces_total", "counter",
     "Serve-step compilations (should stay 1)."),
    ("waiting", "waiting", "gauge",
     "Requests still assembling split features."),
    ("max_occupancy", "max_occupancy", "gauge",
     "Peak concurrent slot occupancy."),
    ("max_slots", "max_slots", "gauge",
     "Configured slot-pool capacity."),
)

_CACHE = (
    ("hits", "cache_hits_total", "counter",
     "Exchange-cache hits."),
    ("misses", "cache_misses_total", "counter",
     "Exchange-cache misses."),
    ("evictions", "cache_evictions_total", "counter",
     "Exchange-cache LRU evictions."),
    ("size", "cache_entries", "gauge",
     "Exchange-cache resident entries."),
)


def _num(v, default=0.0):
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def prometheus_text(report, prefix: str = "repro_serve") -> str:
    """Render a ServeReport (or its dict form) as Prometheus text
    exposition.  ``prefix`` namespaces every metric name."""
    if hasattr(report, "to_dict"):
        counters = dict(report.counters)
        cache = report.cache
        requests = report.telemetry
        thr = report.throughput_rps
    else:
        counters = dict(report.get("counters", {}))
        cache = report.get("cache")
        requests = report.get("telemetry", [])
        thr = report.get("throughput_rps", 0.0)

    lines = []

    def emit(suffix, mtype, help_, value, labels=""):
        name = f"{prefix}_{suffix}"
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {_fmt(value)}")

    for key, suffix, mtype, help_ in _COUNTERS:
        if key in counters:
            emit(suffix, mtype, help_, _num(counters[key]))
    emit("throughput_rps", "gauge",
         "Completed requests per wall-clock second.", _num(thr))
    if cache:
        for key, suffix, mtype, help_ in _CACHE:
            if key in cache:
                emit(suffix, mtype, help_, _num(cache[key]))

    # latency histogram: cumulative buckets over the request log
    lat = np.asarray([_num(t.get("latency_s"))
                      for t in requests if "latency_s" in t])
    name = f"{prefix}_latency_seconds"
    lines.append(f"# HELP {name} Request latency, submit to "
                 f"complete.")
    lines.append(f"# TYPE {name} histogram")
    for le in LATENCY_BUCKETS_S:
        n = int((lat <= le).sum()) if lat.size else 0
        lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {n}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {lat.size}')
    lines.append(f"{name}_sum {_fmt(float(lat.sum()) if lat.size else 0.0)}")
    lines.append(f"{name}_count {lat.size}")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    """Prometheus sample value: integers bare, floats repr'd."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)
