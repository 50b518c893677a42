"""The unified telemetry record: one versioned shape for *everything
a run or serving session measured about itself*.  The port of
``repro.obs.telemetry``, numpy only.

Before PR 10 the measurement surface was fragmented: wall clock and
throughput in ``RunResult.timings``, fault-event counters in
``timings["fault"]``, bytes-on-wire in ``timings["wire"]``, serving
counters in ``ServeReport.counters``, and nothing tied them together.
:class:`Telemetry` folds them into one record:

  wall_s / steps / steps_per_sec    the run's clock and throughput
  fault                             fault-event + watchdog counters
  wire                              integer bytes-on-wire counters
  serve                             serving counters + latency stats
  series                            repro.obs per-round on-device
                                    series (loss, norms, quarantines,
                                    bytes, staleness)
  spans                             host-side SpanTracer records

``RunResult.telemetry`` and ``ServeReport.obs`` carry it; the legacy
``timings`` dict survives as a DEPRECATED alias derived from the
record (:meth:`Telemetry.to_timings`), so every pre-PR-10 consumer
keeps reading the exact keys it always read.  Counters that ride the
scan carry (fault events, bytes) are cumulative across checkpoint
resume -- the checkpoint restores them with the rest of the carried
state -- so a resumed run's record covers every round since round 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# 1: initial schema -- wall/steps/throughput + fault/wire/serve
# counter sub-dicts + obs series + tracer spans
TELEMETRY_SCHEMA_VERSION = 1


def _clean(v):
    """JSON-safe: numpy arrays -> lists, numpy scalars -> python."""
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


@dataclass
class Telemetry:
    """One run's (or serving session's) unified measurement record."""
    wall_s: float = 0.0
    steps: int = 0
    steps_per_sec: float = 0.0
    fault: Optional[dict] = None    # event counters + watchdog trips
    wire: Optional[dict] = None     # integer bytes-on-wire
    serve: Optional[dict] = None    # serving counters + latency_ms
    series: Optional[dict] = None   # obs per-round series (numpy)
    spans: Optional[List[dict]] = None   # SpanTracer records
    schema_version: int = TELEMETRY_SCHEMA_VERSION

    # ------------------------------------------------------------------
    def to_timings(self) -> dict:
        """The DEPRECATED legacy ``RunResult.timings`` shape, derived
        from this record: {"wall_s", "steps_per_sec"} plus the
        historical "fault" / "wire" sub-dicts when present.  Old keys
        only -- new measurement lives on the record itself."""
        t = {"wall_s": self.wall_s,
             "steps_per_sec": self.steps_per_sec}
        if self.fault is not None:
            t["fault"] = dict(self.fault)
        if self.wire is not None:
            t["wire"] = dict(self.wire)
        return t

    def to_dict(self) -> dict:
        """JSON-safe dict (series arrays become lists)."""
        return {
            "schema_version": self.schema_version,
            "wall_s": self.wall_s,
            "steps": int(self.steps),
            "steps_per_sec": self.steps_per_sec,
            "fault": _clean(self.fault),
            "wire": _clean(self.wire),
            "serve": _clean(self.serve),
            "series": _clean(self.series),
            "spans": _clean(self.spans),
        }

    # ------------------------------------------------------------------
    @classmethod
    def from_timings(cls, timings: dict) -> "Telemetry":
        """Lift a legacy timings dict (custom mode runners still
        return one) into the unified record, preserving the
        historical sub-dicts."""
        timings = dict(timings or {})
        return cls(wall_s=float(timings.get("wall_s", 0.0)),
                   steps_per_sec=float(
                       timings.get("steps_per_sec", 0.0)),
                   fault=timings.get("fault"),
                   wire=timings.get("wire"))


def metrics_table(result) -> str:
    """A human-readable metrics + telemetry table for one RunResult
    (the ``python -m repro.obs`` renderer)."""
    tel = getattr(result, "telemetry", None) or Telemetry.from_timings(
        getattr(result, "timings", {}))
    lines = [f"spec_hash  {result.spec_hash}",
             f"git_sha    {result.git_sha}",
             f"wall_s     {tel.wall_s:.3f}",
             f"steps/sec  {tel.steps_per_sec:.1f}"]
    for k in sorted(result.metrics):
        v = result.metrics[k]
        if isinstance(v, float):
            lines.append(f"{k:<10} {v:.4f}")
    for name in ("fault", "wire", "serve"):
        d = getattr(tel, name)
        if d:
            lines.append(f"[{name}] " + "  ".join(
                f"{k}={v}" for k, v in sorted(d.items())
                if isinstance(v, (int, float))))
    if tel.series is not None:
        loss = np.asarray(tel.series["loss"])
        lines.append(f"[series] rounds={loss.shape[0]}  "
                     f"loss {loss[0]:.4f} -> {loss[-1]:.4f}  "
                     f"keys={','.join(sorted(tel.series))}")
    return "\n".join(lines)
