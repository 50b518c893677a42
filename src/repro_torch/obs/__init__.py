"""repro_torch.obs -- the port of ``repro.obs``: metric taps in the
round's carried state, host-side span tracing, and one versioned
telemetry record.

Three layers:

  taps       ``ExperimentSpec.obs = "none" | "basic" | "full"`` rides
             the round's carried state as an impl (like schedule /
             fault / wire), recording per-round series on the device:
             loss, exchange-stack norms, grad norms, quarantine counts,
             bytes-on-wire, staleness depth.  Observation-only and
             hash-excluded: ``obs="full"`` trajectories are bitwise
             ``obs="none"`` trajectories.
  trace      :class:`SpanTracer` host spans over build / round / eval /
             checkpoint / serving request lifecycles, exported as
             Chrome trace-event JSON (Perfetto-loadable).
             ``obs="none"`` sessions get the no-op :class:`NullTracer`.
  telemetry  :class:`Telemetry` -- the one versioned record on
             ``RunResult.telemetry`` / ``ServeReport.obs`` folding wall
             clock, fault/wire/serve counters, obs series and spans;
             the legacy ``timings`` dict is derived from it.
             :func:`prometheus_text` renders serving counters and the
             latency histogram as Prometheus text exposition.

Quickstart::

    spec = ExperimentSpec(dataset="mnist", mode="devertifl",
                          obs="full", rounds=5)
    sess = build(spec)
    res = sess.run()
    res.telemetry.series["loss"]        # [rounds] series from the device
    sess.tracer.export("trace.json")    # open in ui.perfetto.dev
    print(sess.tracer.summary())

CLI: ``python -m repro_torch.obs --obs full --trace-out trace.json``
(``--device cpu`` off the GPU).
"""
from repro_torch.obs.registry import (OBS, LEVEL_BASIC, LEVEL_FULL,
                                      LEVEL_NONE, ObsEntry, ObsPlan,
                                      get_obs_plan, obs_names,
                                      register_obs)
from repro_torch.obs.taps import SERIES_KEYS, ObsImpl, make_obs_impl
from repro_torch.obs.trace import NullTracer, SpanTracer
from repro_torch.obs.telemetry import (TELEMETRY_SCHEMA_VERSION, Telemetry,
                                       metrics_table)
from repro_torch.obs.prom import LATENCY_BUCKETS_S, prometheus_text

__all__ = [
    "OBS", "LEVEL_NONE", "LEVEL_BASIC", "LEVEL_FULL",
    "ObsPlan", "ObsEntry", "get_obs_plan", "obs_names",
    "register_obs",
    "ObsImpl", "make_obs_impl", "SERIES_KEYS",
    "SpanTracer", "NullTracer",
    "Telemetry", "TELEMETRY_SCHEMA_VERSION", "metrics_table",
    "prometheus_text", "LATENCY_BUCKETS_S",
]
