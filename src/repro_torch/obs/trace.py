"""Host-side span tracing, the port of ``repro.obs.trace``: where the
wall-clock time of a run or a serving session went.

:class:`SpanTracer` records nested context-manager spans (``with
tracer.span("round", cat="train", round=r): ...``) and point instants
with microsecond wall-clock timestamps.  It is a HOST-side instrument
-- it never touches a tensor, so arming it cannot perturb trajectories
-- and its cost is two ``perf_counter`` calls and one dict append a
span.

Exports:

  export(path)   Chrome trace-event JSON (the ``{"traceEvents":
                 [...]}`` container of "X" complete events and "i"
                 instants) -- loadable in Perfetto / chrome://tracing.
  summary()      a per-span-name aggregate table (count, total ms,
                 mean ms, share of the traced wall).
  to_records()   the raw span dicts, JSON-safe -- what the unified
                 Telemetry record embeds.

:class:`NullTracer` is the ``obs="none"`` stand-in: every method is a
no-op (``span`` returns one shared nullcontext), so an instrumented
call site costs one attribute lookup when tracing is off.

``profile_to(dir)`` brackets a region with ``torch.profiler`` (CUDA
activity on a CUDA device) and writes its Chrome trace into ``dir``
beside the host span ``torch_profile``; the reference uses
``jax.profiler`` there.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from contextlib import contextmanager
from typing import List, Optional

import torch


class SpanTracer:
    """Nested wall-clock spans with Chrome trace-event export."""

    active = True

    def __init__(self):
        self.records: List[dict] = []   # closed spans + instants
        self._depth = 0
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    # ------------------------------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "run", **args):
        """Record one nested span around the with-body."""
        depth = self._depth
        self._depth += 1
        t_in = time.perf_counter()
        try:
            yield
        finally:
            t_out = time.perf_counter()
            self._depth = depth
            self.records.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": self._us(t_in),
                "dur": (t_out - t_in) * 1e6,
                "depth": depth, "args": args})

    def instant(self, name: str, cat: str = "run", **args):
        """Record a point event (a request lifecycle edge)."""
        self.records.append({
            "name": name, "cat": cat, "ph": "i",
            "ts": self._us(time.perf_counter()),
            "dur": 0.0, "depth": self._depth, "args": args})

    @contextmanager
    def profile_to(self, profile_dir: Optional[str], device=None):
        """A span that also captures a ``torch.profiler`` trace of the
        region into ``profile_dir`` (``trace.json``), with CUDA
        activity when ``device`` is a CUDA device (default: when CUDA is
        available).  ``None`` is a pure no-op (no span either -- the
        caller asked for nothing)."""
        if not profile_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available() if device is None else \
            torch.device(device).type == "cuda"
        activities = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        with profile(activities=activities) as prof:
            with self.span("torch_profile", cat="profiler",
                           dir=profile_dir):
                yield
        prof.export_chrome_trace(path)

    # ------------------------------------------------------------------
    def to_records(self) -> List[dict]:
        """The raw span/instant dicts (JSON-safe; args stringified)."""
        return [{**r, "args": {k: _safe(v)
                               for k, v in r["args"].items()}}
                for r in self.records]

    def export(self, path: str) -> str:
        """Write Chrome trace-event JSON (Perfetto-loadable); returns
        ``path``.  Spans map to "X" complete events on one pid/tid so
        the viewer rebuilds the nesting from ts/dur containment."""
        events = []
        for r in self.to_records():
            ev = {"name": r["name"], "cat": r["cat"], "ph": r["ph"],
                  "ts": r["ts"], "pid": self._pid, "tid": 1,
                  "args": r["args"]}
            if r["ph"] == "X":
                ev["dur"] = r["dur"]
            else:
                ev["s"] = "t"       # instant scope: thread
            events.append(ev)
        blob = {"traceEvents": events, "displayTimeUnit": "ms"}
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(blob, f)
        return path

    def summary(self) -> str:
        """Per-span-name aggregate table over the recorded spans."""
        spans = [r for r in self.records if r["ph"] == "X"]
        if not spans:
            return "no spans recorded"
        agg = {}
        for r in spans:
            a = agg.setdefault(r["name"], [0, 0.0])
            a[0] += 1
            a[1] += r["dur"]
        # wall = top-level span time only (nested spans double-count)
        wall = sum(r["dur"] for r in spans if r["depth"] == 0) or 1.0
        lines = [f"{'span':<24} {'count':>6} {'total_ms':>10} "
                 f"{'mean_ms':>9} {'share':>6}"]
        for name, (n, tot) in sorted(agg.items(),
                                     key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<24} {n:>6} {tot / 1e3:>10.2f} "
                         f"{tot / n / 1e3:>9.3f} "
                         f"{min(tot / wall, 1.0):>5.0%}")
        return "\n".join(lines)


class NullTracer:
    """The ``obs="none"`` tracer: every method is a no-op.  ``span``
    hands back one shared nullcontext, so an instrumented call site
    costs an attribute lookup and nothing else."""

    active = False
    _null = contextlib.nullcontext()

    def span(self, name: str, cat: str = "run", **args):
        return self._null

    def profile_to(self, profile_dir, device=None):
        return self._null

    def instant(self, name: str, cat: str = "run", **args):
        pass

    def to_records(self) -> List[dict]:
        return []

    def export(self, path: str):
        raise ValueError(
            "tracing is off (obs='none' builds a NullTracer); build "
            "the session with spec.obs='basic' or 'full' to record "
            "spans")

    def summary(self) -> str:
        return "tracing off (obs='none')"


def _safe(v):
    """JSON-safe arg value (numbers/strings pass, the rest reprs)."""
    return v if isinstance(v, (int, float, str, bool, type(None))) \
        else repr(v)
