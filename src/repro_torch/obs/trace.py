"""Span tracing, the port of ``repro.obs.trace``: where the wall-clock
time of a run or a serving session went, on the host and on the card.

:class:`SpanTracer` records nested context-manager spans (``with
tracer.span("round", cat="train", round=r): ...``), point instants and
counters with microsecond timestamps on ``time.perf_counter``'s clock:
a record's ``ts`` is µs after the tracer's ``origin``, so ``origin +
ts / 1e6`` is the ``perf_counter`` second it began, the clock a
``torch.profiler`` trace can be tied to.  A host span costs two
``perf_counter`` calls and one append; it never touches a tensor, so
arming it cannot perturb trajectories.

A device span (``span(..., device=True)``) also brackets its region
with two ``torch.cuda.Event``s on the stream current at ``arm``, drawn
from a pool; ``resolve()`` (after the device has caught up) turns them
into ``dev_ts`` / ``dev_dur`` on the same clock, through the anchor
event that the latest ``arm`` recorded right after a synchronise at a
known host time.  The device's clock drifts from the host's by about
10 µs a second (one H100), so a caller arms again as often as it can
afford a synchronise: the serving engine at each call it records.
Before ``arm`` on a CUDA device, and on the CPU, a device span is a
host span.  Events are recorded on the stream, not waited on: the host
runs on as it would untraced.

A CUDA graph's replay runs no Python, so the spans inside it are taken
at its capture: :class:`GraphSpans` is the tracer a capture records
into, each device span's boundaries timing events captured as event
nodes of the graph (host spans are not kept).  After each replay
``SpanTracer.replayed`` writes them out as records, their host times
inside the replay's call in the order they were captured, their device
times from the graph's events; the next ``arm`` or ``resolve`` reads
those before another replay records over them.  The counters the
capture counted (``GraphSpans.counts``) are added once a replay, one
reading a counter.

The records are the newest ``MAX_RECORDS``; ``dropped`` counts those
pushed out.

Exports:

  export(path)   Chrome trace-event JSON (the ``{"traceEvents":
                 [...]}`` container of "X" complete events, "i"
                 instants and "C" counters; device spans on a second
                 track) -- loadable in Perfetto / chrome://tracing.
  summary()      a per-span-name aggregate table (count, total ms,
                 mean ms, share of the traced wall).
  to_records()   the raw span dicts, JSON-safe -- what the unified
                 Telemetry record embeds.

:class:`NullTracer` is the ``obs="none"`` stand-in: every method is a
no-op (``span`` returns one shared nullcontext), so an instrumented
call site costs one attribute lookup when tracing is off.

``current()`` is the tracer that the serving engine armed for the call
under way (``armed``), and ``NULL`` outside one: the model's layers
record into it without a tracer in their signatures.

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
from collections import deque
from contextlib import contextmanager
from typing import List, Optional

import torch

# The newest records a tracer keeps.  A decode step of a served hybrid
# MoE model (16 layers, 8 of them MoE) records ~95 spans and counter
# readings: 2**17 records hold a whole 51-s window of a 64-slot chat
# loop (~1,000 steps) at some 60 MB, and bound an operator's long
# session, whose oldest records are pushed out.
MAX_RECORDS = 1 << 17


class SpanTracer:
    """Nested wall-clock spans, device spans and counters, with Chrome
    trace-event export."""

    active = True

    def __init__(self):
        self._records = deque(maxlen=MAX_RECORDS)
        self._added = 0
        # (record, start event, end event, anchor, whether the events
        # return to the pool) of device spans not yet resolved
        self._pending = deque(maxlen=MAX_RECORDS)
        self._pool: List[torch.cuda.Event] = []
        self._anchor = None       # (host second, event) once armed
        self._device = self._stream = None
        self._depth = 0
        self.counters = {}
        self.origin = time.perf_counter()
        self._pid = os.getpid()

    # ------------------------------------------------------------------
    @property
    def records(self) -> List[dict]:
        """The kept records, oldest first (closed spans, instants,
        counter readings)."""
        return list(self._records)

    @property
    def dropped(self) -> int:
        """Records pushed out by newer ones (``MAX_RECORDS``)."""
        return self._added - len(self._records)

    def _us(self, t: float) -> float:
        return (t - self.origin) * 1e6

    def _add(self, rec):
        self._records.append(rec)
        self._added += 1

    def arm(self, device):
        """Lets device spans time the work on ``device`` (its current
        stream): synchronises it, records the anchor event at a known
        host time, and resolves the device spans before it (their events
        are done), so that their events return to the pool.  On a CPU
        device, device spans stay host spans."""
        device = torch.device(device)
        if device.type != "cuda":
            self._anchor = self._stream = None
            return
        self._device = device
        self._stream = torch.cuda.current_stream(device)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        self._anchor = (t, ev)
        self.resolve()

    def _event(self):
        ev = self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    @contextmanager
    def span(self, name: str, cat: str = "run", device: bool = False,
             **args):
        """Record one nested span around the with-body; ``device``: also
        time the device's work enqueued inside it (module doc)."""
        depth = self._depth
        self._depth += 1
        anchor = self._anchor if device else None
        if anchor is not None:
            e0 = self._event()
        t_in = time.perf_counter()
        try:
            yield
        finally:
            if anchor is not None:
                e1 = self._event()
            t_out = time.perf_counter()
            self._depth = depth
            rec = {"name": name, "cat": cat, "ph": "X",
                   "ts": self._us(t_in),
                   "dur": (t_out - t_in) * 1e6,
                   "depth": depth, "args": args}
            self._add(rec)
            if anchor is not None:
                self._pending.append((rec, e0, e1, anchor, True))

    def replayed(self, graph_spans, t_in: float, t_out: float):
        """Records the device spans of one replay of a captured graph
        (``graph_spans``, a :class:`GraphSpans`), which ran from host
        second ``t_in`` to ``t_out``: each one level below the span open
        now plus its depth in the capture, its host interval a slice of
        [t_in, t_out] in the order its boundaries were captured (so that
        they nest as they did), its device interval from the graph's
        events.  Those events belong to the graph and go to no pool.
        Then each counter the capture counted, by what it counted."""
        spans = graph_spans.spans
        tick = (t_out - t_in) / (2 * len(spans) + 1)
        for s in spans:
            t0 = t_in + (s["k_in"] + 1) * tick
            t1 = t_in + (s["k_out"] + 1) * tick
            rec = {"name": s["name"], "cat": s["cat"], "ph": "X",
                   "ts": self._us(t0), "dur": (t1 - t0) * 1e6,
                   "depth": self._depth + s["depth"], "args": s["args"]}
            self._add(rec)
            if self._anchor is not None:
                self._pending.append((rec, s["e0"], s["e1"], self._anchor,
                                      False))
        for name, n in graph_spans.counts.items():
            self.count(name, n)

    def instant(self, name: str, cat: str = "run", **args):
        """Record a point event (a request lifecycle edge)."""
        self._add({
            "name": name, "cat": cat, "ph": "i",
            "ts": self._us(time.perf_counter()),
            "dur": 0.0, "depth": self._depth, "args": args})

    def count(self, name: str, n: int = 1):
        """Add ``n`` to counter ``name``; its running total is recorded."""
        total = self.counters.get(name, 0) + n
        self.counters[name] = total
        self._add({
            "name": name, "cat": "counter", "ph": "C",
            "ts": self._us(time.perf_counter()),
            "dur": 0.0, "depth": self._depth, "args": {"value": total}})

    def resolve(self):
        """Gives every device span recorded so far its ``dev_ts`` and
        ``dev_dur`` (µs on the records' clock), waiting for the device
        to reach it, and returns its events to the pool."""
        if self._pending:
            torch.cuda.synchronize(self._device)
        for rec, e0, e1, (t, anchor), pooled in self._pending:
            rec["dev_ts"] = self._us(t + anchor.elapsed_time(e0) / 1e3)
            rec["dev_dur"] = e0.elapsed_time(e1) * 1e3
            if pooled:
                self._pool += (e0, e1)
        self._pending.clear()

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
        """The raw span/instant/counter dicts (JSON-safe; args
        stringified), device spans resolved."""
        self.resolve()
        return [{**r, "args": {k: _safe(v)
                               for k, v in r["args"].items()}}
                for r in self._records]

    def export(self, path: str) -> str:
        """Write Chrome trace-event JSON (Perfetto-loadable); returns
        ``path``.  Spans map to "X" complete events on one pid/tid so
        the viewer rebuilds the nesting from ts/dur containment; a
        device span's device interval goes to a second track (tid 2)."""
        events = []
        device = False
        for r in self.to_records():
            ev = {"name": r["name"], "cat": r["cat"], "ph": r["ph"],
                  "ts": r["ts"], "pid": self._pid, "tid": 1,
                  "args": r["args"]}
            if r["ph"] == "X":
                ev["dur"] = r["dur"]
            elif r["ph"] == "C":
                ev["args"] = {r["name"]: r["args"]["value"]}
            else:
                ev["s"] = "t"       # instant scope: thread
            events.append(ev)
            if "dev_ts" in r:
                device = True
                events.append({**ev, "ts": r["dev_ts"], "dur": r["dev_dur"],
                               "tid": 2})
        if device:
            events += [{"name": "thread_name", "ph": "M", "ts": 0,
                        "pid": self._pid, "tid": tid,
                        "args": {"name": track}}
                       for tid, track in ((1, "host"), (2, "device"))]
        blob = {"traceEvents": events, "displayTimeUnit": "ms"}
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(blob, f)
        return path

    def summary(self) -> str:
        """Per-span-name aggregate table over the recorded spans."""
        spans = [r for r in self._records if r["ph"] == "X"]
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
    dropped = 0
    _null = contextlib.nullcontext()

    @property
    def records(self) -> List[dict]:
        return []

    def span(self, name: str, cat: str = "run", device: bool = False,
             **args):
        return self._null

    def profile_to(self, profile_dir, device=None):
        return self._null

    def instant(self, name: str, cat: str = "run", **args):
        pass

    def count(self, name: str, n: int = 1):
        pass

    def replayed(self, graph_spans, t_in: float, t_out: float):
        pass

    def arm(self, device):
        pass

    def resolve(self):
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


NULL = NullTracer()
_current = NULL


def _graph_event():
    return torch.cuda.Event(enable_timing=True, external=True)


class GraphSpans:
    """The tracer a CUDA graph's capture records into (module doc): a
    device span's boundaries are events made by ``event`` (timing
    events captured as event nodes; a CPU test passes stand-ins) and
    recorded on the capturing stream; a host span only keeps the
    depth.  ``spans``: per device span, in the order it opened, its
    name, category, depth, arguments, events, and the indices of its
    opening and closing among all boundaries kept; ``counts``: what the
    captured step added to each counter, which every replay adds
    again."""

    def __init__(self, event=_graph_event):
        self.spans = []
        self.counts = {}
        self._event = event
        self._depth = 0
        self._k = 0

    def count(self, name: str, n: int = 1):
        """Add ``n`` to what the captured step counts of ``name``."""
        self.counts[name] = self.counts.get(name, 0) + n

    def _mark(self):
        ev = self._event()
        ev.record()
        self._k += 1
        return ev, self._k - 1

    @contextmanager
    def span(self, name: str, cat: str = "run", device: bool = False,
             **args):
        depth = self._depth
        self._depth += 1
        s = None
        if device:
            e0, k = self._mark()
            s = {"name": name, "cat": cat, "depth": depth, "args": args,
                 "e0": e0, "k_in": k}
            self.spans.append(s)
        try:
            yield
        finally:
            if s is not None:
                s["e1"], s["k_out"] = self._mark()
            self._depth = depth


def current():
    """The tracer armed for the serving call under way; ``NULL`` outside
    one."""
    return _current


@contextmanager
def armed(tracer):
    """Makes ``tracer`` the one ``current()`` returns inside the
    with-body."""
    global _current
    prev, _current = _current, tracer
    try:
        yield tracer
    finally:
        _current = prev


def _safe(v):
    """JSON-safe arg value (numbers/strings pass, the rest reprs)."""
    return v if isinstance(v, (int, float, str, bool, type(None))) \
        else repr(v)
