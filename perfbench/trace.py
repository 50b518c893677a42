"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window's first ``SECONDS`` with CUDA activity only (no host op is
recorded, so the host's path is not slowed by the profiler's
bookkeeping), the kernels read from the raw kineto events, and their
clock tied to the host's by a marker kernel (``torch.cuda._sleep``)
launched at a known host time at its end; another at its start gives
the drift (its launch can wait on the tracer's start: 13 ms seen).  The
profiler's buffers hold some hundreds of thousands of kernels: a whole
window of a cell launching 50,000 a second lost its last records, as
did one 8-s trace in three of the chat cell (~250,000 kernels), and a
trace that lacks its closing marker is refused."""
from __future__ import annotations

import time

import torch

from perfbench import peaks, stats

MARKER = "spin_kernel"
SECONDS = 4.0
STEP_MARK = "ProfilerStep"


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.marks = []

    def _mark(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.marks.append(t)

    def start(self):
        # a warm-up step first: the activity tracing comes up after the
        # profiler starts, and a kernel launched at once can go
        # unrecorded (one run in five lost its opening marker so)
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda prof: None)
        self.prof.start()
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.2)
        self.prof.step()
        self._mark()

    def stop(self):
        """Ends the trace; returns its host end time."""
        self._mark()
        self.prof.stop()
        return self.marks[-1]

    def events(self):
        """[(name, start, end)] of every device operation in host
        seconds (perf_counter), tied by the closing marker, and the
        clock drift to the opening one in seconds (None where the trace
        lacks it)."""
        raw = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = ev.name()
            if name.startswith(STEP_MARK):
                continue
            start = ev.start_ns() if hasattr(ev, "start_ns") else \
                ev.start_us() * 1000
            dur = ev.duration_ns() if hasattr(ev, "duration_ns") else \
                ev.duration_us() * 1000
            raw.append((name, start, start + dur))
        marks = sorted(s for n, s, _ in raw if MARKER in n)
        other = [(n, s, e) for n, s, e in raw if MARKER not in n]
        last = max((s for _, s, _ in other), default=0)
        if not marks or marks[-1] < last:
            # the closing marker lost: so may be any record before it
            raise RuntimeError("the trace lost its closing marker kernel")
        off1 = marks[-1] / 1e9 - self.marks[-1]
        drift = off1 - (marks[0] / 1e9 - self.marks[0]) \
            if len(marks) == 2 else None
        return [(n, s / 1e9 - off1, e / 1e9 - off1)
                for n, s, e in other], drift


def by_kind(ops, t_open, t_close):
    """Device seconds in the window by kind of kernel (``peaks``)."""
    out = {}
    for n, s, e in ops:
        lo, hi = max(s, t_open), min(e, t_close)
        if hi > lo:
            k = peaks.kind_of(n)
            out[k] = out.get(k, 0.0) + hi - lo
    return out


def reduce(ops, t_open, t_close, spans):
    """busy seconds, the top device operations and the longest idle
    gaps in the window, each gap named by the host span (``admit``,
    ``step``; ``client`` between them) its middle falls in."""
    inside = [(s, e) for _, s, e in ops if e > t_open and s < t_close]
    merged = stats.union(inside)
    busy = stats.covered(merged, t_open, t_close)
    by_name = {}
    for n, s, e in ops:
        lo, hi = max(s, t_open), min(e, t_close)
        if hi > lo:
            by_name[n] = by_name.get(n, 0.0) + (hi - lo)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, last = [], t_open
    for s, e in merged:
        s = max(s, t_open)
        if s > last:
            gaps.append((last, s))
        last = max(last, min(e, t_close))
    if t_close > last:
        gaps.append((last, t_close))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        host = next((name for name, s, e in spans if s <= mid <= e),
                    "client")
        named.append([host, b - a])
    return busy, [[n[:160], s] for n, s in top], named
