"""The arithmetic behind the metrics that read the program's own spans
(``repro_torch.obs.trace``, recorded by ``ServingEngine`` and the
model's layers while a ``torch.profiler`` records, so over a traced
run's traced part): the engine's host spans and request times, and its
device spans beside the device trace's operations, on one clock
(``perf_counter`` seconds).

The device trace's operations are tied to the host's clock at one
point, its closing marker (``trace.py``), and the profiler's own clock
runs at another rate than the host's: from 0 to 6,500 ppm apart on one
card, so up to ~28 ms early in a 4-s trace, against kernels of a few
µs.  The program's device spans are right to some µs (their events are
tied to the host at every engine call), so the operations are put onto
their clock first (``on_program_clock``): each ``moe.route`` span runs
the routing kernel once, and the drift between the two, fitted over the
traced part, is taken out of every operation, the closing tie kept.

Each function returns None where the run holds nothing to read: an
untraced run, or a program whose engine records no spans.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right

from perfbench import stats

DISPATCH = ("decode.dispatch", "prefill.dispatch")
MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
             "moe.shared")
MOE_DISPATCH = ("moe.route", "moe.dispatch", "moe.combine")
MOE_LAYER = "ffn.moe"
ROUTER = "moe_router"       # the routing kernel: once in each moe.route


def tracer(run):
    """The engine's tracer, its device spans resolved; None without."""
    tr = getattr(run.srv.engine, "tracer", None)
    if tr is None or not hasattr(tr, "resolve"):
        return None
    tr.resolve()
    return tr


def host(tr, names, lo, hi):
    """[(start, end)] host seconds of the spans named in ``names`` that
    lie in [lo, hi]."""
    out = []
    for r in tr.records:
        if r["ph"] == "X" and r["name"] in names:
            s = tr.origin + r["ts"] / 1e6
            e = s + r["dur"] / 1e6
            if s >= lo and e <= hi:
                out.append((s, e))
    return out


def device(tr, names, lo, hi):
    """[(start, end)] device intervals, in host seconds, of the device
    spans named in ``names`` whose host span lies in [lo, hi]."""
    out = []
    for r in tr.records:
        if r["name"] in names and "dev_ts" in r:
            s = tr.origin + r["ts"] / 1e6
            if s >= lo and s + r["dur"] / 1e6 <= hi:
                d = tr.origin + r["dev_ts"] / 1e6
                out.append((d, d + r["dev_dur"] / 1e6))
    return out


def intersect(a, b):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals):
    return sum(e - s for s, e in intervals)


class _Lengths:
    """Sorted disjoint intervals, and how much of them lies in [s, e]."""

    def __init__(self, intervals):
        self.iv = intervals
        self.starts = [a for a, _ in intervals]
        self.cum = [0.0]
        for a, b in intervals:
            self.cum.append(self.cum[-1] + b - a)

    def within(self, s, e):
        i = max(bisect_right(self.starts, s) - 1, 0)
        j = bisect_left(self.starts, e)
        if i >= j:
            return 0.0
        a, b = self.iv[i]
        head = max(0.0, min(b, s) - a)
        a, b = self.iv[j - 1]
        tail = max(0.0, b - max(a, e))
        return max(0.0, self.cum[j] - self.cum[i] - head - tail)


def on_program_clock(run, tr):
    """The trace's operations, their drift from the program's clock
    taken out: y = c + s x over the routing kernels (x: a ``moe.route``
    span's device start after the trace's end, y: its kernel's start
    less that), fitted by least squares once and again without the
    points more than three median deviations off; then each time t
    becomes t_end + (t - t_end) / (1 + s).  Unchanged where the program
    routes no tokens in the traced part or the two counts differ."""
    routes = sorted(s for s, _ in device(tr, ("moe.route",), run.t_open,
                                         run.t_trace))
    kernels = sorted(s for n, s, _ in run.ops if ROUTER in n
                     and run.t_open <= s <= run.t_trace)
    if len(routes) < 8 or len(routes) != len(kernels):
        return run.ops
    end = run.t_trace
    pts = [(d - end, k - d) for d, k in zip(routes, kernels)]
    slope = _fit(pts)
    dev = sorted(abs(y - slope[0] - slope[1] * x) for x, y in pts)
    mad = dev[len(dev) // 2]
    c, s = _fit([(x, y) for x, y in pts
                 if abs(y - slope[0] - slope[1] * x) <= 3 * mad])
    return [(n, end + (a - end) / (1 + s), end + (b - end) / (1 + s))
            for n, a, b in run.ops]


def _fit(pts):
    """Least-squares (intercept, slope) of y on x."""
    n = len(pts)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    sxx = sum((x - mx) ** 2 for x, _ in pts)
    s = sum((x - mx) * (y - my) for x, y in pts) / sxx if sxx else 0.0
    return my - s * mx, s


def busy(run, ops):
    """The union of the operations in the traced part."""
    return stats.union([(max(s, run.t_open), min(e, run.t_trace))
                        for _, s, e in ops
                        if e > run.t_open and s < run.t_trace])


def busy_inside(merged, spans):
    """Busy seconds (``merged``: ``busy``) inside the union of
    ``spans``."""
    return length(intersect(merged, stats.union(spans)))


# ---------------------------------------------------------------------------
def decode_dispatch_ms(run):
    """Median host ms of ``decode.dispatch`` over the traced steps."""
    tr = tracer(run)
    if tr is None:
        return None
    spans = host(tr, ("decode.dispatch",), run.t_open, run.t_trace)
    return stats.median([(e - s) * 1e3 for s, e in spans])


def idle_dispatch_share(run):
    """% of the traced part in which the device runs nothing while the
    host is inside a ``decode.dispatch`` or ``prefill.dispatch``."""
    tr = tracer(run)
    if tr is None or run.ops is None:
        return None
    spans = stats.union(host(tr, DISPATCH, run.t_open, run.t_trace))
    if not spans:
        return None
    merged = busy(run, on_program_clock(run, tr))
    idle = length(spans) - busy_inside(merged, spans)
    return 100.0 * idle / run.traced_s


def queue_wait_p95_ms(run):
    """p95 ms from submit to prefill start of the requests whose prefill
    started in the window (the engine's request times)."""
    times = getattr(run.srv.engine, "lifecycle", None)
    if times is None:
        return None
    return stats.percentile(
        [(t.t_prefill_start - t.t_submit) * 1e3 for t in times.values()
         if t.t_prefill_start is not None and run.inside(t.t_prefill_start)],
        95)


def moe_dispatch_share(run, within):
    """% of the MoE layers' device-busy time (inside their five parts'
    device spans) that lies inside ``moe.route``, ``moe.dispatch`` and
    ``moe.combine``, over the MoE layers called inside the ``within``
    device spans (``step``: decode; ``prefill``) of the traced part."""
    tr = tracer(run)
    if tr is None or run.ops is None:
        return None
    merged = busy(run, on_program_clock(run, tr))
    outer = stats.union(device(tr, (within,), run.t_open, run.t_trace))

    def inside(names):
        return intersect(stats.union(
            device(tr, names, run.t_open, run.t_trace)), outer)
    layer = busy_inside(merged, inside(MOE_PARTS))
    if not layer:
        return None
    return 100.0 * busy_inside(merged, inside(MOE_DISPATCH)) / layer


def coverage(run):
    """How much of the device's work the program's spans account for:
    the share of the traced part's device-busy time inside ``step`` or
    ``prefill`` device spans; for each MoE layer call, the busy time
    inside its parts over that inside the layer's span (the least such
    ratio); and how many ``decode.dispatch`` spans lie outside the
    host bracket of the harness's ``step()`` call they belong to."""
    tr = tracer(run)
    if tr is None or run.ops is None:
        return None
    merged = busy(run, on_program_clock(run, tr))
    total = length(merged)
    calls = device(tr, ("step", "prefill"), run.t_open, run.t_trace)
    layers = device(tr, (MOE_LAYER,), run.t_open, run.t_trace)
    parts = stats.union(device(tr, MOE_PARTS, run.t_open, run.t_trace))
    busy_at = _Lengths(merged)
    parts_at = _Lengths(intersect(merged, parts))
    ratios = [parts_at.within(s, e) / busy_at.within(s, e)
              for s, e in layers if busy_at.within(s, e)]
    brackets = [(a, b) for a, b, _ in run.steps(run.t_trace)]
    outside = sum(1 for s, e in host(tr, ("decode.dispatch",), run.t_open,
                                     run.t_trace)
                  if not any(a <= s and e <= b for a, b in brackets))
    return {"busy_in_calls": busy_inside(merged, calls) / total
            if total else None,
            "moe_layers": len(ratios),
            "moe_parts_over_layer_min": min(ratios) if ratios else None,
            "moe_parts_over_layer_p10": stats.percentile(ratios, 10),
            "dispatch_outside_step": outside,
            "records": len(tr.records), "dropped": tr.dropped}
