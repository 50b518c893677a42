"""The MoE layer's yardstick and the two metrics that read it:
``moe_dropless_share.chat`` and ``moe_experts_roofline.chat``.

``experts_work`` counts what a call of the routed experts' three
products costs from the shapes that the program's ``moe.experts`` span
carries as its arguments (``rows``: the rows the products run over,
``E`` experts, widths ``D`` and ``F``), so that no change to the program
can move the count: 2 operations a multiply-add of the gate, up and
down products, 6 rows D F; bytes, each of the E experts' three [D, F]
matrices read once a call, the rows read once and the outputs written
once.  Counting all E experts' matrices overstates the bytes of a call
in which some expert gets no row: at a 64-slot chat decode step (384
pairs over 64 experts) an expected 64 (1 - 6/64)^64 ~ 0.12 experts get
none, under 0.3% of the bytes (1.1 GB a layer).

``dropless_share``: the share of the MoE layer calls in the traced part
that took the dropless path, from the program's counters
``moe_calls`` and ``moe_dropless_calls`` (one reading a call, or one a
counter at a replayed decode step by what its capture counted: each
reading adds its increase on the last).  ``experts_roofline``: over the
traced decode steps' ``moe.experts`` spans, the sum of each call's
bound (the larger of its operations over the bf16 peak and its bytes
over HBM's) over the device-busy time inside those spans.  Each returns
None where the run holds nothing to read: an untraced run, a program
without the counters or the spans' arguments.
"""
from __future__ import annotations

from perfbench import peaks, program_spans

EXPERTS = "moe.experts"
COUNTERS = ("moe_calls", "moe_dropless_calls")
SIZES = {"bfloat16": 2, "float16": 2, "float32": 4}


def experts_work(rows, E, D, F, size=2):
    """(operations, bytes) of the gate, up and down products over
    ``rows`` rows of width ``D`` through E experts of width ``F``."""
    return 6 * rows * D * F, size * (3 * E * D * F + 2 * rows * D)


def dropless_share(run):
    """100 x the dropless calls over the MoE calls in the traced part."""
    tr = program_spans.tracer(run)
    if tr is None:
        return None
    last = dict.fromkeys(COUNTERS, 0)
    n = dict.fromkeys(COUNTERS, 0)
    seen = False
    for r in tr.records:
        if r["ph"] != "C" or r["name"] not in last:
            continue
        value = r["args"]["value"]
        if run.t_open <= tr.origin + r["ts"] / 1e6 <= run.t_trace:
            n[r["name"]] += value - last[r["name"]]
            seen = True
        last[r["name"]] = value
    if not seen or not n["moe_calls"]:
        return None
    return 100.0 * n["moe_dropless_calls"] / n["moe_calls"]


def experts_roofline(run):
    """Σ bound / Σ device-busy time of the routed experts' products in
    the traced decode steps, in %."""
    tr = program_spans.tracer(run)
    if tr is None or run.ops is None:
        return None
    size = SIZES[run.cfg["dtype"]]
    steps = program_spans.host(tr, ("step",), run.t_open, run.t_trace)
    bound, spans = 0.0, []
    for r in tr.records:
        a = r["args"]
        if r["name"] != EXPERTS or "dev_ts" not in r or "rows" not in a:
            continue
        s = tr.origin + r["ts"] / 1e6
        e = s + r["dur"] / 1e6
        if not any(lo <= s and e <= hi for lo, hi in steps):
            continue
        flops, nbytes = experts_work(a["rows"], a["E"], a["D"], a["F"],
                                     size)
        bound += max(flops / peaks.BF16_FLOP_PER_S,
                     nbytes / peaks.HBM_BYTES_PER_S)
        d = tr.origin + r["dev_ts"] / 1e6
        spans.append((d, d + r["dev_dur"] / 1e6))
    if not spans:
        return None
    merged = program_spans.busy(run, program_spans.on_program_clock(run, tr))
    busy = program_spans.busy_inside(merged, spans)
    return 100.0 * bound / busy if busy else None
