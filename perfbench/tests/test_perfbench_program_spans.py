"""The metrics that read the program's own spans, on synthetic runs whose
device operations, host spans and device spans are known: each reader
returns the value the intervals give, a ``moe.experts`` span shifted off
its kernels moves the MoE share, and a program whose engine records
nothing (the parent of the change that added the spans) reads None."""
from __future__ import annotations

import types

import pytest

from perfbench import program_spans, readers
from repro_torch.serving.engine import RequestTimes

ORIGIN = 100.0          # the tracer's origin, in host seconds


def rec(name, start, end, dev=None):
    """A closed span's record, host [start, end] seconds after the
    window opens; ``dev``: its device interval."""
    r = {"name": name, "cat": "serve", "ph": "X", "ts": start * 1e6,
         "dur": (end - start) * 1e6, "depth": 0, "args": {}}
    if dev is not None:
        r["dev_ts"], r["dev_dur"] = dev[0] * 1e6, (dev[1] - dev[0]) * 1e6
    return r


def make_run(records, ops, lifecycle=None, engine=True):
    """A run whose window is [ORIGIN, ORIGIN + 10] s, traced over its
    first 4 s; records and ops are given in seconds after the window
    opens."""
    tr = types.SimpleNamespace(records=records, origin=ORIGIN, dropped=0,
                               resolve=lambda: None)
    eng = types.SimpleNamespace(tracer=tr, lifecycle=lifecycle or {}) \
        if engine else types.SimpleNamespace()
    srv = types.SimpleNamespace(engine=eng, steps=[], admits=[], reqs={},
                                cfg={}, mix={})
    shifted = None if ops is None else \
        [(n, ORIGIN + s, ORIGIN + e) for n, s, e in ops]
    return readers.Run(srv, ORIGIN, ORIGIN + 10.0, 1.0, shifted,
                       t_trace=ORIGIN + 4.0)


def moe_layer(t, experts_shift=0.0, shared=False):
    """One MoE layer call at ``t``: 1 ms each of routing, dispatch and
    combine kernels around 7 ms of expert kernels (and 2 ms of shared
    experts), the spans on them."""
    parts = [("moe.route", t, t + 0.001), ("moe.dispatch", t + 0.001,
                                            t + 0.002),
             ("moe.experts", t + 0.002, t + 0.009),
             ("moe.combine", t + 0.009, t + 0.010)]
    if shared:
        parts.append(("moe.shared", t + 0.010, t + 0.012))
    end = parts[-1][2]
    ops = [("moe_router_kernel" if n == "moe.route" else "k_" + n, s, e)
           for n, s, e in parts]
    recs = [rec("ffn.moe", t, end, (t, end))]
    for n, s, e in parts:
        d = experts_shift if n == "moe.experts" else 0.0
        recs.append(rec(n, s, e, (s + d, e + d)))
    return recs, ops


def chat_run(experts_shift=0.0):
    """Two decode steps, each with one MoE layer; a prefill with one
    whose routing kernel runs 3 ms."""
    recs, ops = [], []
    for t in (1.0, 2.0):
        recs.append(rec("step", t, t + 0.05, (t, t + 0.05)))
        r, o = moe_layer(t + 0.01, experts_shift)
        recs += r
        ops += o
    recs.append(rec("prefill", 3.0, 3.1, (3.0, 3.1)))
    ops += [("k_route", 3.0, 3.003), ("k_experts", 3.003, 3.010)]
    recs += [rec("ffn.moe", 3.0, 3.01, (3.0, 3.01)),
             rec("moe.route", 3.0, 3.003, (3.0, 3.003)),
             rec("moe.experts", 3.003, 3.01, (3.003, 3.01))]
    return make_run(recs, ops)


def test_decode_dispatch_ms_is_the_median_traced_span():
    recs = [rec("decode.dispatch", 1.0, 1.030),
            rec("decode.dispatch", 2.0, 2.050),
            rec("decode.dispatch", 3.0, 3.040),
            rec("prefill.dispatch", 3.5, 3.9),
            rec("decode.dispatch", 5.0, 5.1)]     # after the traced part
    assert program_spans.decode_dispatch_ms(make_run(recs, [])) == \
        pytest.approx(40.0)


def test_idle_dispatch_share_counts_idle_inside_dispatch_only():
    recs = [rec("decode.dispatch", 1.0, 1.1),
            rec("prefill.dispatch", 2.0, 2.2),
            rec("decode.sample", 1.1, 1.5)]      # idle here is not counted
    ops = [("gemm", 1.05, 1.5), ("gemm", 2.0, 2.1), ("gemm", 3.0, 3.5)]
    # idle inside dispatch: 0.05 s + 0.1 s of the 4 traced seconds
    assert program_spans.idle_dispatch_share(make_run(recs, ops)) == \
        pytest.approx(100 * 0.15 / 4)


def test_queue_wait_p95_reads_the_requests_that_started_in_the_window():
    life = {u: RequestTimes(ORIGIN + u, ORIGIN + u + 0.01 * u,
                            ORIGIN + u + 0.5) for u in range(1, 10)}
    life[99] = RequestTimes(ORIGIN - 5, ORIGIN + 11)     # after the window
    life[98] = RequestTimes(ORIGIN + 1)                   # still queued
    got = program_spans.queue_wait_p95_ms(make_run([], None, life))
    waits = sorted(10.0 * u for u in range(1, 10))
    assert got == pytest.approx(waits[-2] + 0.6 * (waits[-1] - waits[-2]))


def test_moe_dispatch_share_over_the_steps_and_the_prefills():
    run = chat_run()
    # decode: 3 of the layer's 10 busy ms in routing, dispatch, combine
    assert program_spans.moe_dispatch_share(run, "step") == \
        pytest.approx(30.0)
    # the prefill's layer: 3 of 10 ms routing
    assert program_spans.moe_dispatch_share(run, "prefill") == \
        pytest.approx(30.0)


def test_moe_share_counts_the_shared_experts_as_experts():
    recs, ops = moe_layer(1.0, shared=True)
    recs.append(rec("step", 1.0, 1.05, (1.0, 1.05)))
    assert program_spans.moe_dispatch_share(make_run(recs, ops), "step") \
        == pytest.approx(25.0)


def test_an_experts_span_off_its_kernels_moves_the_moe_share():
    calm = program_spans.moe_dispatch_share(chat_run(), "step")
    # shifted 20 ms, past the layer, onto no kernel: the experts' busy
    # time drops out of the layer
    off = program_spans.moe_dispatch_share(chat_run(0.02), "step")
    assert calm == pytest.approx(30.0) and off == pytest.approx(100.0)


def test_the_traces_drift_is_taken_out_against_the_routing_kernels():
    """Operations on a clock running 5,000 ppm fast, tied at the trace's
    end (as the profiler's can be): the MoE share is read as on the
    program's clock, and each operation comes back to its time."""
    recs, ops = [], []
    for i in range(12):
        t = 0.3 + 0.3 * i
        recs.append(rec("step", t, t + 0.05, (t, t + 0.05)))
        r, o = moe_layer(t + 0.01)
        recs += r
        ops += o
    end, rate = 4.0, 5e-3
    drifted = [(n, s + rate * (s - end), e + rate * (e - end))
               for n, s, e in ops]
    run = make_run(recs, drifted)
    assert program_spans.moe_dispatch_share(run, "step") == \
        pytest.approx(30.0)
    back = program_spans.on_program_clock(run, run.srv.engine.tracer)
    for (_, s, e), (_, s2, e2) in zip(ops, back):
        assert s2 - ORIGIN == pytest.approx(s, abs=1e-9)
        assert e2 - ORIGIN == pytest.approx(e, abs=1e-9)
    # seven layers route too few tokens to fit by: uncorrected, their
    # kernels miss their spans by 9 to 18 ms
    few = make_run(recs[:7 * 6], drifted[:7 * 4])
    assert program_spans.on_program_clock(few, few.srv.engine.tracer) \
        is few.ops
    assert program_spans.moe_dispatch_share(few, "step") != \
        pytest.approx(30.0)


def test_coverage_of_the_calls_and_the_moe_layers():
    run = chat_run()
    run.srv.steps = [(ORIGIN + 1.0, ORIGIN + 1.06, []),
                     (ORIGIN + 2.0, ORIGIN + 2.06, [])]
    run.srv.engine.tracer.records += [
        rec("decode.dispatch", 1.001, 1.04),
        rec("decode.dispatch", 2.001, 2.07)]     # past its bracket
    got = program_spans.coverage(run)
    assert got["busy_in_calls"] == pytest.approx(1.0)
    assert got["moe_layers"] == 3
    assert got["moe_parts_over_layer_min"] == pytest.approx(1.0)
    assert got["dispatch_outside_step"] == 1
    # a kernel outside every call: 30 of 63 busy ms inside them
    run.ops.append(("stray", ORIGIN + 3.5, ORIGIN + 3.5 + 0.033))
    assert program_spans.coverage(run)["busy_in_calls"] == \
        pytest.approx(0.030 / 0.063)


@pytest.mark.parametrize("name", ["decode_dispatch_ms",
                                  "idle_dispatch_share",
                                  "queue_wait_p95_ms", "moe_dispatch_share",
                                  "coverage"])
def test_a_program_without_spans_reads_none(name):
    fn = getattr(program_spans, name)
    args = ("step",) if name == "moe_dispatch_share" else ()
    assert fn(make_run([], [("gemm", 1.0, 2.0)], engine=False), *args) \
        is None
    if name not in ("decode_dispatch_ms", "queue_wait_p95_ms"):
        # an untraced run: no device operations to read
        assert fn(make_run(chat_run().srv.engine.tracer.records, None),
                  *args) is None
