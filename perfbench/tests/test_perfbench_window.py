"""The window's arithmetic on a simulated closed loop: a stall inside the
window moves every end-to-end metric the worse way, and what lies
outside the window does not count."""
from __future__ import annotations

import types

import pytest

from perfbench import readers, stats
from perfbench.serve import Req


def simulate(stall=(0.0, 0.0), slow=3.0, seconds=10.0, clients=4):
    """A closed loop of ``clients`` requests of 100 prompt tokens and 6
    new ones: an admission pass takes 0.03 s a request, a step 0.05 s;
    both take ``slow`` times longer between the ``stall`` times."""
    srv = types.SimpleNamespace(reqs={}, steps=[], admits=[],
                                mix={"cache_len": 128}, cfg={})
    t, n = -1.0, 0
    waiting, active = [], {}

    def took(d):
        return d * slow if stall[0] <= t < stall[1] else d

    for _ in range(clients):
        srv.reqs[n] = Req(n, [1] * 100, 6, t)
        waiting.append(n)
        n += 1
    while t < seconds + 1:
        if waiting:
            t0 = t
            t += took(0.03 * len(waiting))
            srv.admits.append((t0, t, 100 * len(waiting), list(waiting)))
            for u in waiting:
                srv.reqs[u].times.append(t)
                active[u] = 1
            waiting = []
        t0 = t
        t += took(0.05)
        srv.steps.append((t0, t, [100 + len(srv.reqs[u].times)
                                  for u in active]))
        for u in list(active):
            r = srv.reqs[u]
            r.times.append(t)
            if len(r.times) == r.max_new:
                r.done = True
                del active[u]
                srv.reqs[n] = Req(n, [1] * 100, 6, t)
                waiting.append(n)
                n += 1
    return readers.Run(srv, 0.0, seconds, 1.0)


E2E = {"output_tok_s": (readers.output_tok_s, "higher"),
       "ttft_p95_ms": (lambda r: readers.ttft_ms(r, 95), "lower"),
       "itl_p95_ms": (lambda r: readers.itl_ms(r, 95), "lower"),
       "prefill_tok_s": (readers.prefill_tok_s, "higher")}


@pytest.mark.parametrize("name", sorted(E2E))
def test_a_stall_in_the_window_moves_the_metric(name):
    fn, better = E2E[name]
    calm, stalled = fn(simulate()), fn(simulate(stall=(3.0, 6.0)))
    assert (stalled < calm) if better == "higher" else (stalled > calm)


@pytest.mark.parametrize("name", sorted(E2E))
def test_a_stall_outside_the_window_does_not(name):
    fn, _ = E2E[name]
    assert fn(simulate()) == pytest.approx(
        fn(simulate(stall=(10.5, 20.0))))


def test_window_counts():
    run = simulate()
    # every token handed out in [0, 10] s counts, none outside
    inside = sum(1 for r in run.srv.reqs.values() for t in r.times
                 if 0.0 <= t <= 10.0)
    assert readers.output_tok_s(run) == pytest.approx(inside / 10.0)
    assert readers.decode_step_ms(run) == pytest.approx(50.0)


def test_percentile_and_union():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([1, 2, 3, 4], 95) == pytest.approx(3.85)
    assert stats.percentile([], 95) is None
    assert stats.union([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    assert stats.covered([(0, 1), (0.5, 2), (3, 4)], 1, 3.5) == \
        pytest.approx(1.5)


def test_trace_reduction_names_gaps_by_host_span():
    from perfbench import trace
    ops = [("gemm", 0.0, 1.0), ("flash_attention_wgmma_kernel", 0.5, 2.0),
           ("gemm", 3.0, 3.5)]
    spans = [("step", 0.0, 2.1), ("admit", 2.1, 3.6)]
    busy, top, gaps = trace.reduce(ops, 0.0, 4.0, spans)
    assert busy == pytest.approx(2.5)
    assert top[0] == ["gemm", 1.5]
    assert gaps == [["admit", 1.0], ["client", 0.5]]
    assert trace.by_kind(ops, 0.0, 4.0) == {"gemm": 1.5, "port": 1.5}


class _Ev:
    def __init__(self, name, start_ns, dur_ns):
        self._n, self._s, self._d = name, start_ns, dur_ns

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _trace(events, marks):
    from perfbench import trace
    tr = trace.DeviceTrace()
    tr.marks = marks
    tr.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return tr


def test_trace_is_tied_to_the_host_by_its_closing_marker():
    ev = [_Ev("spin_kernel", 1_000_000_000, 10), _Ev("gemm", 2_000_000_000,
                                                     500_000_000),
          _Ev("spin_kernel", 9_000_000_500, 10)]
    ops, drift = _trace(ev, [0.5, 8.5]).events()
    # host 8.5 s is device 9.0000005 s: the gemm ran at host 1.4999995 s
    assert ops == [("gemm", pytest.approx(1.4999995),
                    pytest.approx(1.9999995))]
    assert drift == pytest.approx(0.0000005, abs=1e-9)
    ops, drift = _trace(ev[1:], [0.5, 8.5]).events()
    assert drift is None and len(ops) == 1


def test_trace_without_its_closing_marker_is_refused():
    ev = [_Ev("spin_kernel", 1_000_000_000, 10), _Ev("gemm", 2_000_000_000,
                                                     500_000_000)]
    with pytest.raises(RuntimeError):
        _trace(ev, [0.5, 8.5]).events()
