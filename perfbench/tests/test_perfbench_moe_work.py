"""The MoE layer's yardstick and its two metrics (``moe_work.py``): the
experts' operations and bytes at hand-counted shapes; the dropless share
and the experts' roofline share on synthetic tracer records, a program
without the counters or the spans' arguments (the parent of the change
that added them) reading None; and a whole tiny cell on the CPU whose
MoE takes the dropless path reading 100, and 0 once it is made to fall
back to the padded path."""
from __future__ import annotations

import copy
import importlib.util

import pytest

from conftest import ROOT, TINY_MIX, tiny_conf
from perfbench import moe_work, peaks
from test_perfbench_program_spans import make_run, rec

SHAPE = {"rows": 384, "E": 64, "D": 2048, "F": 1408}


def _metric(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_experts_work_by_hand():
    # 2 rows of width 4 through 3 experts of width 5, float32
    assert moe_work.experts_work(2, 3, 4, 5, size=4) == \
        (6 * 2 * 4 * 5, 4 * (3 * 3 * 4 * 5 + 2 * 2 * 4))
    # a chat decode step's layer of deepseek-moe-16b: 384 pairs
    flops, nbytes = moe_work.experts_work(**SHAPE)
    assert flops == 6_643_777_536
    assert nbytes == 1_110_441_984
    # bound by its bytes: 0.33 ms of HBM against 6.7 us of bf16 operations
    assert nbytes / peaks.HBM_BYTES_PER_S > 40 * flops / \
        peaks.BF16_FLOP_PER_S


def counter(name, t, value):
    return {"name": name, "cat": "counter", "ph": "C", "ts": t * 1e6,
            "dur": 0.0, "depth": 0, "args": {"value": value}}


def test_dropless_share_sums_the_increments_in_the_traced_part():
    recs = [counter("moe_calls", 0.5, 1),                # eager, traced
            counter("moe_dropless_calls", 0.5, 1),
            counter("moe_calls", 0.6, 2),                # a padded call
            counter("moe_calls", 1.0, 29),               # a replay of 27
            counter("moe_dropless_calls", 1.0, 28),
            counter("moe_calls", 5.0, 56),               # after the part
            counter("moe_dropless_calls", 5.0, 55)]
    assert moe_work.dropless_share(make_run(recs, None)) == \
        pytest.approx(100.0 * 28 / 29)
    # readings before the window count only as the base of the next
    early = [counter("moe_calls", -1.0, 7),
             counter("moe_dropless_calls", -1.0, 7),
             counter("moe_calls", 1.0, 10),
             counter("moe_dropless_calls", 1.0, 10)]
    assert moe_work.dropless_share(make_run(early, None)) == 100.0
    padded = [counter("moe_calls", t, i + 1)
              for i, t in enumerate((0.5, 1.0, 2.0))]
    assert moe_work.dropless_share(make_run(padded, None)) == 0.0


def experts(start, end, dev, **args):
    r = rec("moe.experts", start, end, dev)
    r["args"] = args
    return r


def test_experts_roofline_reads_the_traced_steps_spans():
    recs = [rec("step", 1.0, 1.05, (1.0, 1.05)),
            experts(1.01, 1.02, (1.01, 1.02), **SHAPE),
            rec("step", 2.0, 2.05, (2.0, 2.05)),
            experts(2.01, 2.02, (2.01, 2.02), **SHAPE),
            # a prefill's layer: not a step's
            rec("prefill", 3.0, 3.1, (3.0, 3.1)),
            experts(3.01, 3.02, (3.01, 3.02), rows=6000, E=64, D=2048,
                    F=1408),
            # after the traced part
            rec("step", 5.0, 5.05, (5.0, 5.05)),
            experts(5.01, 5.02, (5.01, 5.02), **SHAPE)]
    # each step's kernels busy 0.5 ms of its experts' span
    ops = [("gemm", 1.011, 1.0115), ("gemm", 2.011, 2.0115),
           ("gemm", 3.011, 3.019), ("gemm", 1.03, 1.04)]
    run = make_run(recs, ops)
    run.cfg = {"dtype": "bfloat16"}
    _, nbytes = moe_work.experts_work(**SHAPE)
    want = 100.0 * 2 * nbytes / peaks.HBM_BYTES_PER_S / 0.001
    assert moe_work.experts_roofline(run) == pytest.approx(want)


def test_a_program_without_the_counters_or_arguments_reads_none():
    bare = [rec("step", 1.0, 1.05, (1.0, 1.05)),
            rec("moe.experts", 1.01, 1.02, (1.01, 1.02))]
    run = make_run(bare, [("gemm", 1.011, 1.012)])
    run.cfg = {"dtype": "bfloat16"}
    assert moe_work.dropless_share(run) is None
    assert moe_work.experts_roofline(run) is None
    # no spans at all, and an untraced run
    no_engine = make_run([], [("gemm", 1.0, 2.0)], engine=False)
    assert moe_work.dropless_share(no_engine) is None
    assert moe_work.experts_roofline(no_engine) is None
    untraced = make_run([experts(1.01, 1.02, (1.01, 1.02), **SHAPE)], None)
    assert moe_work.experts_roofline(untraced) is None


def _tiny_dropless_share(monkeypatch, padded):
    """The share a whole tiny deepseek cell reads at capacity factor 3.0
    (E / k = 8 / 3), its engine recording into an operator's tracer."""
    from perfbench import readers
    from perfbench.serve import Server
    from repro_torch.models import moe as M
    from repro_torch.obs.trace import SpanTracer
    if padded:
        monkeypatch.setattr(M, "_grouped_ok", lambda x: False)
    conf = tiny_conf("deepseek", dtype="float32")
    conf["model"]["expert_capacity_factor"] = 3.0
    srv = Server(conf, copy.deepcopy(TINY_MIX), 2**31 + 3, "cpu")
    srv.engine.tracer = SpanTracer()
    srv.engine._follow_profiler = False
    srv.make(TINY_MIX["pool"] + TINY_MIX["clients"])
    srv.warm_up()
    srv.fill()
    t_open, t_close, _ = srv.window(0.5)
    run = readers.Run(srv, t_open, t_close, 0.0)
    assert run.steps()
    return _metric("moe_dropless_share.chat")(run)


def test_a_tiny_dropless_cell_reads_100(monkeypatch):
    assert _tiny_dropless_share(monkeypatch, padded=False) == 100.0


def test_a_cell_fallen_back_to_the_padded_path_reads_0(monkeypatch):
    assert _tiny_dropless_share(monkeypatch, padded=True) == 0.0
