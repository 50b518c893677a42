"""How far the program's own spans account for the device's work, and
what recording them costs, for several seeds in one process (the
benchmark's own runs never run this):

    python3 perfbench/attribution.py --workload <cell> --seeds 1,2
        --seconds 20 --mode traced|always|off [--out FILE]

``traced``: the window as a ``--trace 1`` run has it (the device traced
over its first ``trace.SECONDS``, the engine recording exactly while the
profiler does): the metrics that read the program's spans, their
coverage (``program_spans.coverage``), whether the profiler read as
recording inside the traced part and not after it, and the records
held before, in and after it.  ``always``: the engine built with a
``SpanTracer`` of its own, recording through the whole window, no
device trace; ``off``: neither.  Both give the host-timed per-layer
metrics, whose difference is what recording costs.  One JSON line a
seed and mode.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from perfbench import run as harness  # noqa: E402

METRICS = ("decode_dispatch_ms.chat", "idle_dispatch_share.chat",
           "queue_wait_p95_ms.chat", "moe_dispatch_share.chat",
           "moe_dispatch_share.longdoc")


def _device_clock(start=None):
    """(host second, event) after a synchronise; given the start's, the
    host seconds between them less the events' (the device clock's
    drift)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    if start is None:
        return t, ev
    ev.synchronize()
    return (t - start[0]) - start[1].elapsed_time(ev) / 1e3


def alignment(run, tr):
    """The device's operations against the ``step`` device spans: µs
    from a span's start to its first operation (the tokens' copy to the
    device) and from its last operation's end to the span's end (the
    argmax's copy back, then the host's return), quantiles 10/50/90 over
    the first and the last third of the traced steps, the operations
    on the program's clock (``program_spans.on_program_clock``).  Both
    positive and steady across the trace when the two clocks agree."""
    from perfbench import program_spans, stats
    spans = sorted(program_spans.device(tr, ("step",), run.t_open,
                                        run.t_trace))
    ops = sorted((s, e) for _, s, e in program_spans.on_program_clock(run,
                                                                      tr))
    heads, tails = [], []
    for ds, de in spans:
        inside = [(s, e) for s, e in ops if s < de and e > ds]
        if inside:
            heads.append((inside[0][0] - ds) * 1e6)
            tails.append((de - max(e for _, e in inside)) * 1e6)
    n = len(heads) // 3

    def q(xs):
        return [stats.percentile(xs, p) for p in (10, 50, 90)]
    return {"steps": len(heads), "head_first": q(heads[:n]),
            "head_last": q(heads[-n:]), "tail_first": q(tails[:n]),
            "tail_last": q(tails[-n:])} if n else None


def one(conf, mix, seed, seconds, mode, device):
    import torch
    from torch._C._autograd import _profiler_enabled
    import repro_torch.serving as serving
    from repro_torch.obs.trace import SpanTracer
    from perfbench import program_spans, readers, trace
    from perfbench.serve import Server
    made = serving.ServingEngine
    if mode == "always":
        serving.ServingEngine = functools.partial(made, tracer=SpanTracer())
    try:
        t0 = time.perf_counter()
        srv = Server(conf, mix, seed, device)
    finally:
        serving.ServingEngine = made
    srv.make(mix["pool"] + mix["clients"])
    srv.warm_up()
    srv.fill()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    eng = srv.engine
    row = {"mode": mode, "seed": seed, "setup_s": setup,
           "records_before": len(eng.tracer.records)}
    dt = trace.DeviceTrace() if mode == "traced" else None
    probe = {}

    def stop():
        probe["enabled_inside"] = _profiler_enabled()
        probe["records_inside"] = len(eng.tracer.records)
        t = dt.stop()
        probe["enabled_after"] = _profiler_enabled()
        return t
    if dt:
        dt.start()
    clock = _device_clock()
    t_open, t_close, t_trace = srv.window(
        seconds, (trace.SECONDS, stop) if dt else None)
    # the device's event clock against the host's over the window
    row["event_clock_drift_s"] = _device_clock(clock)
    ops, drift = dt.events() if dt else (None, None)
    row["trace_clock_drift_s"] = drift
    run = readers.Run(srv, t_open, t_close, setup, ops, (None, None),
                      t_trace)
    row.update(probe, window_s=t_close - t_open,
               records_after=len(eng.tracer.records),
               dropped=eng.tracer.dropped,
               decode_step_ms=readers.decode_step_ms(run),
               prefill_ms_per_ktok=readers.prefill_ms_per_ktok(run),
               steps=len(run.steps()), prefills=len(run.prefills()))
    if dt:
        row["metrics"] = {n: harness.reader("metrics", n)(run)
                          for n in METRICS}
        row["coverage"] = program_spans.coverage(run)
        row["idle_share"] = readers.idle_share(run)
        row["alignment"] = alignment(run, eng.tracer)
    del srv, run, eng
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--mode", default="traced",
                    help="traced, always or off; several: comma-separated, "
                    "run in turn for each seed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness._paths()
    _, conf, mix, _, _, _ = harness.load_cell(args.workload)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    card = torch.cuda.get_device_name(0)
    modes = args.mode.split(",")
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        # alternate which mode runs first
        for mode in (modes if i % 2 == 0 else modes[::-1]):
            row = {"workload": args.workload, "card": card,
                   **one(conf, mix, seed, args.seconds, mode, "cuda")}
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
