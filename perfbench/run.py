"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``configs/<config>.json``) and its traffic (``mixes/<traffic>.json``);
its metrics are the files ``e2e/<name>.py`` (``--trace 0``) and
``metrics/<name>.py`` (``--trace 1``) that ``BENCHMARK.json`` lists for
it, and its correctness limits are ``checks/<cell>.json``.  Set-up: the
kernels' libraries (built into ``build/torch_kernels/`` in the checkout
on the first run), the weights drawn on the card from the seed, a
warm-up prefill and decode step, every client's first request admitted.
Then the closed loop runs for ``--seconds``; a traced run records the
device's operations over the window.  After it, the check against the
plain reference (``check.py``), and one JSON line on standard output.
Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths():
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # one process, few threads: the serving loop computes nothing on the
    # host that a thread pool would speed up, and idle pool threads only
    # contend for the shared host's cores
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # every cache of the program and of its libraries inside the checkout
    cache = ROOT / "build" / "perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def load_cell(name):
    """(the cell, its configuration, its traffic mix, its check spec,
    its end-to-end and per-layer metric names) by the cell's name in
    ``BENCHMARK.json``."""
    from perfbench import check, loadgen
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((ROOT / entry["file"]).read_text())

    def mine(metrics):
        return [m["name"] for m in metrics
                if name in m.get("workloads", [name])]
    return (cell, conf, loadgen.load_mix(cell["traffic"]), check.load(name),
            mine(bench["end_to_end"]), mine(bench["per_layer"]))


def reader(kind, name):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device=None):
    """Runs the cell; returns (exit code, result or None).  ``device``
    other than None skips the look for a card (the tests' CPU runs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    cell, conf, mix, spec, e2e, layer = load_cell(args.workload)

    import torch
    from perfbench import check, peaks, readers, trace
    from perfbench.serve import Server

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2, None
        device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    on_card = torch.device(device).type == "cuda"

    marks = {"imports": time.perf_counter() - T_START}
    srv = Server(conf, mix, args.seed, device)
    marks["weights_and_engine"] = time.perf_counter() - T_START
    if srv.n_weights != conf["params"]:
        raise SystemExit(f"{conf['name']}: {srv.n_weights} weights drawn, "
                         f"the configuration states {conf['params']}")
    srv.make(mix["pool"] + mix["clients"])
    marks["requests_drawn"] = time.perf_counter() - T_START
    srv.warm_up()
    marks["warm_up"] = time.perf_counter() - T_START
    srv.fill()
    marks["first_requests"] = time.perf_counter() - T_START
    card = peaks.card() if on_card else (None, None)
    tracer = trace.DeviceTrace() if args.trace and on_card else None
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()       # set-up's objects out of the collector's way
    if tracer:
        tracer.start()
    setup_s = time.perf_counter() - T_START
    t_open, t_close, traced = srv.window(
        args.seconds, (trace.SECONDS, tracer.stop) if tracer else None)
    ops, t_trace = None, t_close
    if traced:
        t_trace = traced
        ops, drift = tracer.events()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    in_flight = {u for u, r in srv.reqs.items() if r.t_submit < t_open
                 and (not r.done or r.times[-1] >= t_open)}
    attempted = len(in_flight) + sum(1 for r in srv.reqs.values()
                                     if t_open <= r.t_submit <= t_close)
    run = readers.Run(srv, t_open, t_close, setup_s, ops, card, t_trace)
    names = layer if args.trace else e2e
    kind = "metrics" if args.trace else "e2e"
    metrics = {}
    units = _units()
    for name in names:
        value = reader(kind, name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    got, mismatch = check.run(srv, t_open, args.seed, spec)
    numbers, reported = got["program"]
    correct, rows = check.verdict(numbers, spec["limits"], mismatch)

    found = loaded_forbidden()
    if found:
        print(f"modules of {', '.join(found)} are loaded in this process",
              file=sys.stderr)
        return 3, None
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": 1, "memory_peak_bytes": peak,
           "power_limit_w": card[0]}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if ops is not None:
        busy, top, gaps = trace.reduce(ops, t_open, t_trace, srv.spans())
        dev.update(busy_s=busy, window_s=t_trace - t_open,
                   clock_drift_s=drift)
        result["breakdown"] = {"device_ops": top, "idle_gaps": gaps}
        reported["device_s_by_kind"] = trace.by_kind(ops, t_open, t_trace)
    result["reported"] = {**reported,
                          "decode_step_ms": readers.decode_step_ms(run),
                          "steps": len(run.steps()),
                          "setup_marks_s": marks,
                          "prefills": len(run.prefills())}
    if mismatch:
        result["reported"]["position_mismatch"] = mismatch[:10]
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    return 0, result


def _units():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


if __name__ == "__main__":
    code, result = main()
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    sys.exit(code)
