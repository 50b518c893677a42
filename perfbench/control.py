"""The readings the correctness limits are set from, for several seeds in
one process (the benchmark's own runs never run this):

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
        --seconds 10 [--control fp8|none] [--routes] [--out FILE]

For each seed: the cell's set-up and a window of ``--seconds``, then the
check of ``check.py`` twice on the same requests and states: the
program's numbers (sound runs: the lower readings), and those of the
reference put in the program's place in float8 e4m3 (the control: the
upper readings).  ``--routes`` also reads how far the program's router
logits lie from the reference's, layer by layer, on two prompts of the
window (the program's own router, recorded through its ``route`` hook
after the window), and the shares of the reference's top-k margins (its
k-th router logit less its (k+1)-th) under a few sizes: how often a
pick can flip between bf16 and float32.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from perfbench import run as harness  # noqa: E402

MARGINS = (1e-3, 3e-3, 1e-2, 3e-2)


def routes(srv, uids):
    """Per MoE layer: the largest |program - reference| router logit, and
    the shares of the reference's k-th minus (k+1)-th margins under each
    of ``MARGINS``."""
    import torch
    from repro_torch.kernels.moe_router import moe_router
    from perfbench.reference import model as ref
    cfg = srv.cfg
    k = cfg["num_experts_per_tok"]
    out = []
    for uid in uids:
        ids = torch.tensor(srv.reqs[uid].prompt,
                           device=srv.params["final_norm"]["scale"].device)
        got = []

        def record(logits, kk):
            got.append(logits.float().clone())
            return moe_router(logits, kk)
        srv.model.hooks["route"] = record
        try:
            srv.model.prefill(srv.params, {"tokens": ids[None]},
                              cache_len=ids.shape[0])
        finally:
            del srv.model.hooks["route"]
        want = []
        ref.prefill(srv.params, cfg, ids, log=want)
        for layer, (g, w) in enumerate(zip(got, want)):
            top = torch.sort(w, dim=-1, descending=True).values
            margin = top[:, k - 1] - top[:, k]
            out.append({"uid": uid, "moe_layer": layer,
                        "max_abs_diff": float((g - w).abs().max()),
                        "p99_abs_diff": float(torch.quantile(
                            (g - w).abs().flatten()[:1 << 20], 0.99)),
                        "margin_under": {str(m): float((margin < m).float()
                                                       .mean())
                                         for m in MARGINS}})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default="fp8",
                    help="the control's precision; 'none': the program's "
                    "readings alone")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness._paths()
    cell, conf, mix, spec, e2e, _ = harness.load_cell(args.workload)
    import torch
    from perfbench import check, readers
    from perfbench.serve import Server
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None
    on_card = args.device == "cuda"
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        srv = Server(conf, mix, seed, args.device)
        srv.make(mix["pool"] + mix["clients"])
        srv.warm_up()
        srv.fill()
        if on_card:
            torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        t_open, t_close, _ = srv.window(args.seconds)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        run = readers.Run(srv, t_open, t_close, setup)
        metrics = {n: harness.reader("e2e", n)(run) for n in e2e}
        t1 = time.perf_counter()
        others = {} if args.control == "none" else {"control": args.control}
        got, mismatch = check.run(srv, t_open, seed, spec, others, raw=True)
        check_s = time.perf_counter() - t1
        row = {"workload": args.workload, "seed": seed,
               "setup_s": setup, "window_s": t_close - t_open,
               "check_s": check_s, "memory_peak_bytes": peak,
               "metrics": metrics, "mismatch": mismatch[:10],
               "program": got["program"], "control": got.get("control")}
        if args.routes:
            live = [u for u in srv.by_slot if u is not None]
            row["routes"] = routes(srv, sorted(live)[:2])
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        del srv, run
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if harness.loaded_forbidden():
        print(f"loaded: {harness.loaded_forbidden()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
