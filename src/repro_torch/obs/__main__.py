"""``python -m repro_torch.obs`` -- run a (small) spec with taps and
tracing armed and render what it measured: the metrics/telemetry
table, the recorded per-round series, the span timeline, and optionally
the Chrome trace-event export and a serving Prometheus scrape.  The port
of ``python -m repro.obs``; it runs on CUDA unless given ``--device``.

    python -m repro_torch.obs                        # a small smoke run
    python -m repro_torch.obs --device cpu           # off the GPU
    python -m repro_torch.obs --obs full --rounds 5 \\
        --trace-out trace.json                       # open in Perfetto
    python -m repro_torch.obs --serve 8 --prom       # serving metrics
    python -m repro_torch.obs --schedule stale_k:1 --fault crash:0.2 \\
        --transform int8                             # the full stack
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Run a small experiment with observability armed "
                    "and render its telemetry.")
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--n-samples", type=int, default=512,
                   help="dataset size cap (small default keeps the "
                        "CLI a smoke run)")
    p.add_argument("--obs", default="full",
                   help="obs level: none | basic | full (default "
                        "full; 'none' renders only the legacy "
                        "timings)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--n-clients", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--schedule", default="sync")
    p.add_argument("--fault", default="none")
    p.add_argument("--transform", default="none")
    p.add_argument("--serve", type=int, default=0, metavar="N",
                   help="after training, serve N held-out entities "
                        "and include the serving telemetry")
    p.add_argument("--prom", action="store_true",
                   help="print the Prometheus text exposition for the "
                        "serving session (implies --serve 4 if "
                        "--serve not given)")
    p.add_argument("--trace-out", default=None,
                   help="write the Chrome trace-event JSON here "
                        "(load in ui.perfetto.dev)")
    p.add_argument("--profile-dir", default=None,
                   help="also capture a torch.profiler trace into this "
                        "directory")
    p.add_argument("--device", default="cuda",
                   help="the device to run on (default cuda; cpu runs "
                        "the kernels' plain versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.prom and not args.serve:
        args.serve = 4

    from repro_torch.api import ExperimentSpec, build
    from repro_torch.obs import metrics_table, prometheus_text

    spec = ExperimentSpec(
        dataset=args.dataset, mode="devertifl", obs=args.obs,
        rounds=args.rounds, n_clients=args.n_clients,
        batch_size=args.batch_size, n_samples=args.n_samples,
        schedule=args.schedule, fault=args.fault,
        transform=args.transform, eval_every=0)
    sess = build(spec, device=args.device)

    with sess.tracer.profile_to(args.profile_dir, device=sess.device):
        res = sess.run()

    print(metrics_table(res))
    tel = res.telemetry
    if tel is not None and tel.series is not None:
        print("\nper-round series")
        for k in sorted(tel.series):
            a = np.asarray(tel.series[k])
            row = a if a.ndim == 1 else a.mean(axis=1)
            print(f"  {k:<14} " + " ".join(
                f"{v:9.4f}" for v in row[:args.rounds]))

    if args.serve:
        from repro_torch.api import ServeRequest, split_features
        lay = sess.federation.layout
        xte = np.asarray(sess.federation.xte)
        reqs = [ServeRequest(uid=f"cli-{i}", entity_id=f"e{i}",
                             slices=split_features(
                                 lay, xte[i % len(xte)]))
                for i in range(args.serve)]
        report = sess.serve(reqs)
        c = report.counters
        print(f"\nserving: {c['completed']}/{c['submitted']} "
              f"completed, p50 "
              f"{report.latency_ms.get('p50', 0.0):.2f} ms, "
              f"{report.throughput_rps:.0f} rps")
        if args.prom:
            print("\n" + prometheus_text(report), end="")

    print("\nspan timeline")
    print(sess.tracer.summary())
    if args.trace_out:
        path = sess.tracer.export(args.trace_out)
        print(f"\ntrace written: {path} (open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
