"""``python -m repro_torch.analysis`` -- the static-audit CLI.

Audits the registered mode x schedule x first-layer grid (or an explicit
subset), prints the JSON report to stdout (or ``--out``), a summary to
stderr, and exits 1 on any unwaived violation.  It runs on CUDA unless
``--device`` names another device.

    python -m repro_torch.analysis                      # full grid
    python -m repro_torch.analysis --device cpu         # on the CPU
    python -m repro_torch.analysis --smoke              # one combo a mode
    python -m repro_torch.analysis --modes devertifl \\
        --schedules sync stale_k:2 --first-layers slice
    python -m repro_torch.analysis --passes taint retrace
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.audit import ALL_PASSES, audit_combos


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static privacy/deadness/retrace audit of the traced "
                    "round of the port.")
    p.add_argument("--modes", nargs="+", default=None,
                   help="modes to audit (default: every registered "
                        "federated mode, deduped through aliases)")
    p.add_argument("--schedules", nargs="+", default=None,
                   help="schedule specs (default: the shipped "
                        "sync/stale_k/double_buffer/partial family; "
                        "non-sync run under devertifl only)")
    p.add_argument("--first-layers", nargs="+", default=None,
                   help="first-layer lanes (default: masked slice kernel)")
    p.add_argument("--faults", nargs="+", default=None,
                   help="fault plan specs (default: none plus a "
                        "crash+straggle+corrupt composite; non-none plans "
                        "run under devertifl only)")
    p.add_argument("--transforms", nargs="+", default=None,
                   help="wire transform specs (default: none plus the hot "
                        "int8+dp and topk compositions; non-none "
                        "transforms run under devertifl only)")
    p.add_argument("--passes", nargs="+", default=None,
                   choices=list(ALL_PASSES),
                   help="passes to run (default: all)")
    p.add_argument("--dataset", default="mnist",
                   help="dataset to trace against (default mnist)")
    p.add_argument("--n-clients", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="device to trace on (default: cuda)")
    p.add_argument("--no-lane-check", action="store_true",
                   help="skip the sweep lane comparison (the slowest "
                        "single check)")
    p.add_argument("--smoke", action="store_true",
                   help="minimal subset: one combo per mode, sync "
                        "schedule, slice first layer, no lane check")
    p.add_argument("--out", default=None,
                   help="write the JSON report here instead of stdout")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the stderr progress/summary")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    kw = dict(modes=args.modes, schedules=args.schedules,
              first_layers=args.first_layers, faults=args.faults,
              transforms=args.transforms, passes=args.passes,
              dataset=args.dataset, n_clients=args.n_clients,
              lane_check=not args.no_lane_check, device=args.device)
    if args.smoke:
        kw["schedules"] = args.schedules or ("sync",)
        kw["first_layers"] = args.first_layers or ("slice",)
        kw["faults"] = args.faults or ("none",)
        kw["transforms"] = args.transforms or ("none",)
        kw["lane_check"] = False

    def progress(msg):
        if not args.quiet:
            print(msg, file=sys.stderr, flush=True)

    report = audit_combos(progress=progress, **kw)
    text = report.to_json()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    else:
        print(text)
    if not args.quiet:
        print(report.summary(), file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
