"""Exchange-schedule sweep: one spec_grid over schedules (sync vs stale
vs stale+partial), one run_grid call, one lane batch shared by every
schedule lane (``repro_torch.schedule``).  The twin of
``examples/staleness_sweep.py``.

  PYTHONPATH=src python -m repro_torch.examples.staleness_sweep
"""
import argparse

from repro_torch.api import run_grid, spec_grid

SCHEDULES = ("sync", "stale_k:2", "stale_k:4+partial:0.8")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    specs = spec_grid(datasets=("titanic",), modes=("devertifl",),
                      client_counts=(3,), seeds=(0, 1),
                      schedules=SCHEDULES, rounds=2, epochs=2)
    grid = run_grid(specs, device=args.device)
    for sched in SCHEDULES:
        cell = grid["cells"][f"titanic/devertifl/{sched}/3"]
        print(f"{sched:24s} f1={cell['f1_mean']:.3f} "
              f"(spec {cell['spec_hash']})")
    return {"specs": specs, "grid": grid}


if __name__ == "__main__":
    main()
