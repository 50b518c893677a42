"""Table II: De-VertiFL vs literature configurations, the twin of
``benchmarks/table2.py`` on ``repro_torch.api``.

  PyVertical row: MNIST, 2 participants          (accuracy)
  Flower row:     Titanic, 3 participants        (accuracy)
  SplitNN row:    Bank Marketing, 2 participants (F1)

Each literature framework is represented by the SplitNN-style
centralized split learning (``mode="splitnn"``) under the SAME
participant count and round budget, against De-VertiFL under identical
conditions.  Both sides of a row are the reference's specs; each row
records both specs' hashes.  The draws are the port's (torch
generators), not the reference's threefry streams, so its rows sit
beside ``benchmarks/results/table2.json``, not bit for bit on it.

    python -m repro_torch.bench.table2 [--seeds 0 1 2] [--out PATH]
                                       [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.api import ExperimentSpec, build
from repro_torch.bench import RESULTS

# (row name, dataset, n_clients, rounds, epochs, metric)
CASES = (
    ("mnist_vs_pyvertical", "mnist", 2, 10, 5, "acc"),
    ("titanic_vs_flower", "titanic", 3, 150, 1, "acc"),
    ("bank_vs_splitnn", "bank", 2, 20, 10, "f1"),
)


def run(seeds=(0,), device=None, out=None, cases=CASES):
    """Every row of ``cases`` on ``device`` (CUDA unless named); writes
    the table's JSON to ``out`` (default build/torch_results/
    table2.json) and returns the rows (name, microseconds, reading)."""
    rows, table = [], {}
    for name, ds, nc, rounds, epochs, metric in cases:
        t0 = time.time()
        n_samples = 6000 if ds in ("mnist", "fmnist") else None
        fed_spec = ExperimentSpec(
            dataset=ds, mode="devertifl", n_clients=nc, rounds=rounds,
            epochs=epochs, seeds=seeds, n_samples=n_samples,
            eval_every=0)   # final metrics only, as the sweep cell does
        base_spec = fed_spec.replace(mode="splitnn", seeds=(0,))
        fed = build(fed_spec, device=device).run()
        base = build(base_spec, device=device).run()
        dt = time.time() - t0
        fm = fed.metrics
        table[name] = {
            "devertifl": {"f1": fm["f1"], "acc": fm["acc"],
                          "f1_std": fm.get("f1_std", 0.0),
                          "seeds": list(seeds),
                          "spec_hash": fed.spec_hash},
            "split_baseline": dict(base.metrics,
                                   spec_hash=base.spec_hash),
            "metric": metric,
        }
        rows.append((f"table2/{name}/devertifl", dt * 1e6,
                     f"{metric}={fm[metric]:.3f}"))
        rows.append((f"table2/{name}/baseline", dt * 1e6,
                     f"{metric}={base.metrics[metric]:.3f}"))
    out = Path(out) if out is not None else RESULTS / "table2.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(table, indent=1))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", default=None, help="the JSON's path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    for r in run(tuple(args.seeds), device=args.device, out=args.out):
        print(",".join(str(x) for x in r))


if __name__ == "__main__":
    main()
