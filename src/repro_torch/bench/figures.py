"""The paper's figures (F1 against participant count), the twin of
``benchmarks/figures.py`` on ``repro_torch.api``.

  Fig. 3: MNIST      De-VertiFL vs non-federated
  Fig. 4: FMNIST     De-VertiFL vs non-federated
  Fig. 5: Titanic    De-VertiFL vs non-federated
  Fig. 6: Bank       De-VertiFL vs non-federated
  Fig. 7: all four   De-VertiFL vs VertiComb-style backward exchange

The same synthetic stand-in datasets, round budgets and specs as the
reference (rounds scaled up on the ~10x smaller sets); ``--paper`` runs
clients 2..10 with seeds (0, 1, 2).  A multi-seed point runs its seeds
as lanes of one round (``core.sweep.run_cell``).

    python -m repro_torch.bench.figures [--paper] [--out-dir DIR]
                                        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.api import ExperimentSpec, build
from repro_torch.bench import RESULTS

_DATASET_SETTINGS = {
    "mnist": dict(rounds=15, epochs=5, n_samples=6000),
    "fmnist": dict(rounds=15, epochs=5, n_samples=6000),
    # paper: 1000 rounds x 1 epoch on 891 rows; scaled to 150
    "titanic": dict(rounds=150, epochs=1, n_samples=None),
    # paper: 20 rounds x 10 epochs; bank is easy -- keep as-is but on 8k
    "bank": dict(rounds=20, epochs=10, n_samples=8000),
}


def fig_curve(dataset, clients, modes=("devertifl", "non_federated"),
              seeds=(0,), settings=None, device=None):
    """One spec per (n_clients, mode) point (eval_every=0: the figures
    read final metrics only), each with its spec_hash."""
    st = dict(_DATASET_SETTINGS[dataset])
    st.update(settings or {})
    out = {m: [] for m in modes}
    for nc in clients:
        for mode in modes:
            spec = ExperimentSpec(dataset=dataset, n_clients=nc,
                                  mode=mode, seeds=seeds, eval_every=0,
                                  fedavg=(mode != "non_federated"), **st)
            m = build(spec, device=device).run().metrics
            out[mode].append({"n_clients": nc,
                              "f1_mean": m["f1"],
                              "f1_std": m.get("f1_std", 0.0),
                              "n_seeds": len(seeds),
                              "spec_hash": spec.spec_hash})
    return out


def run_figure(name, dataset, clients, modes, seeds, out_dir=None,
               device=None, settings=None):
    """One figure's curves, written to ``out_dir``/``name``.json
    (default build/torch_results/); returns its rows."""
    t0 = time.time()
    curve = fig_curve(dataset, clients, modes, seeds, settings, device)
    dt = time.time() - t0
    out_dir = Path(out_dir) if out_dir is not None else RESULTS
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.json").write_text(json.dumps(
        {"dataset": dataset, "curves": curve, "wall_s": round(dt, 1)},
        indent=1))
    rows = []
    for mode, pts in curve.items():
        for p in pts:
            rows.append((f"{name}/{mode}/n{p['n_clients']}",
                         dt * 1e6 / max(len(clients), 1),
                         f"f1={p['f1_mean']:.3f}"))
    return rows


def main(quick=True, paper=False, out_dir=None, device=None):
    clients = list(range(2, 11)) if paper else [2, 5, 9]
    t_clients = [c for c in clients if c <= 9]  # titanic: 9 features max
    seeds = (0, 1, 2) if paper else (0,)
    kw = dict(out_dir=out_dir, device=device)
    rows = []
    rows += run_figure("fig3_mnist", "mnist", clients,
                       ("devertifl", "non_federated"), seeds, **kw)
    rows += run_figure("fig4_fmnist", "fmnist", clients,
                       ("devertifl", "non_federated"), seeds, **kw)
    rows += run_figure("fig5_titanic", "titanic", t_clients,
                       ("devertifl", "non_federated"), seeds, **kw)
    rows += run_figure("fig6_bank", "bank", clients,
                       ("devertifl", "non_federated"), seeds, **kw)
    # Fig. 7: De-VertiFL vs VertiComb (backward exchange), one dataset
    # pair per family in quick mode
    fig7 = [2, 5, 9] if not paper else clients
    rows += run_figure("fig7_mnist_verticomb", "mnist", fig7,
                       ("devertifl", "verticomb"), seeds, **kw)
    rows += run_figure("fig7_bank_verticomb", "bank", fig7,
                       ("devertifl", "verticomb"), seeds, **kw)
    return rows


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper", action="store_true",
                    help="clients 2..10, seeds (0, 1, 2)")
    ap.add_argument("--out-dir", default=None,
                    help="where the figures' JSON go")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    for r in main(paper=args.paper, out_dir=args.out_dir,
                  device=args.device):
        print(",".join(str(x) for x in r))


if __name__ == "__main__":
    _cli()
