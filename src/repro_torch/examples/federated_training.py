"""The paper in one script: De-VertiFL vs non-federated training on the
synthetic MNIST stand-in with vertically partitioned features, driven
by the declarative ``repro_torch.api`` front door.  The twin of
``examples/federated_training.py``.

  PYTHONPATH=src python -m repro_torch.examples.federated_training \\
      --clients 5

Each comparison side is one ExperimentSpec; ``build(spec).run()`` picks
the engine -- a standalone federation for one seed, the seeds as lanes
of one sweep cell for ``--seeds k`` > 1 -- and returns a RunResult with
mean +/- std F1.

  --smoke runs the reduced configuration (titanic, 2 rounds).
  --first-layer kernel is the reference's "pallas" lane: the
  hand-written vfl_matmul kernel (auto picks it where CUDA is
  available, slice elsewhere).
"""
import argparse

from repro_torch.api import ExperimentSpec, build


def report(name, rr):
    m = rr.metrics
    if "f1_std" in m:
        print(f"  {name:14s} F1={m['f1']:.3f} +/- {m['f1_std']:.3f}  "
              f"({rr.timings['steps_per_sec']:.0f} steps/s across "
              f"{len(rr.spec.seeds)} federations)")
    else:
        for h in rr.history[:: max(1, rr.spec.rounds // 5)]:
            print(f"  round {h['round']:3d}  F1={h['f1']:.3f}  "
                  f"loss={h['loss']:.3f}")
        print(f"  {name:14s} final F1={m['f1']:.3f}  acc={m['acc']:.3f}")
    return m["f1"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "fmnist", "titanic", "bank"])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--engine", default="scan",
                    choices=["scan", "python"],
                    help="scan and python run the same per-batch loop "
                         "here (the names are the reference's)")
    ap.add_argument("--first-layer", default="auto",
                    choices=["auto", "kernel", "slice", "masked"],
                    help="first-layer strategy: slice/kernel read only "
                         "each client's contiguous feature slice; masked "
                         "is the paper-literal zero-padding reference; "
                         "auto = kernel on CUDA, slice elsewhere")
    ap.add_argument("--seeds", type=int, default=1,
                    help=">1 runs the seeds as lanes of one sweep cell")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config: titanic, 3 clients, "
                         "2 rounds x 1 epoch, 2 seeds (~seconds)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.dataset, args.clients = "titanic", 3
        args.rounds, args.epochs, args.seeds = 2, 1, 2

    n = 6000 if args.dataset in ("mnist", "fmnist") else None
    try:
        spec = ExperimentSpec(
            dataset=args.dataset, mode="devertifl",
            n_clients=args.clients, rounds=args.rounds,
            epochs=args.epochs, n_samples=n, engine=args.engine,
            first_layer=args.first_layer,
            seeds=tuple(range(args.seeds)))
    except ValueError as e:
        ap.error(str(e))    # e.g. --seeds >1 with --engine python

    print(f"De-VertiFL: {args.clients} clients, {args.dataset}, "
          f"{args.rounds} rounds x {args.epochs} epochs "
          f"[engine={spec.engine}, seeds={spec.seeds}, "
          f"spec={spec.spec_hash}]")
    fed = build(spec, device=args.device).run()
    fed_f1 = report("devertifl", fed)

    print("non-federated baseline (no exchange, no FedAvg):")
    non = build(spec.replace(mode="non_federated", fedavg=False),
                device=args.device).run()
    non_f1 = report("non-federated", non)

    gain = fed_f1 - non_f1
    print(f"collaboration gain: {gain:+.3f} F1 "
          f"({'matches' if gain > 0 else 'CONTRADICTS'} the paper's claim)")
    return {"devertifl": fed, "non_federated": non}


if __name__ == "__main__":
    main()
