"""Quickstart: the whole repo in one spec -> session -> metrics hop.
The twin of ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Declare the experiment as an ExperimentSpec (validated eagerly: typo a
dataset/mode/first_layer name and the error lists the registered
options), build a Session, run it.  The RunResult carries final
metrics, the per-round trajectory, a process-stable spec hash, and the
git SHA.  Runs in seconds; for the LM substrate demo see
``repro_torch.examples.quickstart_lm``.
"""
import argparse

from repro_torch.api import ExperimentSpec, build


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = ExperimentSpec(dataset="titanic", mode="devertifl", n_clients=3,
                          rounds=3, epochs=2, seeds=(0,))
    result = build(spec, device=args.device).run()

    print(f"spec {result.spec_hash}  git {result.git_sha}")
    for h in result.history:
        print(f"  round {h['round']}  loss={h['loss']:.3f}  "
              f"F1={h['f1']:.3f}")
    print(f"final: F1={result.metrics['f1']:.3f} "
          f"acc={result.metrics['acc']:.3f} "
          f"({result.timings['steps_per_sec']:.0f} steps/s)")
    return result


if __name__ == "__main__":
    main()
