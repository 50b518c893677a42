"""Wire-transform tradeoff: one spec_grid over exchange transforms (raw
vs int8 vs topk+int8+dp), one run_grid call, one lane batch shared by
every transform lane (``repro_torch.wire``), bytes on the wire read
straight from the per-cell telemetry.  The twin of
``examples/wire_tradeoff.py``.

  PYTHONPATH=src python -m repro_torch.examples.wire_tradeoff [--smoke]
"""
import argparse

from repro_torch.api import run_grid, spec_grid

TRANSFORMS = ("none", "int8", "topk:0.5+int8+dp:0.1")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="1 round, 1 seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    specs = spec_grid(datasets=("titanic",), modes=("devertifl",),
                      client_counts=(3,), transforms=TRANSFORMS,
                      seeds=(0,) if args.smoke else (0, 1),
                      rounds=1 if args.smoke else 3, epochs=2)
    grid = run_grid(specs, device=args.device)
    for t in TRANSFORMS:
        cell = grid["cells"][f"titanic/devertifl/{t}/none/sync/3"]
        w = cell["wire"]
        print(f"{t:24s} f1={cell['f1_mean']:.3f} bytes="
              f"{w['encoded_bytes']}/{w['raw_bytes']} "
              f"(spec {cell['spec_hash']})")
    return {"specs": specs, "grid": grid}


if __name__ == "__main__":
    main()
