"""Federated-mode dry run: the cross-pod bytes of the De-VertiFL
production protocol against a synchronous data-parallel step, at 2
pods, each pod a super-client with its own weight replica (the port of
``repro.launch.dryrun_federated``).

The reference lowers both steps on a (pod=2, data=16, model=16) TPU
mesh and reads the collectives that cross pods from the HLO.  One card
has no such program, so this counts them from the parameter tree, built
on the meta device (``"method": "tree"``):

  standard   every step a ring all-reduce of the gradient tree across
             the g = 2 pods: 2 * P * (g - 1) / g bytes a step
  federated  local steps touch nothing across pods; every
             ``fedavg_every`` steps FedAvg all-reduces the parameters
             (``launch/train.py``; Algorithm 1 lines 16-19), the
             optimizer state stays local

with P the tree's bytes (gradients have the parameters' dtypes).  Only
the cross-pod collectives are counted, so ``collective_total_GB`` is
each step's cross-pod all-reduce; the reference's also counts the
collectives inside a pod.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_federated \\
      --arch qwen1.5-0.5b

Writes ``build/federated/<arch>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves

RESULTS = Path(__file__).resolve().parents[3] / "build" / "federated"
N_PODS = 2


def ring_allreduce_bytes(nbytes, g):
    """Wire bytes of a ring all-reduce of ``nbytes`` over g members."""
    return 2 * nbytes * (g - 1) / g


def run(arch, fedavg_every=50):
    cfg = get_config(arch)
    params = build_model(cfg).init_meta()
    tree_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params))
    std = ring_allreduce_bytes(tree_bytes, N_PODS)     # the gradients
    sync = ring_allreduce_bytes(tree_bytes, N_PODS)    # the parameters
    out = {"arch": arch, "fedavg_every": fedavg_every, "method": "tree",
           "n_pods": N_PODS, "tree_bytes": tree_bytes}
    out["standard"] = {"collective_total_GB": std / 1e9,
                       "crosspod_GB": std / 1e9}
    out["federated"] = {
        "collective_total_GB": sync / 1e9,
        "crosspod_sync_GB": sync / 1e9,
        # the sync runs every fedavg_every steps
        "crosspod_amortized_GB_per_step": sync / 1e9 / fedavg_every,
    }
    amort = out["federated"]["crosspod_amortized_GB_per_step"]
    out["dci_reduction"] = (std / 1e9 / amort) if amort else float("inf")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--fedavg-every", type=int, default=50)
    args = ap.parse_args(argv)
    rec = run(args.arch, args.fedavg_every)
    os.makedirs(RESULTS, exist_ok=True)
    with open(RESULTS / f"{args.arch}.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
