"""The retrace-hazard linter (pass 3 of three); the port of
``repro.analysis.retrace``.

A round that one captured program (a CUDA graph of the step, a compiled
trace) can replay must present the same signature every round, and the
sweep's lane batch must run one round body for every lane value.  Two
statically detectable hazards break that:

  carry-aval drift  a carried output (parameters, optimizer state,
                    schedule state) differs from its input in shape,
                    dtype or device: every round would present a new
                    signature.
  lane divergence   the sweep stacks lanes that differ in client count,
                    schedule, fault plan and seed into one round; if the
                    traced round secretly depends on a lane's value, one
                    captured program cannot serve every lane.

The lane check traces lane batches that differ only in the lanes' data
(client count 2 vs 3 padded to the same width, seed 0 vs 1, under sync,
under mixed stale/partial lanes and under fault lanes) and demands the
same normalized graph (``ir.normalized_code``): values ride constants,
so any difference is a structural specialization.  On the card the
batches run the kernel lane, whose offsets stay in tensors; on the CPU
the ``slice`` lane (``make_uniform_first_layer_fn``), because the
kernel's plain version reads its offsets on the host.

The reference's third hazard, a captured weak-typed scalar, has no
counterpart: a 0-d tensor never promotes a float32 tensor's dtype in
torch, so it is not checked.  ``static_round_traces == 1`` in the
report means both hazards are absent.
"""
from __future__ import annotations

import difflib
import itertools

import torch

from repro_torch.analysis import ir
from repro_torch.analysis.barrier import audit_tracing
from repro_torch.analysis.report import Finding

# the carried groups of a round's arguments and outputs
CARRIED = ("params", "opt_state", "sched_state")


def _sig(node):
    v = ir.val(node)
    return (tuple(v.shape), str(v.dtype), v.device.type)


def run_retrace(tr) -> list:
    """Every carried output of a traced round has its input's shape,
    dtype and device.  ``tr`` is an ``audit.TracedRound``."""
    findings = []
    tg = tr.graph
    outs = dict(zip(tg.out_labels, tg.out_items))
    for ph, label in zip(tg.placeholders, tg.in_labels):
        group = tr.group_of(label)
        if group not in CARRIED:
            continue
        out = outs.get(tr.out_label(label))
        if out is None:
            out = tg.carried.get(ph)
        if out is None:
            continue
        if _sig(ph) != _sig(out):
            findings.append(Finding(
                "retrace", "carry-aval-drift", tr.combo,
                f"{tr.pretty(label)}: round output {_sig(out)} differs from "
                f"its input {_sig(ph)}; every round would present a new "
                "signature", chain=(ir.node_line(out),)))
    return findings


# ---------------------------------------------------------------------------
# lane-structural equality (the sweep's one-round-body claim)
# ---------------------------------------------------------------------------
LANE_CASES = [
    ("client-count (sync)",
     dict(counts=(2,), schedules=("sync",), seeds=(0,)),
     dict(counts=(3,), schedules=("sync",), seeds=(0,))),
    ("seed (sync)",
     dict(counts=(2,), schedules=("sync",), seeds=(0,)),
     dict(counts=(2,), schedules=("sync",), seeds=(1,))),
    ("client-count (stale_k+partial lanes)",
     dict(counts=(2,), schedules=("stale_k:1", "partial:0.5"), seeds=(0,)),
     dict(counts=(3,), schedules=("stale_k:1", "partial:0.5"), seeds=(0,))),
    # fault plans are per-lane state, so batches differing only in rates,
    # durations, corruption kind (and client count) share the round body;
    # straggle presence must match (the ring depth is static)
    ("client-count (fault lanes)",
     dict(counts=(2,), schedules=("sync",), seeds=(0,),
          faults=("crash:0.2", "corrupt:0.1")),
     dict(counts=(3,), schedules=("sync",), seeds=(0,),
          faults=("crash:0.4", "crash:0.3+corrupt:0.5:scale"))),
    ("fault-rate (straggle ring + stale_k lanes)",
     dict(counts=(2,), schedules=("sync", "stale_k:2"), seeds=(0,),
          faults=("straggle:0.5:2", "straggle:0.2:1+corrupt:0.1")),
     dict(counts=(2,), schedules=("sync", "stale_k:2"), seeds=(1,),
          faults=("straggle:0.9:1", "straggle:0.4:2+corrupt:0.6"))),
]


def lane_graph(dataset, counts, schedules, seeds, max_clients, width,
               first_layer, device, faults=("none",), first_layer_fn=None):
    """Trace one round of a devertifl lane batch (under the audit, so
    the kernel lane's launch is one node) with the batch-wide padding
    and gather width pinned; returns the normalized graph text."""
    from repro_torch.core.sweep import (SweepConfig, build_lane_batch,
                                        make_lane_round_fn)
    scfg = SweepConfig(
        datasets=(dataset,), modes=("devertifl",), client_counts=counts,
        seeds=seeds, rounds=1, epochs=1, batch_size=16, n_samples=32,
        first_layer=first_layer, schedules=schedules, faults=faults)
    lb = build_lane_batch(dataset, "devertifl", scfg, device=device,
                          max_clients=max_clients, width=width)
    round_fn = lb.round_fn
    if first_layer_fn is not None:
        round_fn = make_lane_round_fn(lb.model, lb.opt, lb.pcfg, lb.device,
                                      first_layer_fn(lb), lb.impl)
    idx, draws = lb.round_indices(0), lb.round_draws(0)
    ytr, lay = lb.ytr, lb.lay

    def harness(params, opt_state, sched_state, xtr):
        if lb.impl is None:
            return round_fn(params, opt_state, 0, idx, xtr, ytr, lay)
        return round_fn(params, opt_state, 0, idx, xtr, ytr, lay,
                        sched_state, draws)

    with audit_tracing():
        tg = ir.trace_round(harness, (lb.params, lb.opt_state,
                                      lb.sched_state or {}, lb.xtr))
    return ir.normalized_code(tg.gm)


def lane_width(dataset, max_clients, counts=(2, 3), seeds=(0, 1)):
    """The gather width every compared batch pins: the widest live
    slice over the compared client counts and seeds."""
    from repro_torch.core import partition as PT
    from repro_torch.core.protocol import arch_for
    from repro_torch.configs import get_config
    n_feat = get_config(arch_for(dataset)).in_features
    return max(max(PT.make_layout(dataset, n_feat, nc, seed=s,
                                  max_clients=max_clients).sizes)
               for nc, s in itertools.product(counts, seeds))


def run_lane_check(dataset: str = "mnist", device="cpu", first_layer=None,
                   first_layer_fn=None, cases=None) -> list:
    """Lane batches differing only in client count / seed / schedule and
    fault values (same padded max, gather width and lane count) must
    trace to the same normalized graph.  ``first_layer`` defaults to
    ``kernel`` on CUDA and ``slice`` elsewhere; ``first_layer_fn(lb)``
    replaces the lane batch's first layer."""
    findings = []
    dev = torch.device(device)
    if first_layer is None:
        first_layer = "kernel" if dev.type == "cuda" else "slice"
    max_c = 3
    width = lane_width(dataset, max_c)
    for name, kw_a, kw_b in cases or LANE_CASES:
        ta = lane_graph(dataset, max_clients=max_c, width=width,
                        first_layer=first_layer, device=dev,
                        first_layer_fn=first_layer_fn, **kw_a)
        tb = lane_graph(dataset, max_clients=max_c, width=width,
                        first_layer=first_layer, device=dev,
                        first_layer_fn=first_layer_fn, **kw_b)
        if ta != tb:
            diff = list(itertools.islice(
                (ln for ln in difflib.unified_diff(
                    ta.splitlines(), tb.splitlines(), lineterm="")
                 if ln.startswith(("+", "-"))), 12))
            findings.append(Finding(
                "retrace", "lane-retrace-divergence",
                f"devertifl/sweep/{dataset}/{first_layer}",
                f"sweep lane batches differing only in {name} trace to "
                "different round bodies; one captured round could not "
                "serve every lane", chain=tuple(diff)))
    return findings
