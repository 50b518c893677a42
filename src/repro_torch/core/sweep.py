"""Seeds x client counts as lanes of one batched round: the port of
``repro.core.sweep``, synchronous path.

Grid semantics
--------------
A sweep is the cartesian grid datasets x modes x client_counts x seeds.
Every (n_clients, seed) pair is a **lane**: an independent federation
with its own dataset draw, partition, init and batch order, each drawn
exactly as ``DeVertiFL(ProtocolConfig(n_clients=nc, seed=s))`` draws
them, padded to ``max(client_counts)`` slots with dead ones
(``Layout.pad``).  One round function trains every lane of a (dataset,
mode) group at once.

The JAX package ``vmap``s the lanes.  The port stacks them on the client
axis that every port module already carries: the parameters are the
model's own tree at ``n_clients = L * max_c`` (lane-major), so the
per-client layers, the cross-entropy and Adam run once for all lanes and
their launch count does not grow with L.  Only the exchange sum, FedAvg
and the masked loss means need to know where a lane ends: the lane
batch's ``client_mask`` is [L, max_c], and those reductions run within
each lane (``core.exchange``, ``core.protocol``).  Lanes share no
parameter, so one gradient of the sum of the lanes' losses gives every
lane its own.

First layer under lanes
-----------------------
A step's batch is [B, L, F]: lane l's rows in its own canonical column
order (each lane's column permutation is applied once, on the device).

  kernel  ONE ``vfl_matmul_clients`` launch for every lane: x is the
          batch viewed as [B, L*F], client (l, i) reads columns
          ``l*F + off[l, i]`` of it and rows ``off[l, i]`` of its W.
          The kernel takes its offsets at runtime, so the lanes' own
          layouts ride in tensors; each output is summed by one thread
          in ascending k, so a lane's slice of the stacked launch is a
          launch of that lane alone, bit for bit.
  slice   the port of ``make_uniform_first_layer_fn``: a gather-slice of
          static width max(F_i) with out-of-slice columns masked to
          exact zeros; held allclose to the per-federation slice lane,
          as in the reference, since its contraction is padded (the
          zero terms come last, and on the CPU they leave every bit)
  masked  the zero-padded [L*max_c, B, F] batch (a test oracle)

A dead slot gets relu(bias) in all three.  "auto" resolves as
``resolve_first_layer`` does: kernel on CUDA, slice on the CPU.  A
registered custom first layer is refused.  A masked lane reproduces the
standalone runs bit for bit on the CPU.

Devices: the port runs a lane batch on one device, so ``shard`` can only
be 1 there (``_lane_shards``).  Not ported yet: the schedule, fault,
transform and obs lane axes (ROADMAP.md, Queue 1 item 4); anything but
their defaults raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import partition as PT
from repro_torch.core.exchange import fedavg
from repro_torch.core.partition import LayoutArrays
from repro_torch.core.protocol import (FIRST_LAYERS, ProtocolConfig,
                                       arch_for, deferred, make_perm_fn,
                                       make_predict_fn, make_step_fn,
                                       resolve_device, resolve_first_layer,
                                       round_generator, train_generators)
from repro_torch.data import registry as DR
from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
from repro_torch.metrics import accuracy, f1_score
from repro_torch.models.mlp_model import PaperMLP
from repro_torch.optim import adam
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class SweepConfig:
    datasets: Sequence[str] = ("mnist", "fmnist", "titanic", "bank")
    modes: Sequence[str] = ("devertifl", "non_federated", "verticomb")
    client_counts: Sequence[int] = (2, 3, 5)
    seeds: Sequence[int] = (0, 1, 2)
    rounds: int = 5
    epochs: int = 5
    batch_size: int = 64
    lr: float = 1e-3
    exchange_at: int = -1
    fedavg: bool = True
    n_samples: Optional[int] = None     # dataset size override (speed)
    first_layer: str = "auto"           # auto | kernel | slice | masked
    # lane axes of the JAX package's sweep; only their defaults run here
    # (ROADMAP.md, Queue 1 item 4)
    schedules: Sequence[str] = ("sync",)
    faults: Sequence[str] = ("none",)
    transforms: Sequence[str] = ("none",)
    obs: Sequence[str] = ("none",)


_DEFAULT_AXES = (("schedules", ("sync",)), ("faults", ("none",)),
                 ("transforms", ("none",)), ("obs", ("none",)))


def _refuse_deferred_axes(scfg) -> None:
    for name, default in _DEFAULT_AXES:
        axis = tuple(getattr(scfg, name))
        if axis != default:
            raise deferred(f"a sweep's {name}={axis!r} axis", 4,
                           "schedule/faults/wire/obs")


# ---------------------------------------------------------------------------
# the lane batch's layout on the model's client axis
# ---------------------------------------------------------------------------
class LaneArrays(NamedTuple):
    """A lane batch's layout on the model's client axis of L*max_c
    slots (lane-major): masks [L*max_c, F], offsets and sizes
    [L*max_c] int32 (W rows and the slice in the lane's own columns),
    x_offsets [L*max_c] int32 (the slice's columns in the [B, L*F]
    lane-stacked batch: ``l*F + offsets``), client_mask [L, max_c]."""
    masks: torch.Tensor
    offsets: torch.Tensor
    sizes: torch.Tensor
    x_offsets: torch.Tensor
    client_mask: torch.Tensor


def lane_arrays(lay: LayoutArrays) -> LaneArrays:
    """Flatten lanes-stacked LayoutArrays ([L, max_c, ...]) onto the
    model's client axis."""
    n_lanes, n, n_features = lay.masks.shape
    base = torch.arange(n_lanes, dtype=torch.int32,
                        device=lay.offsets.device)[:, None] * n_features
    return LaneArrays(masks=lay.masks.reshape(n_lanes * n, n_features),
                      offsets=lay.offsets.reshape(-1),
                      sizes=lay.sizes.reshape(-1),
                      x_offsets=(base + lay.offsets).reshape(-1),
                      client_mask=lay.client_mask)


# ---------------------------------------------------------------------------
# first layers over the [B, L, F] lane-stacked batch
# ---------------------------------------------------------------------------
def kernel_first_layer(params, xb, lay: LaneArrays):
    """Every lane's first layer in one ``vfl_matmul_clients`` launch."""
    b, n_lanes, n_features = xb.shape
    w = params["layer_0"]["kernel"]     # [L*max_c, F, H]
    y = vfl_matmul_clients(xb.reshape(b, n_lanes * n_features), w,
                           lay.x_offsets, lay.offsets, lay.sizes)
    return torch.relu(y + params["layer_0"]["bias"].unsqueeze(1))


def make_uniform_first_layer_fn(width: int):
    """first(params, xb, lay) -> [L*max_c, B, H]: client i's slice
    gathered as the ``width`` columns from its offset, columns past its
    size masked to exact zeros before the matmul (+0.0 terms), so it is
    held allclose to the per-federation slice lane.  width is the
    largest live slice across lanes."""
    def first(params, xb, lay: LaneArrays):
        w = params["layer_0"]["kernel"]
        n_lanes, n = lay.client_mask.shape
        lane = torch.arange(n_lanes, device=xb.device).repeat_interleave(n)
        iota = torch.arange(width, device=xb.device)
        valid = iota < lay.sizes.long()[:, None]            # [C, width]
        cols = torch.where(valid, lay.offsets.long()[:, None] + iota, 0)
        x_c = xb[:, lane[:, None], cols].transpose(0, 1)
        x_c = x_c * valid[:, None, :].to(xb.dtype)          # [C, B, width]
        clients = torch.arange(w.shape[0], device=xb.device)[:, None]
        y = torch.bmm(x_c, w[clients, cols])                # [C, B, H]
        return torch.relu(y + params["layer_0"]["bias"].unsqueeze(1))
    return first


def _sweep_first_layer(pcfg, device, width):
    """(lane name, first_layer_fn) for a lane batch; custom registered
    lanes close over one federation's statics and are refused."""
    fl = resolve_first_layer(pcfg, device)
    if FIRST_LAYERS.get(fl) is not None:
        raise ValueError(
            f"custom first_layer {fl!r} is not supported in padded "
            "multi-count sweeps (its offsets/sizes cannot vary per "
            "lane); use 'masked', 'slice', 'kernel', or 'auto'")
    if fl == "kernel":
        return fl, kernel_first_layer
    if fl == "slice":
        return fl, make_uniform_first_layer_fn(width)
    return fl, None


# ---------------------------------------------------------------------------
# the lane round and predict
# ---------------------------------------------------------------------------
def make_lane_round_fn(model, opt, pcfg, device, first_layer_fn):
    """One round of every lane: the step over each batch, then each
    lane's FedAvg.

    round_fn(params, opt_state, step_idx, idx, xtr, ytr, lay) ->
    (params, opt_state, step_idx, losses [L, S]): idx is [L, S, bs] on
    the device (lane l's batch-index matrix), xtr [L, n_train, F] in
    each lane's canonical order, ytr [L, n_train], lay the lanes-stacked
    LayoutArrays.  step_idx is shared: every lane takes the same steps.
    """
    step = make_step_fn(model, opt, pcfg, None, device,
                        first_layer_fn=first_layer_fn)
    do_fedavg = pcfg.fedavg and pcfg.mode != "non_federated"

    def round_fn(params, opt_state, step_idx, idx, xtr, ytr, lay):
        flat = lane_arrays(lay)
        lanes = torch.arange(xtr.shape[0], device=xtr.device)[None, :]
        losses = []
        for rows in idx.permute(1, 2, 0):                  # [bs, L]
            xb = xtr[lanes, rows]                          # [bs, L, F]
            yb = ytr[lanes, rows].t()                      # [L, bs]
            params, opt_state, loss = step(params, opt_state, flat, xb,
                                           yb, step_idx)
            step_idx += 1
            losses.append(loss)
        if do_fedavg:
            with torch.no_grad():
                for p, v in zip(tree_leaves(params), tree_leaves(
                        fedavg(params, client_mask=flat.client_mask))):
                    p.copy_(v)
        return params, opt_state, step_idx, torch.stack(losses, dim=1)

    return round_fn


def make_lane_predict_fn(model, pcfg, device, first_layer_fn):
    """predict(params, x, lay) -> [L, max_c, B] class predictions from
    x [L, B, F] (each lane's rows in its canonical order)."""
    predict = make_predict_fn(model, pcfg, None, device,
                              first_layer_fn=first_layer_fn)

    def lane_predict(params, x, lay):
        flat = lane_arrays(lay)
        return predict(params, x.transpose(0, 1), flat).reshape(
            flat.client_mask.shape + (x.shape[1],))
    return lane_predict


# ---------------------------------------------------------------------------
# lane stacking
# ---------------------------------------------------------------------------
def _stack_layouts(layouts, device) -> LayoutArrays:
    return LayoutArrays(*(torch.stack(parts) for parts in
                          zip(*(lo.arrays(device) for lo in layouts))))


def _stacked_lanes(dataset, client_counts, seeds, n_samples, max_c,
                   device):
    """Every (n_clients, seed) pair stacked on one lane axis,
    count-major, padded to ``max_c`` slots.  Each seed's draw goes to
    the device once and each lane's column order is one
    ``index_select`` there.  Returns (xtr [L, n_train, F], ytr, xte,
    yte on the device, lanes-stacked LayoutArrays, lanes, width: the
    largest live slice)."""
    xtr, ytr, xte, yte = DR.make_dataset_stack(dataset, seeds, n=n_samples)
    n_features = xtr.shape[-1]
    lanes, layouts = [], []
    for nc in client_counts:
        for s in seeds:
            lanes.append((nc, s))
            layouts.append(PT.make_layout(dataset, n_features, nc, seed=s,
                                          max_clients=max_c))
    which = [seeds.index(s) for _, s in lanes]

    def per_lane(x, dtype, columns):
        src = torch.as_tensor(x, dtype=dtype, device=device)
        out = torch.empty((len(lanes),) + src.shape[1:], dtype=dtype,
                          device=device)
        for li, (si, lo) in enumerate(zip(which, layouts)):
            if columns:
                perm = torch.as_tensor(lo.perm, device=device)
                torch.index_select(src[si], 1, perm, out=out[li])
            else:
                out[li] = src[si]
        return out
    width = max(max(lo.sizes) for lo in layouts)
    return (per_lane(xtr, torch.float32, True),
            per_lane(ytr, torch.int64, False),
            per_lane(xte, torch.float32, True),
            per_lane(yte, torch.int64, False),
            _stack_layouts(layouts, device), tuple(lanes), max(width, 1))


class LaneBatch(NamedTuple):
    """One assembled lane batch of a (dataset, mode) pair: the round and
    predict functions and every per-lane tensor they take, on
    ``device``.  ``params`` is the model's tree at L*max_c clients
    (lane-major); ``round_indices(r)`` is round r's [L, S, bs] batch
    indices, lane (nc, s) drawing from ``round_generator(s, r)`` as
    ``DeVertiFL.train`` does, so a test can replay other draws into
    ``round_fn`` (``make_lane_round_fn``).  ``round_fn`` trains the
    parameters it is given in place; ``fresh_state()`` draws the
    initial ones anew."""
    pcfg: ProtocolConfig
    model: object
    opt: object
    first_layer: str            # the resolved lane: kernel | slice | masked
    round_fn: object
    predict_fn: object
    params: dict
    opt_state: dict
    xtr: torch.Tensor           # [L, n_train, F], canonical order a lane
    ytr: torch.Tensor           # [L, n_train]
    xte: torch.Tensor
    yte: torch.Tensor
    lay: LayoutArrays           # [L, max_c, ...]
    lanes: tuple                # ((n_clients, seed), ...) count-major
    n_train: int
    n_batches: int
    batch_size: int
    width: int
    device: torch.device

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    def round_indices(self, r) -> torch.Tensor:
        plan = make_perm_fn(self.pcfg, self.n_train)
        by_seed = {s: plan.perms(round_generator(s, r))
                   for s in dict.fromkeys(s for _, s in self.lanes)}
        return torch.stack([by_seed[s] for _, s in self.lanes]).to(
            self.device)

    def fresh_state(self):
        """A fresh (params, opt_state) from every lane's init draws."""
        return _init_lanes(self.model, self.opt, self.lanes, self.device)


def _init_lanes(model, opt, lanes, device):
    """Lane (nc, s) draws ``model``'s max_c slots from
    ``train_generators(s)``: its live prefix is the unpadded init."""
    per_lane = [model.init_params(train_generators(s)[0]) for _, s in lanes]
    params = tree_map(lambda *a: torch.cat(a).to(device), *per_lane)
    return params, opt.init(params)


def build_lane_batch(dataset, mode, scfg: SweepConfig,
                     device=None) -> LaneBatch:
    """Assemble the client_counts x seeds lane batch of one (dataset,
    mode) pair on ``device`` (CUDA unless the caller names another):
    stacked data and layouts, per-lane inits, the round."""
    _refuse_deferred_axes(scfg)
    device = resolve_device(device)
    counts, seeds = tuple(scfg.client_counts), tuple(scfg.seeds)
    max_c = max(counts)
    pcfg = ProtocolConfig(
        dataset=dataset, n_clients=min(counts), max_clients=max_c,
        rounds=scfg.rounds, epochs=scfg.epochs,
        batch_size=scfg.batch_size, lr=scfg.lr,
        exchange_at=scfg.exchange_at, mode=mode, fedavg=scfg.fedavg,
        n_samples=scfg.n_samples, first_layer=scfg.first_layer)
    xtr, ytr, xte, yte, lay, lanes, width = _stacked_lanes(
        dataset, counts, seeds, scfg.n_samples, max_c, device)
    fl, first = _sweep_first_layer(pcfg, device, width)
    # one lane's model: its layers run every lane's stacked parameters
    model = PaperMLP(get_config(arch_for(dataset)), max_c)
    opt = adam(pcfg.lr, max_grad_norm=None)
    params, opt_state = _init_lanes(model, opt, lanes, device)
    n_train = xtr.shape[1]
    plan = make_perm_fn(pcfg, n_train)
    return LaneBatch(
        pcfg=pcfg, model=model, opt=opt, first_layer=fl,
        round_fn=make_lane_round_fn(model, opt, pcfg, device, first),
        predict_fn=make_lane_predict_fn(model, pcfg, device, first),
        params=params, opt_state=opt_state, xtr=xtr, ytr=ytr, xte=xte,
        yte=yte, lay=lay, lanes=lanes, n_train=n_train,
        n_batches=plan.n_batches, batch_size=plan.batch_size,
        width=width, device=device)


def _lane_metrics(preds, yte, ytr, lanes):
    """Per-lane mean-over-live-clients F1/acc from padded predictions
    [L, max_clients, B_test]."""
    f1s, accs = [], []
    for li, (nc, _) in enumerate(lanes):
        avg = "macro" if len(np.unique(ytr[li])) > 2 else "binary"
        f1s.append(float(np.mean([f1_score(yte[li], preds[li, i],
                                           average=avg)
                                  for i in range(nc)])))
        accs.append(float(np.mean([accuracy(yte[li], preds[li, i])
                                   for i in range(nc)])))
    return f1s, accs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_rounds(lb: LaneBatch, rounds):
    """Drive ``rounds`` rounds of the lane batch from its initial state
    and time STEADY STATE only: with rounds > 1 the clock restarts
    after round 0 (the JAX package's compile round; here the first
    round's allocations and first kernel loads), with rounds == 1 it is
    included.  Returns (params, opt_state, losses [L, S] of the last
    round, wall, timed_rounds)."""
    params, opt_state, step_idx = lb.params, lb.opt_state, 0
    timed_rounds, losses = rounds, None
    _sync(lb.device)
    t0 = time.perf_counter()
    for r in range(rounds):
        params, opt_state, step_idx, losses = lb.round_fn(
            params, opt_state, step_idx, lb.round_indices(r), lb.xtr,
            lb.ytr, lb.lay)
        if r == 0 and rounds > 1:
            _sync(lb.device)
            t0 = time.perf_counter()
            timed_rounds = rounds - 1
    _sync(lb.device)
    return params, opt_state, losses, time.perf_counter() - t0, \
        timed_rounds


def _trained(lb: LaneBatch):
    """Train ``lb`` and read back what the cells report: (f1s, accs,
    last losses [L, S] on the host, wall, lane-steps a lane timed)."""
    params, _, losses, wall, timed_rounds = _train_rounds(lb,
                                                          lb.pcfg.rounds)
    preds = lb.predict_fn(params, lb.xte, lb.lay).cpu().numpy()
    f1s, accs = _lane_metrics(preds, lb.yte.cpu().numpy(),
                              lb.ytr.cpu().numpy(), lb.lanes)
    steps = timed_rounds * lb.pcfg.epochs * lb.n_batches
    return f1s, accs, losses.cpu().numpy(), wall, steps


# ---------------------------------------------------------------------------
# single-cell (per-count) runner
# ---------------------------------------------------------------------------
def run_cell(dataset, mode, n_clients, scfg: SweepConfig, device=None):
    """Train len(scfg.seeds) federations of one (dataset, mode,
    n_clients) cell as unpadded lanes of one round; what a multi-seed
    Session runs."""
    for name, what in (("schedules", "schedule"), ("faults", "fault plan"),
                       ("transforms", "transform"), ("obs", "obs level")):
        if len(getattr(scfg, name)) != 1:
            raise ValueError(
                f"run_cell takes exactly one {what}; use "
                f"run_padded_cells({name}=...) for {what} grids")
    _refuse_deferred_axes(scfg)
    n_features = get_config(arch_for(dataset)).in_features
    layouts = [PT.make_layout(dataset, n_features, n_clients, seed=s)
               for s in scfg.seeds]
    # canonical offsets/sizes are seed-independent (only the column
    # assignment varies), as the JAX package's cell requires
    if any(lo.offsets != layouts[0].offsets or lo.sizes != layouts[0].sizes
           for lo in layouts):
        raise ValueError("per-seed canonical layouts disagree on "
                         "offsets/sizes; the static-offset pallas path "
                         "cannot be vmapped over such lanes")
    lb = build_lane_batch(
        dataset, mode, dataclasses.replace(scfg, client_counts=(n_clients,)),
        device=device)
    f1s, accs, losses, wall, steps = _trained(lb)
    return {
        "dataset": dataset, "mode": mode, "n_clients": n_clients,
        "seeds": list(scfg.seeds),
        "f1_per_seed": f1s, "acc_per_seed": accs,
        "f1_mean": float(np.mean(f1s)), "f1_std": float(np.std(f1s)),
        "acc_mean": float(np.mean(accs)),
        "final_loss_mean": float(losses[:, -1].mean()),
        "wall_s": wall,
        "steps_per_sec": steps * lb.n_lanes / max(wall, 1e-9),
    }


# ---------------------------------------------------------------------------
# padded multi-count engine
# ---------------------------------------------------------------------------
def _lane_shards(n_lanes: int, shard) -> int:
    """How many devices to split the lane axis over: the largest
    available count dividing n_lanes.  The port runs a lane batch on
    one device, so that is 1; shard=False forces it, and an int asks
    for that many (refused above the one device)."""
    if shard is False:
        return 1
    avail = 1
    if isinstance(shard, int) and not isinstance(shard, bool):
        if n_lanes % shard or shard > avail:
            raise ValueError(f"cannot shard {n_lanes} lanes over "
                             f"{shard} of {avail} devices")
        return shard
    return max(d for d in range(1, avail + 1) if n_lanes % d == 0)


def _coerce_sweep_config(dataset, mode, scfg):
    """Let run_padded_cells take a spec grid in place of a SweepConfig:
    a sequence of ``repro_torch.api.ExperimentSpec`` (one per client
    count, same dataset/mode) is translated via the api layer.  Returns
    the (dataset, internal_mode, SweepConfig) triple."""
    if isinstance(scfg, SweepConfig):
        return dataset, mode, scfg
    from repro_torch.api.modes import get_mode     # lazy: api > core
    from repro_torch.api.session import sweep_config_for_specs
    ds, internal, cfg = sweep_config_for_specs(scfg)
    if dataset is not None and dataset != ds:
        raise ValueError(f"dataset argument {dataset!r} does not match "
                         f"the specs' dataset {ds!r}")
    # resolve the caller's mode through the registry so aliases
    # (backward_exchange == verticomb) compare equal
    if mode is not None and get_mode(mode).internal != internal:
        raise ValueError(f"mode argument {mode!r} does not match the "
                         f"specs' mode {internal!r}")
    return ds, internal, cfg


def run_padded_cells(dataset, mode, scfg, shard="auto", device=None):
    """Train the client_counts x seeds lane batch of one (dataset, mode)
    pair as one round function on ``device`` (CUDA unless the caller
    names another).  ``scfg`` is a SweepConfig, or a sequence of
    ``repro_torch.api.ExperimentSpec`` sharing one (dataset, mode)
    whose n_clients values form the count axis.

    Returns {"cells": {n_clients: cell}, "round_traces": int, "lanes":
    int, "devices": int, "wall_s": float, "schedules": ["sync"],
    "cells_per_sec": float, "steps_per_sec": float}, the JAX package's
    schema.  Each cell has run_cell's keys plus "schedule"; wall_s is
    the SHARED batch wall, each cell's steps_per_sec its lanes'
    lane-steps over it (the cells sum to the batch's steps_per_sec).
    ``round_traces`` has no compile behind it here: it is the number of
    round functions the batch built, 1.  shard: "auto" | False | int
    (``_lane_shards``)."""
    dataset, mode, scfg = _coerce_sweep_config(dataset, mode, scfg)
    counts, s = tuple(scfg.client_counts), len(scfg.seeds)
    n_dev = _lane_shards(len(counts) * s, shard)
    lb = build_lane_batch(dataset, mode, scfg, device=device)
    f1s, accs, losses, wall, steps = _trained(lb)
    cells = {}
    for ci, nc in enumerate(counts):
        sl = slice(ci * s, (ci + 1) * s)
        cells[nc] = {
            "dataset": dataset, "mode": mode, "n_clients": nc,
            "schedule": "sync", "seeds": list(scfg.seeds),
            "f1_per_seed": f1s[sl], "acc_per_seed": accs[sl],
            "f1_mean": float(np.mean(f1s[sl])),
            "f1_std": float(np.std(f1s[sl])),
            "acc_mean": float(np.mean(accs[sl])),
            "final_loss_mean": float(losses[sl, -1].mean()),
            "wall_s": wall,
            "steps_per_sec": steps * s / max(wall, 1e-9),
        }
    return {"cells": cells, "round_traces": 1, "lanes": lb.n_lanes,
            "devices": n_dev, "wall_s": wall, "schedules": ["sync"],
            "cells_per_sec": len(cells) / max(wall, 1e-9),
            "steps_per_sec": steps * lb.n_lanes / max(wall, 1e-9)}


def run_grid(scfg: SweepConfig = SweepConfig(), shard=None, device=None):
    """Walk the datasets x modes x client_counts grid, one lane batch a
    (dataset, mode).  Returns {"cells": {"ds/mode/n": cell}, "compare":
    {"ds/n": {mode: f1_mean}}}.

    ``scfg`` may also be a spec grid -- a sequence of
    ``repro_torch.api.ExperimentSpec`` (e.g. from ``spec_grid``) -- in
    which case the call goes through ``repro_torch.api.run_grid`` (same
    schema, plus a per-cell ``spec_hash``).  ``shard`` defaults to the
    specs' policy there and to "auto" here."""
    if not isinstance(scfg, SweepConfig):
        from repro_torch.api.session import run_grid as _api_run_grid
        return _api_run_grid(scfg, shard=shard, device=device)
    shard = "auto" if shard is None else shard
    cells, compare = {}, {}
    for ds, mode in itertools.product(scfg.datasets, scfg.modes):
        out = run_padded_cells(ds, mode, scfg, shard=shard, device=device)
        for nc, cell in out["cells"].items():
            cells[f"{ds}/{mode}/{nc}"] = cell
            compare.setdefault(f"{ds}/{nc}", {})[mode] = cell["f1_mean"]
    return {"cells": cells, "compare": compare}
