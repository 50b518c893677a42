"""Seeds x client counts x schedules x fault plans x transforms x obs
levels as lanes of one batched round: the port of ``repro.core.sweep``.

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

Schedule, fault, transform and obs lanes
----------------------------------------
``SweepConfig.schedules``, ``faults``, ``transforms`` and ``obs`` are
lane axes too, as in the reference: every (obs, transform, fault,
schedule) value repeats the same (count, seed) base lanes -- same data,
layouts, inits and batch order -- obs-major, then transform-major,
fault-major and schedule-major.  ONE engine impl serves every lane (one
ring sized to the largest k, one straggler ring to the largest delay,
the taps at the highest obs level), and the lane batch's state holds
each lane's plan: per-client leaves on every slot ([L*max_c, ...] on
their client axis), per-lane plan scalars [L], broadcast to the lane's
slots (``repro_torch.schedule.engine``); the obs level gates and the
per-lane series are [L] and [L, R] (``repro_torch.obs.taps``).  Each
lane draws its coins and noise from its own seed and slot numbers
(``repro_torch.core.draws``), so a lane is bitwise its standalone
federation, its obs series included.  As in the reference,
``double_buffer`` cannot share an axis with other schedules and custom
plans are refused in lanes.

Devices: the port runs a lane batch on one device, so ``shard`` can only
be 1 there (``_lane_shards``).
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
from repro_torch.core.draws import CounterDraws
from repro_torch.core.exchange import fedavg
from repro_torch.core.partition import LayoutArrays
from repro_torch.core.protocol import (FIRST_LAYERS, ProtocolConfig,
                                       arch_for, exchange_width,
                                       make_perm_fn, make_predict_fn,
                                       make_sched_round_fn, make_step_fn,
                                       resolve_device, resolve_first_layer,
                                       round_generator, train_generators)
from repro_torch.data import registry as DR
from repro_torch.faults import get_fault_plan, make_fault_impl
from repro_torch.obs import get_obs_plan, make_obs_impl
from repro_torch.schedule import (get_schedule, make_sched_step_fn,
                                  make_schedule_impl, promote_sync,
                                  stack_lane_states)
from repro_torch.wire import get_wire_plan, make_wire_impl
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
    # the engine's lane axes (module doc): schedules (the sync / stale_k
    # / partial family shares an axis; double_buffer stands alone),
    # fault plans and transforms, devertifl only beyond their defaults
    schedules: Sequence[str] = ("sync",)
    faults: Sequence[str] = ("none",)
    transforms: Sequence[str] = ("none",)
    # the obs lane axis (repro_torch.obs levels; the gates are per-lane
    # state): observation-only, a non-none lane's trajectory is bitwise
    # its "none" twin's; custom obs impls cannot ride a lane axis
    obs: Sequence[str] = ("none",)


# ---------------------------------------------------------------------------
# the engine's lane axes
# ---------------------------------------------------------------------------
def _sweep_schedules(scfg, mode, model, n_clients, n_train, device):
    """Parse scfg.schedules into (scheds, impl, sync_only) for a lane
    batch of one (dataset, mode).  A sync-only axis gets impl=None (the
    sync round).  Mixed schedule lanes must all belong to the sync /
    stale_k / partial family: k and p ride the per-lane state, so ONE
    ring impl (sized to the largest k) serves every lane.  double_buffer
    carries a differently-shaped state and cannot share an axis; custom
    schedules may close over per-federation statics and are refused."""
    if not scfg.schedules:
        raise ValueError("schedules must name at least one schedule")
    scheds = tuple(get_schedule(s) for s in scfg.schedules)
    if len(scheds) == 1 and scheds[0].is_sync:
        return scheds, None, True
    if mode != "devertifl":
        raise ValueError(
            f"schedules beyond 'sync' require mode='devertifl' sweep "
            f"cells, got mode {mode!r}")
    if any(s.custom is not None for s in scheds):
        raise ValueError(
            "custom schedules are not supported in sweep lanes (their "
            "impls may close over per-federation statics the lane "
            "vmap cannot vary); run them as standalone sessions")
    if any(s.double_buffer for s in scheds) and len(scheds) > 1:
        raise ValueError(
            "double_buffer carries a differently-shaped schedule "
            "state and cannot share a lane axis with other schedules; "
            "sweep it as its own single-schedule batch")
    depths = {s.k for s in scheds}
    impl = make_schedule_impl(
        scheds[0], n_clients, min(scfg.batch_size, n_train),
        exchange_width(model, scfg.exchange_at), device,
        max_k=None if len(depths) == 1 else max(depths))
    return scheds, impl, False


def _stacked_sched_state(impl, scheds, n_base):
    """The lane batch's schedule state, schedule-major over a base of
    n_base (count x seed) lanes."""
    if impl is None:
        return {}
    return stack_lane_states(impl, [(impl.init_state(sc), n_base)
                                    for sc in scheds])


def _sweep_faults(scfg, mode, model, n_clients, n_train, impl, device):
    """Parse scfg.faults into (plans, impl, none_only).  A none-only
    axis hands the schedule impl back untouched.  Mixed fault lanes
    share ONE FaultImpl: rates, durations and corruption kind are
    per-lane state, the straggler ring is sized to the largest delay;
    custom plans are refused."""
    if not scfg.faults:
        raise ValueError("faults must name at least one fault plan")
    plans = tuple(get_fault_plan(f) for f in scfg.faults)
    if len(plans) == 1 and plans[0].is_none:
        return plans, impl, True
    if mode != "devertifl":
        raise ValueError(
            f"fault plans beyond 'none' require mode='devertifl' sweep "
            f"cells, got mode {mode!r}")
    if any(p.custom is not None for p in plans):
        raise ValueError(
            "custom fault plans are not supported in sweep lanes "
            "(their impls may close over per-federation statics the "
            "lane vmap cannot vary); run them as standalone sessions")
    bs = min(scfg.batch_size, n_train)
    width = exchange_width(model, scfg.exchange_at)
    impl = make_fault_impl(
        plans[0], promote_sync(impl, n_clients, bs, width, device), n_clients,
        bs, width, device, max_delay=max(p.max_delay for p in plans),
        corrupts=any(p.corrupt is not None for p in plans))
    return plans, impl, False


def _stacked_fault_state(impl, plans, scheds, n_base, none_only):
    """The lane batch's state, fault-major over the schedule-major base
    ((plan, sched) blocks of n_base lanes).  A none-only fault axis
    reduces to :func:`_stacked_sched_state`."""
    if none_only:
        return _stacked_sched_state(impl, scheds, n_base)
    return stack_lane_states(impl, [(impl.init_state(sc, plan=pl), n_base)
                                    for pl in plans for sc in scheds])


def _sweep_transforms(scfg, mode, model, n_clients, n_train, impl,
                      device):
    """Parse scfg.transforms into (wires, impl, none_only).  A
    none-only axis hands the schedule/fault impl back untouched.  Mixed
    transform lanes share ONE WireImpl: keep fraction, quantize flag
    and noise scale are per-lane state; custom transforms are
    refused."""
    if not scfg.transforms:
        raise ValueError("transforms must name at least one transform")
    wires = tuple(get_wire_plan(t) for t in scfg.transforms)
    if len(wires) == 1 and wires[0].is_none:
        return wires, impl, True
    if mode != "devertifl":
        raise ValueError(
            f"transforms beyond 'none' require mode='devertifl' sweep "
            f"cells, got mode {mode!r}")
    if any(w.custom is not None for w in wires):
        raise ValueError(
            "custom transforms are not supported in sweep lanes (their "
            "impls may close over per-federation statics the lane "
            "vmap cannot vary); run them as standalone sessions")
    bs = min(scfg.batch_size, n_train)
    width = exchange_width(model, scfg.exchange_at)
    impl = make_wire_impl(
        wires[0], promote_sync(impl, n_clients, bs, width, device), n_clients,
        bs, width, device, lanes=wires if len(wires) > 1 else None)
    return wires, impl, False


def _stacked_wire_state(impl, wires, plans, scheds, n_base,
                        fault_none_only, wire_none_only):
    """The lane batch's state, transform-major over the fault-major
    over schedule-major base ((wire, plan, sched) blocks of n_base
    lanes).  A none-only wire axis reduces to
    :func:`_stacked_fault_state`."""
    if wire_none_only:
        return _stacked_fault_state(impl, plans, scheds, n_base,
                                    fault_none_only)
    blocks = []
    for wp in wires:
        for pl in plans:
            kw = {"wire": wp} if fault_none_only else {"wire": wp,
                                                       "plan": pl}
            blocks += [(impl.init_state(sc, **kw), n_base) for sc in scheds]
    return stack_lane_states(impl, blocks)


def _sweep_obs(scfg, mode, model, n_clients, n_train, impl, device):
    """Parse scfg.obs into (obss, impl, none_only).  A none-only axis
    hands the schedule/fault/wire impl back untouched.  Mixed obs lanes
    share ONE ObsImpl built at the highest stacked level (tap work
    above an impl's level is not computed; lower lanes gate it off with
    zeros); custom obs impls are refused."""
    if not scfg.obs:
        raise ValueError("obs must name at least one obs level")
    obss = tuple(get_obs_plan(o) for o in scfg.obs)
    if len(obss) == 1 and obss[0].is_none:
        return obss, impl, True
    if mode != "devertifl":
        raise ValueError(
            f"obs levels beyond 'none' require mode='devertifl' sweep "
            f"cells, got mode {mode!r}")
    if any(o.custom is not None for o in obss):
        raise ValueError(
            "custom obs impls are not supported in sweep lanes (their "
            "impls may close over per-federation statics the lane "
            "vmap cannot vary); run them as standalone sessions")
    bs = min(scfg.batch_size, n_train)
    width = exchange_width(model, scfg.exchange_at)
    top = max(obss, key=lambda o: o.level)
    impl = make_obs_impl(top, promote_sync(impl, n_clients, bs, width,
                                           device),
                         n_clients, bs, width, scfg.rounds, device)
    return obss, impl, False


def _stacked_obs_state(impl, obss, wires, plans, scheds, n_base,
                       fault_none_only, wire_none_only, obs_none_only):
    """The lane batch's state, obs-major over the transform-major over
    fault-major over schedule-major base ((obs, wire, plan, sched)
    blocks of n_base lanes).  A none-only obs axis reduces to
    :func:`_stacked_wire_state`."""
    if obs_none_only:
        return _stacked_wire_state(impl, wires, plans, scheds, n_base,
                                   fault_none_only, wire_none_only)
    blocks = []
    for op in obss:
        for wp in wires:
            for pl in plans:
                kw = {"obs": op}
                if not wire_none_only:
                    kw["wire"] = wp
                if not fault_none_only:
                    kw["plan"] = pl
                blocks += [(impl.init_state(sc, **kw), n_base)
                           for sc in scheds]
    return stack_lane_states(impl, blocks)


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
def make_lane_round_fn(model, opt, pcfg, device, first_layer_fn,
                       impl=None):
    """One round of every lane: the step over each batch, then each
    lane's FedAvg.

    round_fn(params, opt_state, step_idx, idx, xtr, ytr, lay) ->
    (params, opt_state, step_idx, losses [L, S]): idx is [L, S, bs] on
    the device (lane l's batch-index matrix), xtr [L, n_train, F] in
    each lane's canonical order, ytr [L, n_train], lay the lanes-stacked
    LayoutArrays.  step_idx is shared: every lane takes the same steps.

    With an engine impl the round threads the lane batch's state:
    round_fn(..., lay, sched_state, draws) -> (params, opt_state,
    step_idx, sched_state, losses), as ``make_round_fn``'s.
    """
    do_fedavg = pcfg.fedavg and pcfg.mode != "non_federated"
    if impl is not None:
        sched_round = make_sched_round_fn(
            impl, make_sched_step_fn(model, opt, pcfg, impl, None, device,
                                     first_layer_fn=first_layer_fn),
            fedavg if do_fedavg else None)
    else:
        step = make_step_fn(model, opt, pcfg, None, device,
                            first_layer_fn=first_layer_fn)

    def round_fn(params, opt_state, step_idx, idx, xtr, ytr, lay,
                 sched_state=None, draws=None):
        flat = lane_arrays(lay)
        lanes = torch.arange(xtr.shape[0], device=xtr.device)[None, :]

        def batch_rows(x, y, rows):                        # rows [bs, L]
            return x[lanes, rows], y[lanes, rows].t()      # [bs, L, F]
        if impl is not None:
            return sched_round(params, opt_state, step_idx,
                               idx.permute(1, 2, 0), xtr, ytr, flat,
                               sched_state, draws, batch_rows=batch_rows)
        losses = []
        for rows in idx.permute(1, 2, 0):
            xb, yb = batch_rows(xtr, ytr, rows)
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
                   device, n_tile=1):
    """Every (n_clients, seed) pair stacked on one lane axis,
    count-major, padded to ``max_c`` slots, the whole base repeated
    ``n_tile`` times (one block a (transform, fault, schedule) value).
    Each seed's draw goes to the device once and each lane's column
    order is one ``index_select`` there.  Returns (xtr [L, n_train, F],
    ytr, xte, yte on the device, lanes-stacked LayoutArrays, lanes,
    width: the largest live slice)."""
    xtr, ytr, xte, yte = DR.make_dataset_stack(dataset, seeds, n=n_samples)
    n_features = xtr.shape[-1]
    lanes, layouts = [], []
    for nc in client_counts:
        for s in seeds:
            lanes.append((nc, s))
            layouts.append(PT.make_layout(dataset, n_features, nc, seed=s,
                                          max_clients=max_c))
    lanes, layouts = lanes * n_tile, layouts * n_tile
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
    lanes: tuple                # ((n_clients, seed), ...) module doc
    n_train: int
    n_batches: int
    batch_size: int
    width: int
    device: torch.device
    # the engine's lane axes: parsed values, the shared impl (None: the
    # sync round) and its initial state, lanes a (obs, wire, fault,
    # sched) block
    scheds: tuple = ()
    plans: tuple = ()
    wires: tuple = ()
    obss: tuple = ()
    impl: object = None
    sched_state: dict = None
    n_base: int = 0

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    @property
    def sync_only(self) -> bool:
        return self.impl is None

    @property
    def fault_none_only(self) -> bool:
        return len(self.plans) == 1 and self.plans[0].is_none

    @property
    def wire_none_only(self) -> bool:
        return len(self.wires) == 1 and self.wires[0].is_none

    @property
    def obs_none_only(self) -> bool:
        return len(self.obss) == 1 and self.obss[0].is_none

    def round_draws(self, r, attempt=0):
        """Round r's coins and noise: each lane's slots from its own
        seed (``repro_torch.core.draws``)."""
        return CounterDraws([s for _, s in self.lanes],
                            self.n_lanes * self.pcfg.padded_clients,
                            self.device, lanes=self.n_lanes).round(r, attempt)

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


def build_lane_batch(dataset, mode, scfg: SweepConfig, device=None,
                     max_clients=None, width=None) -> LaneBatch:
    """Assemble the obs x transforms x faults x schedules x
    client_counts x seeds lane batch of one (dataset, mode) pair on
    ``device`` (CUDA unless the caller names another): stacked data and
    layouts, per-lane inits, the engine's shared impl and per-lane
    state, the round.  ``max_clients`` (default: the largest count) and
    ``width`` (default: the widest live slice) pin the padded client
    axis and the slice lane's gather width, so batches of other counts
    can share one round body (``repro_torch.analysis.retrace``)."""
    device = resolve_device(device)
    counts, seeds = tuple(scfg.client_counts), tuple(scfg.seeds)
    max_c = max_clients or max(counts)
    pcfg = ProtocolConfig(
        dataset=dataset, n_clients=min(counts), max_clients=max_c,
        rounds=scfg.rounds, epochs=scfg.epochs,
        batch_size=scfg.batch_size, lr=scfg.lr,
        exchange_at=scfg.exchange_at, mode=mode, fedavg=scfg.fedavg,
        n_samples=scfg.n_samples, first_layer=scfg.first_layer)
    n_tile = max(1, len(scfg.obs) * len(scfg.transforms)
                 * len(scfg.faults) * len(scfg.schedules))
    xtr, ytr, xte, yte, lay, lanes, widest = _stacked_lanes(
        dataset, counts, seeds, scfg.n_samples, max_c, device,
        n_tile=n_tile)
    width = width or widest
    # one lane's model: its layers run every lane's stacked parameters
    model = PaperMLP(get_config(arch_for(dataset)), max_c)
    n_train = xtr.shape[1]
    scheds, impl, _ = _sweep_schedules(scfg, mode, model, max_c, n_train,
                                       device)
    plans, impl, fault_none = _sweep_faults(scfg, mode, model, max_c,
                                            n_train, impl, device)
    wires, impl, wire_none = _sweep_transforms(scfg, mode, model, max_c,
                                               n_train, impl, device)
    obss, impl, obs_none = _sweep_obs(scfg, mode, model, max_c, n_train,
                                      impl, device)
    n_base = len(counts) * len(seeds)
    fl, first = _sweep_first_layer(pcfg, device, width)
    opt = adam(pcfg.lr, max_grad_norm=None)
    params, opt_state = _init_lanes(model, opt, lanes, device)
    plan = make_perm_fn(pcfg, xtr.shape[1])
    return LaneBatch(
        pcfg=pcfg, model=model, opt=opt, first_layer=fl,
        round_fn=make_lane_round_fn(model, opt, pcfg, device, first, impl),
        predict_fn=make_lane_predict_fn(model, pcfg, device, first),
        params=params, opt_state=opt_state, xtr=xtr, ytr=ytr, xte=xte,
        yte=yte, lay=lay, lanes=lanes, n_train=xtr.shape[1],
        n_batches=plan.n_batches, batch_size=plan.batch_size,
        width=width, device=device, scheds=scheds, plans=plans,
        wires=wires, obss=obss, impl=impl,
        sched_state=_stacked_obs_state(impl, obss, wires, plans, scheds,
                                       n_base, fault_none, wire_none,
                                       obs_none),
        n_base=n_base)


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
    included.  Returns (params, opt_state, sched_state, losses [L, S] of
    the last round, wall, timed_rounds)."""
    params, opt_state, step_idx = lb.params, lb.opt_state, 0
    sched = lb.sched_state
    timed_rounds, losses = rounds, None
    _sync(lb.device)
    t0 = time.perf_counter()
    for r in range(rounds):
        if lb.impl is None:
            params, opt_state, step_idx, losses = lb.round_fn(
                params, opt_state, step_idx, lb.round_indices(r), lb.xtr,
                lb.ytr, lb.lay)
        else:
            params, opt_state, step_idx, sched, losses = lb.round_fn(
                params, opt_state, step_idx, lb.round_indices(r), lb.xtr,
                lb.ytr, lb.lay, sched, lb.round_draws(r))
        if r == 0 and rounds > 1:
            _sync(lb.device)
            t0 = time.perf_counter()
            timed_rounds = rounds - 1
    _sync(lb.device)
    return params, opt_state, sched, losses, time.perf_counter() - t0, \
        timed_rounds


def _trained(lb: LaneBatch):
    """Train ``lb`` and read back what the cells report: (f1s, accs,
    last losses [L, S] on the host, wall, lane-steps a lane timed, the
    final engine state)."""
    params, _, sched, losses, wall, timed_rounds = _train_rounds(
        lb, lb.pcfg.rounds)
    preds = lb.predict_fn(params, lb.xte, lb.lay).cpu().numpy()
    f1s, accs = _lane_metrics(preds, lb.yte.cpu().numpy(),
                              lb.ytr.cpu().numpy(), lb.lanes)
    steps = timed_rounds * lb.pcfg.epochs * lb.n_batches
    return f1s, accs, losses.cpu().numpy(), wall, steps, sched


def _cell_telemetry(lb: LaneBatch, sched, sl) -> dict:
    """A cell's fault and wire entries, summed over its lanes ``sl``,
    and its obs series with a leading lane (seed) axis: the reference's
    cell keys."""
    out = {}
    if not lb.fault_none_only:
        tel = lb.impl.telemetry(sched)
        out["fault_telemetry"] = {k: int(np.sum(v[sl]))
                                  for k, v in tel.items()}
    if not lb.wire_none_only:
        out["wire"] = {k: int(np.sum(v[sl])) for k, v in
                       lb.impl.wire_telemetry(sched).items()}
    if not lb.obs_none_only:
        out["obs_series"] = {k: v[sl] for k, v in
                             lb.impl.obs_series(sched).items()}
    return out


# ---------------------------------------------------------------------------
# single-cell (per-count) runner
# ---------------------------------------------------------------------------
def run_cell(dataset, mode, n_clients, scfg: SweepConfig, device=None):
    """Train len(scfg.seeds) federations of one (dataset, mode,
    n_clients) cell as unpadded lanes of one round; what a multi-seed
    Session runs."""
    for name, what, grid in (("schedules", "schedule", "schedule"),
                             ("faults", "fault plan", "fault"),
                             ("transforms", "transform", "wire"),
                             ("obs", "obs level", "obs")):
        if len(getattr(scfg, name)) != 1:
            raise ValueError(
                f"run_cell takes exactly one {what}; use "
                f"run_padded_cells({name}=...) for {grid} grids")
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
    f1s, accs, losses, wall, steps, sched = _trained(lb)
    cell = {
        "dataset": dataset, "mode": mode, "n_clients": n_clients,
        "seeds": list(scfg.seeds),
        "f1_per_seed": f1s, "acc_per_seed": accs,
        "f1_mean": float(np.mean(f1s)), "f1_std": float(np.std(f1s)),
        "acc_mean": float(np.mean(accs)),
        "final_loss_mean": float(losses[:, -1].mean()),
        "wall_s": wall,
        "steps_per_sec": steps * lb.n_lanes / max(wall, 1e-9),
    }
    if not lb.fault_none_only:
        cell["fault"] = lb.plans[0].spec
    if not lb.wire_none_only:
        cell["transform"] = lb.wires[0].spec
    if not lb.obs_none_only:
        cell["obs"] = lb.obss[0].spec
    cell.update(_cell_telemetry(lb, sched, slice(None)))
    return cell


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

    Returns {"cells": {key: cell}, "round_traces": int, "lanes": int,
    "devices": int, "wall_s": float, "schedules": [...],
    "cells_per_sec": float, "steps_per_sec": float}, the JAX package's
    schema: a sync-only fault-free transform-free obs-free batch keys
    its cells by n_clients; a non-default schedule axis by "sched/n", a
    fault axis by "fault/sched/n" (and adds "faults"), a transform axis
    by "transform/fault/sched/n" (and adds "transforms"), an obs axis by
    "obs/transform/fault/sched/n" (and adds "obs").  Each cell has
    run_cell's keys plus "schedule" (and "fault" with its
    "fault_telemetry", "transform" with its "wire" bytes, summed over
    its seeds, "obs" with its "obs_series", a leading seed axis);
    wall_s is the SHARED batch wall, each cell's
    steps_per_sec its lanes' lane-steps over it (the cells sum to the
    batch's steps_per_sec).
    ``round_traces`` has no compile behind it here: it is the number of
    round functions the batch built, 1.  shard: "auto" | False | int
    (``_lane_shards``)."""
    dataset, mode, scfg = _coerce_sweep_config(dataset, mode, scfg)
    counts, s = tuple(scfg.client_counts), len(scfg.seeds)
    lb = build_lane_batch(dataset, mode, scfg, device=device)
    n_dev = _lane_shards(lb.n_lanes, shard)
    f1s, accs, losses, wall, steps, sched = _trained(lb)
    cells = {}
    blocks = itertools.product(lb.obss, lb.wires, lb.plans, lb.scheds)
    for bi, (op, wp, pl, sc) in enumerate(blocks):
        for ci, nc in enumerate(counts):
            lo = bi * lb.n_base + ci * s
            sl = slice(lo, lo + s)
            if not lb.obs_none_only:
                ck = f"{op.spec}/{wp.spec}/{pl.spec}/{sc.spec}/{nc}"
            elif not lb.wire_none_only:
                ck = f"{wp.spec}/{pl.spec}/{sc.spec}/{nc}"
            elif not lb.fault_none_only:
                ck = f"{pl.spec}/{sc.spec}/{nc}"
            elif len(lb.scheds) > 1 or not sc.is_sync:
                ck = f"{sc.spec}/{nc}"
            else:
                ck = nc
            cell = {
                "dataset": dataset, "mode": mode, "n_clients": nc,
                "schedule": sc.spec, "seeds": list(scfg.seeds),
                "f1_per_seed": f1s[sl], "acc_per_seed": accs[sl],
                "f1_mean": float(np.mean(f1s[sl])),
                "f1_std": float(np.std(f1s[sl])),
                "acc_mean": float(np.mean(accs[sl])),
                "final_loss_mean": float(losses[sl, -1].mean()),
                "wall_s": wall,
                "steps_per_sec": steps * s / max(wall, 1e-9),
            }
            if not lb.fault_none_only:
                cell["fault"] = pl.spec
            if not lb.wire_none_only:
                cell["transform"] = wp.spec
            if not lb.obs_none_only:
                cell["obs"] = op.spec
            cell.update(_cell_telemetry(lb, sched, sl))
            cells[ck] = cell
    out = {"cells": cells, "round_traces": 1, "lanes": lb.n_lanes,
           "devices": n_dev, "wall_s": wall,
           "schedules": [sc.spec for sc in lb.scheds],
           "cells_per_sec": len(cells) / max(wall, 1e-9),
           "steps_per_sec": steps * lb.n_lanes / max(wall, 1e-9)}
    if not lb.fault_none_only:
        out["faults"] = [pl.spec for pl in lb.plans]
    if not lb.wire_none_only:
        out["transforms"] = [w.spec for w in lb.wires]
    if not lb.obs_none_only:
        out["obs"] = [o.spec for o in lb.obss]
    return out


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
