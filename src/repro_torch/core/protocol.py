"""De-VertiFL training protocol (Algorithms 1 + 2), plus the
non-federated baseline and the VertiComb-style backward-exchange
baseline: the port of ``repro.core.protocol``.

All n clients are simulated in one process by stacking per-client
parameters on a leading axis (``PaperMLP`` holds them so); the exchange
and FedAvg are the only cross-client dataflows, and they are explicit.

Pieces, each named after its counterpart in the JAX package:

  make_first_layer_fn  the slice-aware first layer (lanes below)
  make_step_fn         one optimizer step for all clients (per mode)
  make_perm_fn         epoch shuffles drawn from a torch.Generator
  make_round_fn        a round: every batch of every epoch, then FedAvg
  resolve_engine       the schedule -> fault -> wire -> obs impl chain
  make_h_all_fn        per-client activations at the exchange point
  make_predict_fn      per-client inference with the evaluation exchange

Lane batches (``repro_torch.core.sweep``): the step, the activations
and the predictions also train and run many federations at once, as
lanes stacked on the client axis.  A [L, n] ``client_mask`` marks such
a batch: the exchange sum, FedAvg and the loss means reduce within
each lane (``core.exchange``), labels are [L, B], the masked lane's
input is the [B, L, F] lane-stacked batch, and the sweep passes its own
first layer (``first_layer_fn``).  Everything else is per client and
runs unchanged.

First-layer lanes (``ProtocolConfig.first_layer``):

  masked   the paper-literal reference: the [n, B, F] zero-padded batch
           through dense full-width matmuls
  slice    x[:, off:off+F_i] @ W[i, off:off+F_i] per client
  kernel   every client's slice in one launch of the hand-written
           Hopper kernel ``vfl_matmul_clients`` (the counterpart of the
           reference's ``pallas`` lane); its plain version on the CPU
  auto     kernel on a CUDA device, slice on the CPU

``register_first_layer(name, make)`` adds a lane: ``make(model, pcfg,
layout)`` returns ``first(params, xb, lay)``, the post-ReLU layer-0
activations [n_clients, B, H].

The lanes differ only in float summation order, so trajectories agree
to allclose, not bitwise.

Padded client axes: ``ProtocolConfig.max_clients`` pads the client axis
with dead slots; every cross-client reduction honours
``LayoutArrays.client_mask`` (exchange sum, FedAvg weights, loss means
by a reciprocal multiply), so the live clients' trajectories are
bit-for-bit the unpadded run's.

Engines: the reference runs a round as one ``lax.scan`` ("scan") or as
a host loop over the jitted step ("python").  Both names are accepted
here and run the same Python loop over the round's batch-index matrix;
capturing the step in a CUDA graph is later work.

Randomness: ``train_generators(seed)`` gives the init generator, and
round r draws its batches from ``round_generator(seed, r)`` alone (the
reference's ``fold_in(loop_key, r)``), so a run resumed at round r
replays rounds r.. without replaying the rounds before.

The round engine's schedule, fault, wire and obs layers
(``repro_torch.schedule``, ``.faults``, ``.wire``, ``.obs``): a
non-sync ``schedule`` or a non-none ``fault``, ``transform`` or ``obs``
(all devertifl only) wraps the round in an impl chain, schedule ->
fault -> wire -> obs (``resolve_engine``), whose state the round
threads through: ``round_start`` with the round's draws
(``repro_torch.core.draws``), ``select`` and the obs taps every step,
``fedavg_mask`` and ``round_end``.  Literal "sync" with every plan at
"none" keeps the sync path untouched, bit for bit.
"""
from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import partition as PT
from repro_torch.core.draws import CounterDraws
from repro_torch.core.exchange import (by_lane, fedavg,
                                       hidden_output_exchange)
from repro_torch.data import registry as DR
from repro_torch.faults import RESEED_TAG, get_fault_plan, make_fault_impl
from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
from repro_torch.metrics import accuracy, f1_score
from repro_torch.models.mlp_model import PaperMLP
from repro_torch.obs.registry import get_obs_plan
from repro_torch.obs.taps import make_obs_impl
from repro_torch.optim import adam
from repro_torch.registry import Registry
from repro_torch.schedule import (get_schedule, make_sched_step_fn,
                                  make_schedule_impl, promote_sync)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.wire import get_wire_plan, make_wire_impl


@dataclass
class ProtocolConfig:
    dataset: str = "mnist"              # mnist | fmnist | titanic | bank
    n_clients: int = 3
    rounds: int = 5
    epochs: int = 5
    batch_size: int = 64
    lr: float = 1e-3
    # Where HiddenOutputExchange happens: -1 exchanges the logits
    # (Algorithm 1), k>=1 the output of hidden layer k, 0 the raw
    # zero-padded input (masked lane only).
    exchange_at: int = -1
    mode: str = "devertifl"             # devertifl | non_federated | verticomb
    fedavg: bool = True
    seed: int = 0
    n_samples: Optional[int] = None     # dataset size override (speed)
    engine: str = "scan"                # scan | python: the same loop here
    first_layer: str = "auto"           # auto | kernel | slice | masked
    # The round engine's layers (devertifl only): an exchange schedule
    # ("sync", "stale_k:2", "partial:0.5[:det]", "double_buffer",
    # "stale_k:4+partial:0.5"), a fault plan ("none", "crash:0.2[:dur]",
    # "straggle:0.5:2", "corrupt:0.05[:scale]", '+'-joined) and a wire
    # transform ("none", "topk:0.5", "int8", "dp:0.1", '+'-joined) and
    # an obs level ("none", "basic", "full").
    schedule: str = "sync"
    fault: str = "none"
    transform: str = "none"
    obs: str = "none"
    # Pad the client axis to this length with dead (masked) slots.
    max_clients: Optional[int] = None
    # Explicit unequal per-client feature counts (sum to the feature
    # count); None keeps the registry partition strategy.
    partition_sizes: Optional[Tuple[int, ...]] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def padded_clients(self) -> int:
        """Static client-axis length (max_clients or n_clients)."""
        return self.max_clients or self.n_clients


# the round-engine axes' defaults: a spec at these runs the sync path
AXIS_DEFAULTS = {"schedule": "sync", "fault": "none",
                 "transform": "none", "obs": "none"}
ENGINES = ("scan", "python")
MODES = ("devertifl", "non_federated", "verticomb")


def check_config(pcfg) -> None:
    """Refuse an unknown engine or mode."""
    if pcfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {pcfg.engine!r}; engines: "
                         f"{ENGINES}")
    if pcfg.mode not in MODES:
        raise ValueError(f"unknown mode {pcfg.mode!r}; modes: {MODES}")


def resolve_device(device=None) -> torch.device:
    """The federation's device: CUDA unless the caller names another.
    Raises when CUDA is asked for and absent; there is no fallback.
    On CUDA, TF32 is switched off for matmuls and cuDNN: the reference
    is float32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU "
                "unless the caller passes device='cpu'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def arch_for(dataset: str) -> str:
    """Model-config name for a dataset, via the dataset registry."""
    return DR.get_dataset(dataset).arch


# First-layer lane registry: the built-in lanes and "auto" hold None
# (they are implemented inline below); a registered lane holds a factory
# ``make(model, pcfg, layout) -> first(params, xb, lay)``.
FIRST_LAYERS = Registry("first_layer")
for _name in ("auto", "kernel", "masked", "slice"):
    FIRST_LAYERS.register(_name, None)


def register_first_layer(name, make):
    """Register a first-layer lane for ProtocolConfig / ExperimentSpec
    ``first_layer=name``: ``make(model, pcfg, layout)`` returns
    ``first(params, xb, lay)``, the post-ReLU layer-0 activations."""
    return FIRST_LAYERS.register(name, make)


def auto_first_layer(device=None) -> str:
    """What first_layer="auto" means on ``device`` (on this machine when
    None: kernel where CUDA is available).  ExperimentSpec resolves
    "auto" through it at construction."""
    if device is None:
        return "kernel" if torch.cuda.is_available() else "slice"
    return "kernel" if torch.device(device).type == "cuda" else "slice"


def resolve_first_layer(pcfg, device) -> str:
    """Map the first_layer knob to a concrete lane for ``device``."""
    fl = pcfg.first_layer
    maker = FIRST_LAYERS.get(fl)    # unknown names raise with options
    if fl == "auto":
        fl = auto_first_layer(device)
    if pcfg.exchange_at == 0 and fl != "masked":
        # exchanging the raw zero-padded input predates layer 0; only
        # the masked formulation expresses it
        if maker is not None:
            raise ValueError(
                f"first_layer {fl!r} cannot express exchange_at=0 "
                "(the exchange predates layer 0); use "
                "first_layer='masked'")
        fl = "masked"
    return fl


def exchange_width(model, exchange_at) -> int:
    """Trailing width of the exchanged tensor -- what a schedule buffer
    holds per client per batch row: logits (exchange_at == -1), the raw
    input (0), or the hidden width (after layer k)."""
    if exchange_at == -1:
        return model.n_classes
    if exchange_at == 0:
        return model.in_features
    return model.hidden


def resolve_schedule(pcfg, model, n_train, device):
    """pcfg.schedule -> (Schedule, impl).  ``impl`` is None for the
    literal "sync" spec: the sync path runs untouched.  Non-sync
    schedules (the degenerate stale_k:0 / partial:1.0 included, which
    run the schedule engine and reduce to sync bitwise) are devertifl
    only: the forward exchange is what is being scheduled."""
    sched = get_schedule(pcfg.schedule)
    if sched.is_sync:
        return sched, None
    if pcfg.mode != "devertifl":
        raise ValueError(
            f"schedule {sched.spec!r} requires mode='devertifl'; mode "
            f"{pcfg.mode!r} supports schedule='sync' only")
    impl = make_schedule_impl(
        sched, pcfg.padded_clients, min(pcfg.batch_size, n_train),
        exchange_width(model, pcfg.exchange_at), device)
    return sched, impl


def resolve_engine(pcfg, model, n_train, device):
    """pcfg.schedule + pcfg.fault + pcfg.transform + pcfg.obs ->
    (Schedule, impl).  With ``fault``, ``transform`` and ``obs`` at
    "none" this IS :func:`resolve_schedule`, so literal sync keeps its
    path.  A non-none plan (devertifl only) wraps the schedule impl in
    the fault layer, then the wire layer, then the metric taps
    (schedule -> fault -> wire -> obs: wire outermost of the machinery,
    so it transforms what the inner layers buffer and screen; obs
    outermost of all, so it observes exactly what is released); literal
    sync is first promoted to a depth-0 ring impl (``stale_k:0``,
    bitwise sync) so the wrappers have hooks to ride."""
    sched, impl = resolve_schedule(pcfg, model, n_train, device)
    n, bs = pcfg.padded_clients, min(pcfg.batch_size, n_train)
    width = exchange_width(model, pcfg.exchange_at)

    def promoted(impl):
        return promote_sync(impl, n, bs, width, device)

    plan = get_fault_plan(pcfg.fault)
    if not plan.is_none:
        if pcfg.mode != "devertifl":
            raise ValueError(
                f"fault plan {plan.spec!r} requires mode='devertifl'; "
                f"mode {pcfg.mode!r} supports fault='none' only")
        impl = make_fault_impl(plan, promoted(impl), n, bs, width, device)
    wire = get_wire_plan(pcfg.transform)
    if not wire.is_none:
        if pcfg.mode != "devertifl":
            raise ValueError(
                f"transform {wire.spec!r} requires mode='devertifl'; "
                f"mode {pcfg.mode!r} supports transform='none' only")
        impl = make_wire_impl(wire, promoted(impl), n, bs, width, device)
    op = get_obs_plan(pcfg.obs)
    if not op.is_none:
        if pcfg.mode != "devertifl":
            raise ValueError(
                f"obs level {op.spec!r} requires mode='devertifl'; "
                f"mode {pcfg.mode!r} supports obs='none' only")
        impl = make_obs_impl(op, promoted(impl), n, bs, width,
                             pcfg.rounds, device)
    return sched, impl


# ---------------------------------------------------------------------------
# pure protocol pieces; activations are [n_clients, B, .] stacks
# ---------------------------------------------------------------------------
def client_hidden(model, exchange_at, p, xm):
    """Forward up to the exchange point (hidden layer k, or logits)."""
    if exchange_at == -1:
        return model.head(model.forward_hidden(xm, params=p), params=p)
    return model.forward_hidden(xm, upto=exchange_at, params=p)


def client_hidden_from(model, exchange_at, p, h1):
    """client_hidden, starting from the post-ReLU layer-0 output."""
    if exchange_at == -1:
        return model.head(model.forward_from(h1, start=1, params=p),
                          params=p)
    return model.forward_from(h1, start=1, upto=exchange_at, params=p)


def rest(model, exchange_at, p, h):
    """Forward from the exchange point to logits."""
    if exchange_at == -1:
        return h
    for i in range(exchange_at, model.n_hidden):
        h = torch.relu(torch.matmul(h, p[f"layer_{i}"]["kernel"])
                       + p[f"layer_{i}"]["bias"].unsqueeze(-2))
    return model.head(h, params=p)


def _ce(logits, labels):
    """[n, B, C] logits, [B] labels -> [n] per-client mean CE.  A lane
    batch's labels are [L, B], each lane's for its n / L clients."""
    if labels.dim() == 2:
        labels = labels.repeat_interleave(
            logits.shape[0] // labels.shape[0], dim=0)
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.expand(logits.shape[0], -1).unsqueeze(-1)
    return -logp.gather(-1, idx).squeeze(-1).mean(dim=-1)


def _masked_mean(values, client_mask):
    """Mean over live clients: sum(v * mask) * (1/n_live); [L] for a
    lane batch's [L, n] mask, 0-d for one federation."""
    return (by_lane(values, client_mask) * client_mask).sum(-1) * \
        (1.0 / client_mask.sum(-1))


def _masked_hidden_sum(h_all, client_mask):
    """[n, B, H] -> [B, H] exchange sum excluding dead clients ([L, B,
    H], a sum a lane, for a lane batch)."""
    return (by_lane(h_all, client_mask) * client_mask[..., None, None]
            ).sum(dim=client_mask.dim() - 1)


def _to_clients(t, client_mask):
    """A lane sum ([L, B, H]) on every client of its lane ([L*n, B, H]);
    one federation's [B, H] broadcasts as it is."""
    if client_mask.dim() == 1:
        return t
    n_lanes, n = client_mask.shape
    return t.unsqueeze(1).expand(n_lanes, n, *t.shape[1:]).reshape(
        n_lanes * n, *t.shape[1:])


def make_first_layer_fn(model, pcfg, layout, device):
    """first(params, xb, lay) -> [n_clients, B, H] post-ReLU layer-0
    activations from the canonical-order [B, F] batch.  ``slice`` reads
    the layout's static offsets; ``kernel`` passes lay's offset and
    size tensors to the kernel, so it never reads them on the host.
    A dead (size-0) client gets relu(bias) in both."""
    fl = resolve_first_layer(pcfg, device)
    assert fl != "masked", fl
    maker = FIRST_LAYERS.get(fl)
    if maker is not None:           # a registered lane
        return maker(model, pcfg, layout)
    offsets, sizes = layout.offsets, layout.sizes

    if fl == "slice":
        def first_slice(params, xb, lay):
            w = params["layer_0"]["kernel"]     # [n, F, H]
            b = params["layer_0"]["bias"]       # [n, H]
            outs = []
            for i, (off, f_i) in enumerate(zip(offsets, sizes)):
                if f_i == 0:
                    outs.append(torch.relu(
                        b[i].expand(xb.shape[0], w.shape[-1])))
                    continue
                x_i = xb[:, off:off + f_i]
                outs.append(torch.relu(x_i @ w[i, off:off + f_i] + b[i]))
            return torch.stack(outs)
        return first_slice

    def first_kernel(params, xb, lay):
        w = params["layer_0"]["kernel"]
        b = params["layer_0"]["bias"]
        y = vfl_matmul_clients(xb, w, lay.offsets, lay.offsets, lay.sizes)
        return torch.relu(y + b.unsqueeze(1))
    return first_kernel


def _leaf_copies(params):
    """Fresh autograd leaves sharing the parameters' storage, so a step
    can differentiate any tree (module parameters or plain tensors) and
    then update the originals in place."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def _grads(total, ps):
    """Gradients of ``total``, or of the sum of a lane batch's [L]
    losses: lanes share no parameter, so each lane gets its own."""
    return tree_unflatten(ps, torch.autograd.grad(total.sum(),
                                                  tree_leaves(ps)))


def _masked_input(xb, lay):
    """The masked lane's [n, B, F] zero-padded batch; for a lane batch
    ([L, max_c] client_mask) from the [B, L, F] lane-stacked batch, each
    lane's rows repeated on its max_c slots: [L*max_c, B, F]."""
    if lay.client_mask.dim() == 1:
        return xb[None] * lay.masks[:, None, :]
    n = lay.client_mask.shape[1]
    return xb.transpose(0, 1).repeat_interleave(n, dim=0) * \
        lay.masks[:, None, :]


def make_step_fn(model, opt, pcfg, layout, device, first_layer_fn=None):
    """One all-clients optimizer step for pcfg.mode.

    step(params, opt_state, lay, xb, yb, step_idx) -> (params,
    opt_state, mean_loss): params are updated in place (and returned),
    step_idx is a python int, xb is in canonical column order and
    mean_loss is the live clients' mean, a 0-d tensor on the device
    ([L] for a lane batch).  ``first_layer_fn(params, xb, lay)``
    replaces the first layer (a lane batch passes it; ``layout`` is then
    unused).
    """
    fl = resolve_first_layer(pcfg, device)
    k = pcfg.exchange_at

    if fl == "masked":
        # the paper-literal reference: whole forward from the [n, B, F]
        # zero-padded batch; every client's loss depends on its own
        # parameters alone, so grad(sum of losses) is the per-client
        # gradient stack (dead clients' included, as in the reference)
        def devertifl_loss(ps, lay, xm, yb):
            h_all = client_hidden(model, k, ps, xm)
            h_sum = _to_clients(_masked_hidden_sum(h_all.detach(),
                                                   lay.client_mask),
                                lay.client_mask)
            # value == full exchanged sum; grad flows only through h_i
            h = h_all + h_sum - h_all.detach()
            losses = _ce(rest(model, k, ps, h), yb)
            return losses.sum(), losses

        def nonfed_loss(ps, lay, xm, yb):
            losses = _ce(rest(model, k, ps, client_hidden(model, k, ps,
                                                          xm)), yb)
            return losses.sum(), losses

        def verticomb_loss(ps, lay, xm, yb):
            h_all = client_hidden(model, k, ps, xm)
            h_sum = _to_clients(_masked_hidden_sum(h_all, lay.client_mask),
                                lay.client_mask)
            logits = rest(model, k, ps, h_sum.expand_as(h_all))
            loss = _masked_mean(_ce(logits, yb), lay.client_mask)
            return loss, None

        loss_fn = {"devertifl": devertifl_loss, "non_federated": nonfed_loss,
                   "verticomb": verticomb_loss}[pcfg.mode]
        def step(params, opt_state, lay, xb, yb, step_idx):
            xm = _masked_input(xb, lay)
            ps = _leaf_copies(params)
            total, losses = loss_fn(ps, lay, xm, yb)
            params, opt_state, _ = opt.update(_grads(total, ps), opt_state,
                                              params, step_idx)
            loss = total if losses is None else \
                _masked_mean(losses.detach(), lay.client_mask)
            return params, opt_state, loss.detach()
        return step

    # slice/kernel: grads of the masked sum of per-client losses (peer
    # terms are detached, so loss_i depends on params[i] alone, and the
    # mask drops dead clients' grads)
    first = first_layer_fn or make_first_layer_fn(model, pcfg, layout,
                                                  device)

    def losses_fn(ps, lay, xb, yb, differentiable=None):
        h_all = client_hidden_from(model, k, ps, first(ps, xb, lay))
        if differentiable is not None:
            h_all = hidden_output_exchange(
                h_all, differentiable=differentiable,
                client_mask=lay.client_mask)
        return _ce(rest(model, k, ps, h_all), yb)          # [n]

    def step(params, opt_state, lay, xb, yb, step_idx):
        ps = _leaf_copies(params)
        if pcfg.mode == "verticomb":
            loss = _masked_mean(losses_fn(ps, lay, xb, yb, True),
                                lay.client_mask)
            grads = _grads(loss, ps)
        else:
            exchange = False if pcfg.mode == "devertifl" else None
            losses = losses_fn(ps, lay, xb, yb, exchange)
            grads = _grads(by_lane(losses, lay.client_mask)
                           * lay.client_mask, ps)
            loss = _masked_mean(losses, lay.client_mask)
        params, opt_state, _ = opt.update(grads, opt_state, params,
                                          step_idx)
        return params, opt_state, loss.detach()
    return step


class PermPlan(NamedTuple):
    """Epoch-shuffle plan from make_perm_fn.  Each epoch uses
    n_batches * batch_size samples, so the trailing
    ``n_train % batch_size`` samples of every epoch's permutation are
    dropped (n_dropped); a fresh permutation each epoch drops a
    different subset."""
    perms: object          # perms(generator) -> [epochs*n_batches, bs]
    n_batches: int
    batch_size: int
    n_dropped: int


def make_perm_fn(pcfg, n_train) -> PermPlan:
    """perms(generator) -> [epochs * n_batches, batch_size] int64 batch
    indices (a CPU tensor), one independent permutation per epoch, with
    the tail drop of ``PermPlan``."""
    bs = min(pcfg.batch_size, n_train)
    n_batches = n_train // bs

    def perms(generator):
        order = torch.stack([torch.randperm(n_train, generator=generator)
                             for _ in range(pcfg.epochs)])
        return order[:, :n_batches * bs].reshape(
            pcfg.epochs * n_batches, bs)

    return PermPlan(perms, n_batches, bs, n_train - n_batches * bs)


def accepts_client_mask(fn) -> bool:
    """Whether an aggregation fn's signature takes client_mask=."""
    try:
        return "client_mask" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def call_fedavg(fedavg_fn, params, client_mask):
    """Invoke an aggregation fn, passing client_mask only if its
    signature accepts it."""
    if accepts_client_mask(fedavg_fn):
        return fedavg_fn(params, client_mask=client_mask)
    return fedavg_fn(params)


@torch.no_grad()
def _assign(params, new):
    for p, v in zip(tree_leaves(params), tree_leaves(new)):
        p.copy_(v)


def make_round_fn(model, opt, pcfg, n_train, layout, device,
                  fedavg_fn=None, impl=None):
    """One De-VertiFL round: the step over every row of the round's
    batch-index matrix, then the P2P FedAvg (Algorithm 1 lines 16-19)
    written into the parameters in place.

    round_fn(params, opt_state, step_idx, idx, xtr, ytr, lay) ->
    (params, opt_state, step_idx, losses[epochs*n_batches]); idx is the
    [epochs*n_batches, bs] matrix on the device, xtr in canonical
    column order.  Losses stay on the device.

    With an engine impl (``resolve_engine``) the round threads its
    state: round_fn(..., lay, sched_state, draws) -> (params,
    opt_state, step_idx, sched_state, losses), ``draws`` the round's
    ``RoundDraws``: round_start, the scheduled step over every batch,
    FedAvg weighted by the round's mask (less the fault layer's
    quarantine), round_end.
    """
    do_fedavg = pcfg.fedavg and pcfg.mode != "non_federated"
    fedavg_fn = fedavg_fn or fedavg
    padded = layout.n_real < layout.n_clients
    if do_fedavg and padded and not accepts_client_mask(fedavg_fn):
        raise ValueError(
            "custom fedavg_fn must accept a client_mask= keyword when "
            "the client axis is padded (max_clients > n_clients): a "
            "mask-blind aggregator would average dead slots' params "
            "into every live client")
    if impl is not None:
        return make_sched_round_fn(
            impl, make_sched_step_fn(model, opt, pcfg, impl, layout, device),
            fedavg_fn if do_fedavg else None)
    step = make_step_fn(model, opt, pcfg, layout, device)

    def round_fn(params, opt_state, step_idx, idx, xtr, ytr, lay):
        losses = []
        for batch_idx in idx:
            xb, yb = _batch_rows(xtr, ytr, batch_idx)
            params, opt_state, loss = step(params, opt_state, lay, xb, yb,
                                           step_idx)
            step_idx += 1
            losses.append(loss)
        if do_fedavg:
            with torch.no_grad():
                _assign(params, call_fedavg(fedavg_fn, params,
                                            lay.client_mask))
        return params, opt_state, step_idx, torch.stack(losses)

    return round_fn


def _batch_rows(xtr, ytr, batch_idx):
    return xtr.index_select(0, batch_idx), ytr.index_select(0, batch_idx)


def make_sched_round_fn(impl, step, fedavg_fn):
    """The round under an engine impl (``make_round_fn``): ``step`` is
    ``make_sched_step_fn``'s, ``fedavg_fn`` None when the round does not
    average.  The round's ``batch_rows(xtr, ytr, batch_idx) -> (xb,
    yb)`` gathers a step's batch (a lane batch gathers every lane's);
    its index is ``step_idx // len(idx)``."""
    if fedavg_fn is not None and not accepts_client_mask(fedavg_fn):
        raise ValueError(
            "custom fedavg_fn must accept a client_mask= keyword "
            "under a non-sync exchange schedule: the per-round "
            "participation mask weights the aggregation")
    fedavg_mask = getattr(impl, "fedavg_mask", None)

    def round_fn(params, opt_state, step_idx, idx, xtr, ytr, lay,
                 sched_state, draws, batch_rows=None):
        batch_rows = batch_rows or _batch_rows
        sched_state, eff = impl.round_start(sched_state, lay, draws,
                                            step_idx // len(idx))
        losses = []
        for batch_idx in idx:
            xb, yb = batch_rows(xtr, ytr, batch_idx)
            params, opt_state, sched_state, loss = step(
                params, opt_state, lay, eff, sched_state, xb, yb, step_idx)
            step_idx += 1
            losses.append(loss)
        if fedavg_fn is not None:
            mask = eff if fedavg_mask is None else fedavg_mask(sched_state,
                                                               eff)
            with torch.no_grad():
                _assign(params, fedavg_fn(params, client_mask=mask))
        sched_state = impl.round_end(sched_state)
        return (params, opt_state, step_idx, sched_state,
                torch.stack(losses, dim=-1))

    return round_fn


def make_h_all_fn(model, pcfg, layout, device, first_layer_fn=None):
    """h_all(params, x, lay) -> [n_clients, B, W] per-client activations
    at the exchange point from a canonical-order [B, F] batch.  Every
    output row depends only on its own input row.  ``first_layer_fn``
    is make_step_fn's."""
    fl = resolve_first_layer(pcfg, device)
    k = pcfg.exchange_at
    if fl == "masked":
        def h_all_fn(params, x, lay):
            return client_hidden(model, k, params, _masked_input(x, lay))
        return h_all_fn
    first = first_layer_fn or make_first_layer_fn(model, pcfg, layout,
                                                  device)

    def h_all_fn(params, x, lay):
        return client_hidden_from(model, k, params, first(params, x, lay))
    return h_all_fn


def make_predict_fn(model, pcfg, layout, device, first_layer_fn=None):
    """predict(params, x, lay) -> [n_clients, B] class predictions from
    canonical-order x.  Dead padded clients' rows are garbage.
    ``first_layer_fn`` is make_step_fn's."""
    h_all_fn = make_h_all_fn(model, pcfg, layout, device, first_layer_fn)

    @torch.no_grad()
    def predict(params, x, lay):
        h_all = h_all_fn(params, x, lay)
        if pcfg.mode in ("devertifl", "verticomb"):
            h_all = hidden_output_exchange(h_all, differentiable=False,
                                           client_mask=lay.client_mask)
        logits = rest(model, pcfg.exchange_at, params, h_all)
        return torch.argmax(logits, dim=-1)

    return predict


def _generator(ss) -> torch.Generator:
    return torch.Generator().manual_seed(
        int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def train_generators(seed: int):
    """(init generator, loop generator) for a federation seed: two
    independent CPU streams, so the initial weights and the epoch
    permutations do not depend on each other (nor on the device).
    Training draws round r's batches from ``round_generator(seed, r)``,
    a stream of its own beneath the loop stream."""
    return tuple(_generator(ss)
                 for ss in np.random.SeedSequence(seed).spawn(2))


def round_generator(seed: int, r: int, attempt: int = 0) -> torch.Generator:
    """Round r's batch-order generator: the counterpart of the
    reference's ``fold_in(loop_key, r)``.  Its state depends only on
    (seed, r) -- the loop stream's SeedSequence with r appended to its
    spawn key -- so a resumed run draws round r's batches without
    replaying rounds 0..r-1.  A retried round (``attempt > 0``, the
    watchdog's reseed) appends ``(RESEED_TAG, attempt)`` as well."""
    loop_ss = np.random.SeedSequence(seed).spawn(2)[1]
    key = loop_ss.spawn_key + (int(r),)
    if attempt > 0:
        key += (RESEED_TAG, int(attempt))
    return _generator(np.random.SeedSequence(loop_ss.entropy,
                                             spawn_key=key))


# ---------------------------------------------------------------------------
class DeVertiFL:
    """One federation: model, partition, per-client parameters.

    Data is held on ``device`` in the canonical column order of
    ``self.layout``; ``predict`` takes raw (original-column-order)
    inputs.  ``device`` defaults to CUDA; pass ``device="cpu"`` to run
    on the CPU (the kernel lane then runs the kernel's plain version).
    """

    def __init__(self, pcfg: ProtocolConfig, fedavg_fn=None, device=None):
        check_config(pcfg)
        self.pcfg = pcfg
        self.device = resolve_device(device)
        self._fedavg_fn = fedavg_fn
        self.mcfg = get_config(arch_for(pcfg.dataset))
        self.model = PaperMLP(self.mcfg, pcfg.padded_clients, self.device)
        xtr, ytr, xte, yte = DR.make_dataset(pcfg.dataset, pcfg.n_samples,
                                             seed=pcfg.seed)
        self.xtr, self.ytr, self.xte, self.yte = xtr, ytr, xte, yte
        self.n_features = self.model.in_features
        self.layout = PT.make_layout(pcfg.dataset, self.n_features,
                                     pcfg.n_clients, seed=pcfg.seed,
                                     max_clients=pcfg.max_clients,
                                     sizes=pcfg.partition_sizes)
        self.partition = self.layout.partition[:pcfg.n_clients]
        self.first_layer = resolve_first_layer(pcfg, self.device)
        self._lay = self.layout.arrays(self.device)

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)
        # public masks stay in RAW column order, like the reference's
        self.masks = dev(PT.masks_for(self.partition, self.n_features),
                         torch.float32)
        self._xtr = dev(self.layout.apply(xtr), torch.float32)
        self._xte = dev(self.layout.apply(xte), torch.float32)
        self._ytr = dev(ytr, torch.int64)
        self.opt = adam(pcfg.lr, max_grad_norm=None)
        self._build_steps()

    def _build_steps(self):
        pcfg, n_train = self.pcfg, len(self.xtr)
        plan = make_perm_fn(pcfg, n_train)
        self.perms = plan.perms
        self.n_batches, self.bs = plan.n_batches, plan.batch_size
        self._schedule, self._impl = resolve_engine(pcfg, self.model,
                                                    n_train, self.device)
        self._round = make_round_fn(self.model, self.opt, pcfg, n_train,
                                    self.layout, self.device,
                                    fedavg_fn=self._fedavg_fn,
                                    impl=self._impl)
        self._predict = make_predict_fn(self.model, pcfg, self.layout,
                                        self.device)

    def set_fedavg(self, fedavg_fn):
        """Swap the aggregation function (e.g. weighted FedAvg) and
        rebuild the round."""
        self._fedavg_fn = fedavg_fn
        self._build_steps()

    # the engine impl's state: what run_round threads and the Session
    # checkpoints, as the reference's does
    def init_sched_state(self) -> dict:
        """The engine state a round carries: ``{}`` on the sync path."""
        return {} if self._impl is None else \
            self._impl.init_state(self._schedule)

    def fault_telemetry(self, sched_state):
        """Cumulative fault-event counters of the carried state, or None
        when no fault plan runs."""
        tel = getattr(self._impl, "telemetry", None)
        return None if tel is None else tel(sched_state)

    def wire_telemetry(self, sched_state):
        """Cumulative bytes-on-wire counters of the carried state, or
        None when no transform runs."""
        tel = getattr(self._impl, "wire_telemetry", None)
        return None if tel is None else tel(sched_state)

    def obs_series(self, sched_state):
        """The per-round metric series the obs taps recorded in the
        carried state (``repro_torch.obs``), as numpy arrays, or None
        when obs="none"."""
        ser = getattr(self._impl, "obs_series", None)
        return None if ser is None else ser(sched_state)

    def draws(self, seed=None) -> CounterDraws:
        """The coin and noise source of this federation's slots at
        ``seed`` (default ``pcfg.seed``): ``.round(r, attempt)`` is what
        ``run_round`` takes as ``draws``."""
        return CounterDraws(self.pcfg.seed if seed is None else seed,
                            self.pcfg.padded_clients, self.device)

    # ------------------------------------------------------------------
    def init_params(self, generator) -> dict:
        """A fresh stacked parameter tree on the device, drawn from
        ``generator`` (live clients first, then dead padding slots)."""
        return tree_map(lambda t: t.to(self.device),
                        self.model.init_params(generator))

    def start(self, params, opt_state=None):
        """Copy ``params`` into the model and return (the model's live
        parameter tree, ``opt_state`` or a fresh optimizer state):
        training updates the module's own parameters in place."""
        self.model.load_params(params)
        params = self.model.params()
        return params, (self.opt.init(params) if opt_state is None
                        else opt_state)

    def run_round(self, params, opt_state, step_idx, idx,
                  sched_state=None, draws=None):
        """One round over the [epochs*n_batches, bs] index matrix
        ``idx`` (e.g. ``self.perms(generator)``), training ``params``
        in place.  Returns (params, opt_state, step_idx, losses).

        Given ``sched_state`` (``init_sched_state()`` or a later round's)
        it returns (params, opt_state, step_idx, sched_state, losses),
        the engine's state threaded through the round; a federation with
        a schedule, fault plan or transform needs it.  ``draws`` is the
        round's coin and noise source (default:
        ``self.draws().round(step_idx // steps a round)``)."""
        if sched_state is None and self._impl is not None:
            raise ValueError(
                "this federation carries engine state (schedule "
                f"{self.pcfg.schedule!r}, fault {self.pcfg.fault!r}, "
                f"transform {self.pcfg.transform!r}, obs "
                f"{self.pcfg.obs!r}): pass "
                "sched_state= (init_sched_state() to start)")
        if not isinstance(idx, torch.Tensor):
            idx = torch.tensor(np.asarray(idx), dtype=torch.int64)
        idx = idx.to(self.device, torch.int64)
        if tuple(idx.shape) != (self.pcfg.epochs * self.n_batches,
                                self.bs):
            raise ValueError(f"index matrix {tuple(idx.shape)}; this "
                             "round takes "
                             f"{(self.pcfg.epochs * self.n_batches, self.bs)}")
        if self._impl is None:
            out = self._round(params, opt_state, step_idx, idx, self._xtr,
                              self._ytr, self._lay)
            return out if sched_state is None else \
                out[:3] + (sched_state,) + out[3:]
        if draws is None:
            draws = self.draws().round(step_idx // idx.shape[0])
        return self._round(params, opt_state, step_idx, idx, self._xtr,
                           self._ytr, self._lay, sched_state, draws)

    def predict(self, params, x):
        xc = torch.as_tensor(
            np.ascontiguousarray(self.layout.apply(np.asarray(x))),
            dtype=torch.float32, device=self.device)
        return self._predict(params, xc, self._lay)

    def evaluate(self, params):
        preds = self._predict(params, self._xte, self._lay).cpu().numpy()
        avg = "macro" if len(np.unique(self.ytr)) > 2 else "binary"
        f1s = [f1_score(self.yte, preds[i], average=avg)
               for i in range(self.pcfg.n_clients)]
        accs = [accuracy(self.yte, preds[i])
                for i in range(self.pcfg.n_clients)]
        return {"f1": float(np.mean(f1s)), "acc": float(np.mean(accs)),
                "f1_per_client": f1s}

    # ------------------------------------------------------------------
    def train(self, seed=None, eval_every_round=True, engine=None):
        """Train ``pcfg.rounds`` rounds from weights drawn from
        ``train_generators(seed)`` and round r's permutations from
        ``round_generator(seed, r)`` (default ``pcfg.seed``) into the
        model's parameters.  Returns {"history", "final",
        "params", "sched_state"}, params a detached copy of the final
        tree and sched_state the engine's final state (``{}`` on the
        sync path; ``fault_telemetry``/``wire_telemetry`` read it)."""
        pcfg = self.pcfg
        engine = engine or pcfg.engine
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        seed = pcfg.seed if seed is None else seed
        init_gen, _ = train_generators(seed)
        params, opt_state = self.start(self.init_params(init_gen))
        step_idx, history = 0, []
        sched_state, draws = self.init_sched_state(), self.draws(seed)
        for r in range(pcfg.rounds):
            params, opt_state, step_idx, sched_state, losses = \
                self.run_round(params, opt_state, step_idx,
                               self.perms(round_generator(seed, r)),
                               sched_state, draws.round(r))
            if eval_every_round:
                ev = self.evaluate(params)
                ev["round"] = r
                ev["round_losses"] = losses.cpu().numpy()
                ev["loss"] = float(ev["round_losses"][-1])
                history.append(ev)
        final = self.evaluate(params)
        return {"history": history, "final": final,
                "params": tree_map(lambda p: p.detach().clone(), params),
                "sched_state": sched_state}


def train_federation(device=None, **kw):
    """DEPRECATED legacy front door, kept as a shim over
    ``repro_torch.api``: ProtocolConfig-style kwargs (``seed=`` becomes
    the spec's ``seeds=(seed,)``) run through ``build(spec,
    device).run()``, returning the historical {"history", "final",
    "params"} dict.  New code builds the spec itself::

        from repro_torch.api import ExperimentSpec, build
        result = build(ExperimentSpec(dataset="mnist", n_clients=5)).run()
    """
    import warnings
    warnings.warn(
        "train_federation(**kw) is deprecated; build a "
        "repro_torch.api.ExperimentSpec and run it via "
        "repro_torch.api.build(spec).run() instead", DeprecationWarning,
        stacklevel=2)
    from repro_torch.api import ExperimentSpec, build   # api sits above core
    if "seed" in kw:
        kw["seeds"] = (kw.pop("seed"),)
    rr = build(ExperimentSpec(**kw), device=device).run()
    return {"history": rr.history, "final": rr.metrics,
            "params": rr.params}
