"""HiddenOutputExchange (Algorithm 2) and FedAvg (Algorithm 1 lines
16-19): the port of ``hidden_output_exchange`` and ``fedavg`` from
``repro.core.exchange``.

Beside them, the exchange helpers of the round engine's schedule,
fault and serving layers: ``scheduled_exchange`` (the exchange over a
schedule's reference stack), ``screen_exchange`` (the fault layer's
guard) and ``select_cached_exchange`` (the serving cache's splice).

The JAX package wraps the cross-client terms in
``repro.analysis.barrier.tag``, an identity outside its static audit.
The port has no ``tag`` until the auditor is ported (ROADMAP.md, Queue
1 item 7); a one-line comment marks each site where the reference
declassifies.

Lane batches: the JAX package runs a sweep's federations as lanes of a
``vmap``; the port stacks them on the client axis instead, lane-major
(``repro_torch.core.sweep``).  A ``client_mask`` of shape [L, n] says
so: the client axis holds L lanes of n slots, and every cross-client
reduction here runs within a lane.  A [n] mask is one federation.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def by_lane(t, client_mask):
    """``t``'s client axis ([L*n, ...] or [n, ...]) viewed in
    ``client_mask``'s shape ([L, n] or [n]): reduce over dim
    ``client_mask.dim() - 1`` to reduce within each lane."""
    return t.reshape(client_mask.shape + t.shape[1:])


def hidden_output_exchange(h_all, differentiable=False, client_mask=None):
    """h_all: [n_clients, B, H] per-client hidden outputs.

    Returns [n_clients, B, H]: for client i, h_i + sum of peers'
    hiddens.  With differentiable=False (De-VertiFL), peers' terms carry
    no gradient; with True, gradients flow to every contributor (the
    VertiComb-style backward exchange baseline).

    client_mask ([n_clients], 1.0 = live) excludes dead padding slots
    from the sum: a dead client adds an exact +0.0 term, so the live
    clients' sum keeps the unpadded bits.  Dead rows of the output are
    garbage; the protocol masks them out downstream.  A [L, n] mask
    sums within each of L lanes (module doc).
    """
    total, hm = _exchange_sum(h_all, client_mask)
    if differentiable:
        return total.expand_as(hm).reshape(h_all.shape)
    peers = (total - hm).detach()                         # data, no grad
    return h_all + peers.reshape(h_all.shape)


def _exchange_sum(h, client_mask):
    """(total, hm): the mask-weighted terms ``hm`` of a per-client
    stack (in ``client_mask``'s lane shape) and their sum over the
    clients of each lane, ``total`` [(L,) 1, B, H].  The one reduction
    both exchanges share, so equal inputs give equal bits."""
    if client_mask is None:
        hm, dim = h, 0
    else:
        # reference: tag(h * mask, "term", "exchange", client_axis=0)
        hm = by_lane(h, client_mask) * client_mask[..., None, None]
        dim = client_mask.dim() - 1
    # reference: tag(hm.sum(...), "declass", "exchange")
    return hm.sum(dim=dim, keepdim=True), hm


def scheduled_exchange(h_all, h_ref, eff_mask):
    """The exchange over a schedule's reference stack (the round
    engine's schedules, ``repro_torch.schedule``): client i consumes its
    OWN current ``h_all[i]`` plus the eff_mask-weighted sum of ``h_ref``
    excluding its own reference term.  ``h_ref`` is data (the detached
    current stack, a stale ring slot, a double-buffer front), so the
    gradient flows only through ``h_all``.

    ``eff_mask`` composes liveness with the round's participation: a
    dropped client's reference term is an exact +0.0 in the sum, while
    its own row still receives the participants' total.  With ``h_ref
    == h_all.detach()`` and ``eff_mask == client_mask`` this is
    ``hidden_output_exchange(h_all, False, client_mask)`` bit for bit
    (the same ``_exchange_sum``).  A [L, n] mask reduces within lanes.
    """
    total, hm = _exchange_sum(h_ref, eff_mask)
    return h_all + (total - hm).reshape(h_all.shape)


def screen_exchange(payload, last_good, max_abs):
    """The fault layer's guard over a per-client stack ``payload`` [n,
    B, H] about to enter the exchange sum: a client's slice is BAD when
    it holds a non-finite value or its largest magnitude exceeds
    ``max_abs`` (a NaN maximum compares False, so both tests catch it).
    Bad slices are replaced by that client's ``last_good`` slice, which
    keeps NaN and Inf out of the sum (masking after the sum would not:
    NaN * 0.0 is NaN).  Returns ``(screened, bad)``, ``bad`` an [n]
    bool mask; ``bad[i]`` depends on client i's slice alone."""
    flat = payload.flatten(1)
    bad = ~(torch.isfinite(flat).all(1) & (flat.abs().amax(1) <= max_abs))
    sel = bad.reshape((-1,) + (1,) * (payload.dim() - 1))
    return torch.where(sel, last_good, payload), bad


def select_cached_exchange(h_fresh, h_cached, use_cached):
    """The serving cache's splice: per slot, the cached exchange-point
    stack where ``use_cached`` [S] is nonzero, else the fresh one, both
    [n_clients, S, W].  An exact element select, so a slot's bits are
    untouched either way."""
    return torch.where(use_cached[None, :, None] != 0, h_cached, h_fresh)


def fedavg(stacked_params, client_mask=None):
    """P2P weight exchange + FedAvg: every client's slot of every leaf
    (leading client axis) is set to the mean over clients.  Returns a
    new tree.

    client_mask weights the average so dead padding slots contribute
    nothing; the live mean is broadcast to every slot.  The masked mean
    is ``sum * (1/n_live)``, a multiply, as the reference computes it.
    A [L, n] mask averages within each of L lanes (module doc).
    """
    if client_mask is None:
        def avg(leaf):
            # reference: tag(leaf.mean(...), "declass", "fedavg")
            return leaf.mean(dim=0, keepdim=True).expand_as(leaf)
    else:
        dim = client_mask.dim() - 1
        inv_live = 1.0 / client_mask.sum(dim=dim, keepdim=True)

        def avg(leaf):
            tail = (1,) * (leaf.dim() - 1)
            term = by_lane(leaf, client_mask) * \
                client_mask.reshape(client_mask.shape + tail)
            # reference: tag(term.sum(...) * inv_live, "declass", "fedavg")
            m = term.sum(dim=dim, keepdim=True) * \
                inv_live.reshape(inv_live.shape + tail)
            return m.expand_as(term).reshape(leaf.shape)
    return tree_map(avg, stacked_params)
