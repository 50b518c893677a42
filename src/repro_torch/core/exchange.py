"""HiddenOutputExchange (Algorithm 2) and FedAvg (Algorithm 1 lines
16-19): the port of ``hidden_output_exchange`` and ``fedavg`` from
``repro.core.exchange``.

The JAX package wraps their cross-client terms in
``repro.analysis.barrier.tag``, an identity outside its static audit;
the port drops it until the auditor is ported.

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
    if client_mask is None:
        hm, dim = h_all, 0
    else:
        hm = by_lane(h_all, client_mask) * client_mask[..., None, None]
        dim = client_mask.dim() - 1
    total = hm.sum(dim=dim, keepdim=True)               # [(L,) 1, B, H]
    if differentiable:
        return total.expand_as(hm).reshape(h_all.shape)
    peers = (total - hm).detach()                         # data, no grad
    return h_all + peers.reshape(h_all.shape)


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
            return leaf.mean(dim=0, keepdim=True).expand_as(leaf)
    else:
        dim = client_mask.dim() - 1
        inv_live = 1.0 / client_mask.sum(dim=dim, keepdim=True)

        def avg(leaf):
            tail = (1,) * (leaf.dim() - 1)
            term = by_lane(leaf, client_mask) * \
                client_mask.reshape(client_mask.shape + tail)
            m = term.sum(dim=dim, keepdim=True) * \
                inv_live.reshape(inv_live.shape + tail)
            return m.expand_as(term).reshape(leaf.shape)
    return tree_map(avg, stacked_params)
