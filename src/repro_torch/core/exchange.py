"""HiddenOutputExchange (Algorithm 2) and FedAvg (Algorithm 1 lines
16-19): the port of ``hidden_output_exchange`` and ``fedavg`` from
``repro.core.exchange``.

The JAX package wraps their cross-client terms in
``repro.analysis.barrier.tag``, an identity outside its static audit;
the port drops it until the auditor is ported.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def hidden_output_exchange(h_all, differentiable=False, client_mask=None):
    """h_all: [n_clients, B, H] per-client hidden outputs.

    Returns [n_clients, B, H]: for client i, h_i + sum of peers'
    hiddens.  With differentiable=False (De-VertiFL), peers' terms carry
    no gradient; with True, gradients flow to every contributor (the
    VertiComb-style backward exchange baseline).

    client_mask ([n_clients], 1.0 = live) excludes dead padding slots
    from the sum: a dead client adds an exact +0.0 term, so the live
    clients' sum keeps the unpadded bits.  Dead rows of the output are
    garbage; the protocol masks them out downstream.
    """
    hm = h_all if client_mask is None else \
        h_all * client_mask[:, None, None]
    total = hm.sum(dim=0, keepdim=True)                  # [1, B, H]
    if differentiable:
        return total.expand_as(h_all)
    peers = (total - hm).detach()                         # data, no grad
    return h_all + peers


def fedavg(stacked_params, client_mask=None):
    """P2P weight exchange + FedAvg: every client's slot of every leaf
    (leading client axis) is set to the mean over clients.  Returns a
    new tree.

    client_mask weights the average so dead padding slots contribute
    nothing; the live mean is broadcast to every slot.  The masked mean
    is ``sum * (1/n_live)``, a multiply, as the reference computes it.
    """
    if client_mask is None:
        def avg(leaf):
            return leaf.mean(dim=0, keepdim=True).expand_as(leaf)
    else:
        inv_live = 1.0 / client_mask.sum()

        def avg(leaf):
            cm = client_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
            term = leaf * cm
            m = term.sum(dim=0, keepdim=True) * inv_live
            return m.expand_as(leaf)
    return tree_map(avg, stacked_params)
