"""Plain PyTorch version of the MoE router: what the CUDA kernel
computes, written with ordinary tensor ops.  The CPU path of the wrapper
runs it, and ``chip_smoke.py`` holds the kernel against it on the card.

The port of ``repro.kernels.moe_router.ref.moe_router_ref``:

  p      = softmax(logits) over E, in float32
  idx    = the k largest p of each row, largest first; among equal
           values the lowest index first (``lax.top_k``'s order), so
           the k indices of a row are distinct
  w      = p[idx] / (p[idx_0] + ... + p[idx_{k-1}]), summed in pick order
  stats  = per tile of bt = min(bt, T) rows, sum over its rows of
           one_hot(idx) summed over the k picks + p  (routed count +
           probability mass); the last tile sums its real rows only

A stable descending sort gives the picks in that order (``torch.topk``
does not specify its order among equal values).

The Pallas kernel ``moe_router_p`` differs from this, and from its own
oracle, in two places that the port does not copy: it masks a pick by
multiplying by ``1 - onehot``, so once the rest of a row is exactly 0
(probabilities that underflow) it picks index 0 again; and it asserts
``T % bt == 0``.
"""
from __future__ import annotations

import torch


def moe_router_ref(logits, k, bt=128):
    """logits: [T, E] -> (weights [T, k] float32, indices [T, k] int32,
    stats [ceil(T / bt), E] float32; float64 for float64 logits, the
    CPU gradient checks)."""
    T, E = logits.shape
    p = torch.softmax(logits.to(torch.promote_types(logits.dtype,
                                                    torch.float32)), dim=-1)
    vals, order = torch.sort(p, dim=-1, descending=True, stable=True)
    top_w, top_i = vals[:, :k], order[:, :k]
    total = top_w[:, 0]
    for j in range(1, k):
        total = total + top_w[:, j]
    w = top_w / total[:, None]
    bt = min(bt, T)
    n_tiles = -(-T // bt)
    sel = torch.zeros_like(p).scatter_(1, top_i, 1.0)       # distinct picks
    rows = torch.zeros((n_tiles * bt, E), dtype=p.dtype, device=p.device)
    rows[:T] = sel + p
    stats = rows.view(n_tiles, bt, E).sum(1)
    return w, top_i.to(torch.int32), stats
