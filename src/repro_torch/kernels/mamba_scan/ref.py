"""Plain PyTorch version of the Mamba selective scan: what the CUDA
kernel computes, written with ordinary tensor ops.  The CPU path of the
wrapper runs it, and ``chip_smoke.py`` holds the kernel against it on
the card.

The port of ``repro.kernels.mamba_scan.ref.mamba_scan_ref`` (a
``lax.scan`` over time from a zero state), with the state in and out:

  h_t = a_t * h_{t-1} + bx_t        (elementwise over [D, N])
  y_t = h_t . c_t                   (contracting N)

h [B, D, N] in float32 starting from ``h0`` (zeros when None).  A
Python loop over T, one step at a time, as the reference's scan body.
"""
from __future__ import annotations

import torch


def mamba_scan_ref(a, bx, c, h0=None, *, h_out=None):
    """a, bx: [B, T, D, N]; c: [B, T, N]; h0: [B, D, N] float32 or None
    -> (y [B, T, D] in a's dtype, final h [B, D, N] float32).  With
    ``h_out`` the final h is written there (it may be ``h0``) and
    returned."""
    B, T, D, N = a.shape
    h = torch.zeros((B, D, N), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    af, bxf, cf = a.float(), bx.float(), c.float()
    ys = []
    for t in range(T):
        h = af[:, t] * h + bxf[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, 1).to(a.dtype)
    if h_out is not None:
        h_out.copy_(h)
        h = h_out
    return y, h
