"""Plain PyTorch versions of the Mamba selective scan: what the CUDA
kernels compute, written with ordinary tensor ops.  The CPU path of the
wrapper runs it, and ``chip_smoke.py`` holds the kernel against it on
the card.

The port of ``repro.kernels.mamba_scan.ref.mamba_scan_ref`` (a
``lax.scan`` over time from a zero state), with the state in and out:

  h_t = a_t * h_{t-1} + bx_t        (elementwise over [D, N])
  y_t = h_t . c_t                   (contracting N)

h [B, D, N] in float32 starting from ``h0`` (zeros when None).  A
Python loop over T, one step at a time, as the reference's scan body.

``mamba_scan_fused_ref`` is the fused kernel's function: the Mamba
mixer's discretisation (``repro.models.ssm.mamba_apply``, the lines
that form ``a`` and ``bx``), then ``mamba_scan_ref``.
"""
from __future__ import annotations

import torch


def mamba_scan_ref(a, bx, c, h0=None, *, h_out=None):
    """a, bx: [B, T, D, N]; c: [B, T, N]; h0: [B, D, N] float32 or None
    -> (y [B, T, D] in a's dtype, final h [B, D, N] float32).  With
    ``h_out`` the final h is written there (it may be ``h0``) and
    returned.  Float64 inputs compute in float64 (the CPU gradient
    checks)."""
    B, T, D, N = a.shape
    acc = torch.promote_types(a.dtype, torch.float32)
    h = torch.zeros((B, D, N), dtype=acc, device=a.device) \
        if h0 is None else h0.to(acc)
    af, bxf, cf = a.to(acc), bx.to(acc), c.to(acc)
    ys = []
    for t in range(T):
        h = af[:, t] * h + bxf[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, 1).to(a.dtype)
    if h_out is not None:
        h_out.copy_(h)
        h = h_out
    return y, h


def mamba_scan_fused_ref(dt, x, Bm, Cm, A, h0=None, *, h_out=None):
    """dt [B, T, D] float32, x [B, T, D] and Bm, Cm [B, T, N] in the
    model's dtype, A [D, N] float32, h0 [B, D, N] float32 or None ->
    (y [B, T, D] float32, final h [B, D, N] float32): the reference's

      a  = exp(dt A)        (dt A rounded to float32 first)
      bx = (dt x) B         (x and B promoted to dt's float32)

    over [B, T, D, N], then the scan of a, bx and C.  With ``h_out`` the
    final h is written there (it may be ``h0``)."""
    a = torch.exp(dt[..., None] * A)
    bx = (dt * x)[..., None] * Bm[..., None, :].to(dt.dtype)
    acc = torch.promote_types(dt.dtype, torch.float32)
    return mamba_scan_ref(a.to(acc), bx.to(acc), Cm.to(acc), h0,
                          h_out=h_out)
