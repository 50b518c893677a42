"""Plain PyTorch version of the RWKV6 WKV scan: what the CUDA kernel
computes, written with ordinary tensor ops.  The CPU path of the wrapper
runs it, and ``chip_smoke.py`` holds the kernel against it on the card.

The port of ``repro.kernels.rwkv6_scan.ref.rwkv6_scan_ref`` (a
``lax.scan`` over time from a zero state), with the state in and out:

  o_t = r_t (S + u * k_t^T v_t)
  S  <- diag(w_t) S + k_t^T v_t

per (b, h), S [hd, hd] in float32 starting from ``state`` (zeros when
None).  A Python loop over T, one step at a time, as the reference's
scan body.
"""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, w, u, state=None, *, state_out=None):
    """r, k, v, w: [B, T, H, hd]; u: [H, hd]; state: [B, H, hd, hd]
    float32 or None -> (o [B, T, H, hd] in r's dtype, final state
    [B, H, hd, hd] float32).  With ``state_out`` the final state is
    written there (it may be ``state``) and returned."""
    B, T, H, hd = r.shape
    S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    uf = u.float()[..., :, None]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # [B, H, hd, hd]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    o = torch.stack(outs, 1).to(r.dtype)
    if state_out is not None:
        state_out.copy_(S)
        S = state_out
    return o, S
