"""Plain PyTorch versions of the RWKV6 WKV scan: what the CUDA kernels
compute, written with ordinary tensor ops.  The CPU path of the wrapper
runs ``rwkv6_scan_ref``, and ``chip_smoke.py`` holds both of the
kernel's routes against it on the card.

The port of ``repro.kernels.rwkv6_scan.ref.rwkv6_scan_ref`` (a
``lax.scan`` over time from a zero state), with the state in and out:

  o_t = r_t (S + u * k_t^T v_t)
  S  <- diag(w_t) S + k_t^T v_t

per (b, h), S [hd, hd] in float32 starting from ``state`` (zeros when
None).  A Python loop over T, one step at a time, as the reference's
scan body.

``rwkv6_scan_chunked_ref`` is the chunked route's algorithm in the same
plain form (the CPU tests hold it to ``rwkv6_scan_ref`` and to the
Pallas kernel): the T steps cut into chunks of ``chunk`` (the last one
padded with w = 1, k = v = r = 0, which leaves the state exactly as it
was), then

  A. per chunk, the suffix products P_s = prod_{s < tau < L} w_tau (a
     backward running product), the chunk's decay D = prod_tau w_tau
     and its summary dS = (k * P)^T v;
  B. over the chunks in order, S_{c+1} = D_c * S_c + dS_c from
     ``state``: every chunk's start state;
  C. per chunk, the recurrence above replayed over its steps from its
     start state.

Only products of w in [0, 1] enter, never log w or a quotient of
products, so nothing overflows or cancels and w = 0 is exact.  Each
chunk is computed on tensors of one shape, so a run split at a multiple
of ``chunk`` gives bitwise what one run gives.
"""
from __future__ import annotations

import torch


def _step(S, r, k, v, w, uf):
    """One step of the recurrence: (o_t [B, H, hd], the next S)."""
    kv = k[..., :, None] * v[..., None, :]                 # [B, H, hd, hd]
    o = torch.einsum("bhk,bhkv->bhv", r, S + uf * kv)
    return o, w[..., :, None] * S + kv


def rwkv6_scan_ref(r, k, v, w, u, state=None, *, state_out=None):
    """r, k, v, w: [B, T, H, hd]; u: [H, hd]; state: [B, H, hd, hd]
    float32 or None -> (o [B, T, H, hd] in r's dtype, final state
    [B, H, hd, hd] float32).  With ``state_out`` the final state is
    written there (it may be ``state``) and returned.  Float64 inputs
    compute in float64 (the CPU gradient checks)."""
    B, T, H, hd = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
    S = torch.zeros((B, H, hd, hd), dtype=acc, device=r.device) \
        if state is None else state.to(acc)
    uf = u.to(acc)[..., :, None]
    rf, kf, vf, wf = (t.to(acc) for t in (r, k, v, w))
    outs = []
    for t in range(T):
        o, S = _step(S, rf[:, t], kf[:, t], vf[:, t], wf[:, t], uf)
        outs.append(o)
    o = torch.stack(outs, 1).to(r.dtype)
    if state_out is not None:
        state_out.copy_(S)
        S = state_out
    return o, S


def chunks(x, chunk, fill):
    """[B, T, H, hd] -> float32 [B, nC, chunk, H, hd], the last chunk
    padded with ``fill``."""
    B, T, H, hd = x.shape
    nC = -(-T // chunk)
    out = torch.full((B, nC * chunk, H, hd), fill, dtype=torch.float32,
                     device=x.device)
    out[:, :T] = x.float()
    return out.view(B, nC, chunk, H, hd)


def suffix_products(w):
    """w [B, L, H, hd] float32 -> (P [B, L, H, hd] with P_s =
    prod_{s < tau < L} w_tau, D [B, H, hd] = prod_tau w_tau), by a
    backward running product."""
    P = torch.ones_like(w)
    for s in range(w.shape[1] - 2, -1, -1):
        P[:, s] = P[:, s + 1] * w[:, s + 1]
    return P, P[:, 0] * w[:, 0]


def chunk_summary(k, v, P):
    """k, v, P [B, L, H, hd] -> dS [B, H, hd, hd] = (k * P)^T v, what
    the chunk adds to the state it decays by D."""
    return torch.einsum("bshi,bshj->bhij", k * P, v)


def chunk_states(dS, D, state):
    """dS [B, nC, H, hd, hd], D [B, nC, H, hd], state or None -> (every
    chunk's start state [B, nC, H, hd, hd], the final state)."""
    B, nC, H, hd, _ = dS.shape
    S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dS.device) \
        if state is None else state.float()
    starts = []
    for c in range(nC):
        starts.append(S)
        S = D[:, c, :, :, None] * S + dS[:, c]
    return torch.stack(starts, 1), S


def chunk_outputs(rc, kc, vc, wc, u, starts):
    """The recurrence replayed over every chunk [B, nC, L, H, hd] from
    its start state: o [B, nC, L, H, hd] float32."""
    uf = u.float()[..., :, None]
    out = torch.empty_like(rc)
    for c in range(rc.shape[1]):
        S = starts[:, c]
        for s in range(rc.shape[2]):
            out[:, c, s], S = _step(S, rc[:, c, s], kc[:, c, s],
                                    vc[:, c, s], wc[:, c, s], uf)
    return out


def rwkv6_scan_chunked_ref(r, k, v, w, u, state=None, *, chunk):
    """The chunked route's three phases (module doc) in plain PyTorch:
    the arguments and result of ``rwkv6_scan_ref``, without
    ``state_out``."""
    B, T, H, hd = r.shape
    rc, kc, vc = (chunks(x, chunk, 0.0) for x in (r, k, v))
    wc = chunks(w, chunk, 1.0)
    dS, D = [], []
    for c in range(rc.shape[1]):
        P, Dc = suffix_products(wc[:, c])
        dS.append(chunk_summary(kc[:, c], vc[:, c], P))
        D.append(Dc)
    starts, S = chunk_states(torch.stack(dS, 1), torch.stack(D, 1), state)
    o = chunk_outputs(rc, kc, vc, wc, u, starts)
    return o.reshape(B, -1, H, hd)[:, :T].to(r.dtype), S
