"""Plain PyTorch version of flash attention: what the CUDA kernels
compute, written with ordinary tensor ops.  The CPU path of the
wrapper runs ``flash_attention_ref``, and ``chip_smoke.py`` holds the
kernels against it on the card.  Two more plain functions state the
kernels' arithmetic for the CPU tests; no path runs them:
``tensor_core_emulation`` (the bf16 ``wgmma`` route's numerics) and
``decode_partials_ref`` with ``combine_ref`` (the split-K routes').

The port of ``repro.kernels.flash_attention.ref.flash_attention_ref``,
extended by optional int32 position tensors so that it also serves the
model's decode over a ring-buffer cache:

  q_pos [Sq] or [B, Sq], k_pos [Skv] or [B, Skv]  (default: arange)
  mask = k_pos >= 0 & (k_pos <= q_pos if causal)
                    & (q_pos - k_pos < window if window)

which is the mask of the reference model's ``_attend``
(``repro/models/attention.py:53-64``); with the default positions it is
the Pallas kernel's iota mask.

A row with no valid key gives 0 here and in the kernel (the Pallas
kernel's ``l == 0`` guard).  The reference model's ``_attend`` gives the
mean of v on such a row instead (a softmax over equal NEG_INF scores).
No row on the serving path is fully masked: a query always sees its
own position.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def attention_mask(sq, skv, q_pos, k_pos, causal, window, device):
    """Boolean [B|1, 1, Sq, Skv] mask of the keys each query row sees."""
    if q_pos is None:
        q_pos = torch.arange(sq, device=device)
    if k_pos is None:
        k_pos = torch.arange(skv, device=device)
    qp = q_pos.reshape(-1, 1, sq, 1).long()
    kp = k_pos.reshape(-1, 1, 1, skv).long()
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
                        scale=None, q_pos=None, k_pos=None):
    """q: [B, H, Sq, hd]; k, v: [B, KV, Skv, hd]; H % KV == 0.
    Returns [B, H, Sq, hd] in q's dtype, computed in float32 (float64
    for float64 inputs: the CPU gradient checks)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    group = H // KV
    scale = scale if scale is not None else hd ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    kr = k.to(acc).repeat_interleave(group, dim=1)
    vr = v.to(acc).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kr) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Skv, q_pos, k_pos, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key -> zero output (the kernel's l == 0 guard)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def _logits(q, k, scale, softcap, mask):
    """Scaled, softcapped, masked scores in float32 (-inf where masked);
    q [B, H, Sq, hd], k [B, H, n, hd] already repeated over the group."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return torch.where(mask, s, -torch.inf)


def tensor_core_emulation(q, k, v, *, causal=True, window=None, softcap=0.0,
                          scale=None, q_pos=None, k_pos=None, split_p=True,
                          tile=64):
    """The bf16 tensor-core route's numerics in plain float32 ops: bf16
    q, k, v; per tile of ``tile`` keys, S = q . k^T summed in float32,
    scale, softcap and mask, then the online softmax (running max m,
    rescale alpha = e^(m_old - m_new), denominator l summed from the
    unrounded float32 P); P enters P . V as bf16, split into
    P_hi = bf16(P) and P_lo = bf16(P - P_hi) when ``split_p`` (the
    kernel) or rounded once (what SDPA and FlashAttention do); the
    accumulator is float32 and the output one bf16 rounding of o / l.
    Returns [B, H, Sq, hd] in bfloat16."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    group = H // KV
    scale = scale if scale is not None else hd ** -0.5
    kr = k.to(torch.bfloat16).float().repeat_interleave(group, dim=1)
    vr = v.to(torch.bfloat16).float().repeat_interleave(group, dim=1)
    qf = q.to(torch.bfloat16).float()
    mask = attention_mask(Sq, Skv, q_pos, k_pos, causal, window, q.device)
    m = torch.full((B, H, Sq, 1), -torch.inf)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    for t0 in range(0, Skv, tile):
        x = _logits(qf, kr[:, :, t0:t0 + tile], scale, softcap,
                    mask[..., t0:t0 + tile])
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        ref_m = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - ref_m)
        p = torch.exp(x - ref_m)
        hi = p.to(torch.bfloat16).float()
        v_t = vr[:, :, t0:t0 + tile]
        pv = hi @ v_t
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ v_t
        acc = acc * alpha + pv
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    out = torch.where(l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    return out.to(torch.bfloat16)


def decode_partials_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
                        scale=None, q_pos=None, k_pos=None, n_splits=1):
    """The split-K routes' first kernel: the kv axis cut into
    ``n_splits`` runs of ceil(Skv / n_splits) slots, and per (row,
    split) the max m of the visible scores (-inf if none), l = sum of
    e^(s - m) and the unnormalised o = sum of e^(s - m) v, in float32.
    Returns m, l [B, H, Sq, n_splits] and o [B, H, Sq, n_splits, hd]."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    group = H // KV
    scale = scale if scale is not None else hd ** -0.5
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    mask = attention_mask(Sq, Skv, q_pos, k_pos, causal, window, q.device)
    size = max(1, -(-Skv // n_splits))
    ms, ls, os = [], [], []
    for s in range(n_splits):
        sl = slice(s * size, (s + 1) * size)
        x = _logits(q, kr[:, :, sl], scale, softcap, mask[..., sl])
        m = x.amax(-1, keepdim=True) if x.shape[-1] else \
            torch.full((B, H, Sq, 1), -torch.inf)
        p = torch.exp(x - torch.where(m == -torch.inf, 0.0, m))
        ms.append(m[..., 0])
        ls.append(p.sum(-1))
        os.append(p @ vr[:, :, sl])
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(os, -2)


def combine_ref(m, l, o):
    """The split-K routes' second kernel: a row's partials merged,
    o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s over the splits
    with l_s > 0 (M their largest m); 0 where no split has l > 0.
    m, l [..., S], o [..., S, hd] -> [..., hd] in float32."""
    live = l > 0
    big = torch.where(live, m, -torch.inf).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - torch.where(big == -torch.inf, 0.0,
                                                    big)), 0.0)
    den = (w * l).sum(-1, keepdim=True)
    num = (w[..., None] * torch.where(live[..., None], o, 0.0)).sum(-2)
    return torch.where(den == 0, 0.0, num / torch.where(den == 0, 1.0, den))
