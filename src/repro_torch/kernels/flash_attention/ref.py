"""Plain PyTorch version of flash attention: what the CUDA kernel
computes, written with ordinary tensor ops.  The CPU path of the
wrapper runs it, and ``chip_smoke.py`` holds the kernel against it on
the card.

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
    Returns [B, H, Sq, hd] in q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    group = H // KV
    scale = scale if scale is not None else hd ** -0.5
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Skv, q_pos, k_pos, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key -> zero output (the kernel's l == 0 guard)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
