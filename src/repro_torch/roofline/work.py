"""What each kernel's function needs, counted from its inputs: the
operations and the bytes (each input read once, each output written
once) behind the bounds that ``chip_smoke.py`` prints beside every
kernel time, and behind the dry run's count of a kernel call
(``roofline.costs``).  Where the work depends on the data (the keys an
attention row sees), a real input is counted as it is; a meta input,
whose values do not exist, is counted by the rule each function
states."""
from __future__ import annotations

import numpy as np


def _visible_pairs(Sq, Skv, causal, window) -> int:
    """(query, key) pairs a row sees with queries at Skv - Sq + i and
    keys at j, every key written: the reference mask's count for
    ``q_pos = k_pos = None`` at Sq == Skv, and a full cache's at a
    decode step."""
    i = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(Skv - 1, i) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_work(q, k, causal, window, q_pos, k_pos):
    """(flops, bytes) of ``flash_attention(q [B, H, Sq, hd], k [B, KV,
    Skv, hd], ...)``: 4 * hd flops per visible (query, key) pair; q, o
    and the positions once, and k, v once for the slots that hold a key
    (position >= 0).  On the meta device every slot holds a key and the
    queries are the newest positions (``_visible_pairs``)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        pairs = B * _visible_pairs(Sq, Skv, causal, window)
        slots = B * Skv
    else:
        from repro_torch.kernels.flash_attention.ref import attention_mask
        mask = attention_mask(Sq, Skv, q_pos, k_pos, causal, window,
                              q.device)
        # a mask by key alone (non-causal, no window) is [.., 1, Skv]
        mask = mask.expand(mask.shape[0], 1, Sq, Skv)
        pairs = int(mask.sum()) * (B // mask.shape[0])
        slots = B * Skv if k_pos is None else \
            int((k_pos >= 0).sum()) * (B if k_pos.dim() == 1 else 1)
    size = q.element_size()
    nbytes = 2 * q.numel() * size + 2 * slots * KV * hd * size + sum(
        4 * p.numel() for p in (q_pos, k_pos) if p is not None)
    return 4 * H * hd * pairs, nbytes


def router_work(T, E, k):
    """(bytes, float32 operations) of ``moe_router`` over [T, E] logits:
    the logits read, weights and indices written, a tile's stats each;
    per logit max, subtract, exp, sum, divide, k compares and the stats'
    two adds."""
    n_tiles = -(-T // min(128, T))
    return 4 * T * E + 8 * T * k + 4 * n_tiles * E, T * E * (7 + k)


def rwkv6_scan_work(r, u, with_state):
    """(bytes, float32 operations) of ``rwkv6_scan`` over r [B, T, H,
    hd]: r, k, v, w read and o written, u, the state written (and read,
    from a state); a (b, t, h) step is o_j = sum_i r_i S_ij + v_j sum_i
    r_i u_i k_i (2 hd^2 + 5 hd) and S_ij <- w_i S_ij + k_i v_j
    (3 hd^2)."""
    B, T, H, hd = r.shape
    nbytes = 5 * r.numel() * r.element_size() + u.numel() * 4 + \
        (2 if with_state else 1) * B * H * hd * hd * 4
    return nbytes, (5 * hd * hd + 5 * hd) * B * T * H


def mamba_scan_work(a, c, with_state):
    """(bytes, float32 operations) of the unfused ``mamba_scan`` over a,
    bx [B, T, D, N] and c [B, T, N]: a, bx, c read, y written, the state
    written (and read); h <- a h + bx, then y = sum h c."""
    B, T, D, N = a.shape
    nbytes = (2 * a.numel() + c.numel() + B * T * D) * a.element_size() \
        + (2 if with_state else 1) * B * D * N * 4
    return nbytes, 4 * B * T * D * N


def mamba_scan_fused_work(dt, x, Bm, A, h0):
    """(bytes, float32 operations, exponentials) of ``mamba_scan_fused``:
    dt, x, B, C, A and the input state read once, y and the state
    written once; a (b, t, d, n) step is dt A, (dt x) B, a h + bx (2), h
    C and its sum (2), plus dt x once a (b, t, d); one exponential."""
    B, T, D = dt.shape
    N = A.shape[1]
    size = x.element_size()
    nbytes = (4 * B * T * D + size * B * T * D + 2 * size * B * T * N +
              4 * D * N + (2 if h0 is not None else 1) * 4 * B * D * N +
              4 * B * T * D)
    return nbytes, 6 * B * T * D * N + B * T * D, B * T * D * N


def vfl_matmul_work(M, k_sum, N, n_clients):
    """(bytes, float32 flops) of ``vfl_matmul_clients``: each client's x
    slice [M, F_i] and W rows [F_i, N] read, its [M, N] output written,
    three int32 offsets or sizes a client; 2 M N F_i flops a client."""
    nbytes = 4 * (M * k_sum + k_sum * N + n_clients * M * N) + \
        3 * 4 * n_clients
    return nbytes, 2 * M * N * k_sum
