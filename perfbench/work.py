"""What the served work costs, counted from shapes: the yardstick of the
roofline shares and of the MFU.

``attention_*`` and ``mamba_scan_fused_work`` are frozen copies of the
port's ``roofline/work.py`` formulas (``attention_work`` on the meta
path, where the keys a row sees follow from the shapes, and
``mamba_scan_fused_work``), so a change to the program cannot move the
yardstick.  ``model_flops`` counts the model's own operations a token:
every matrix product (2 a multiply-add: projections, the router, the k
routed experts a token is sent to and the shared experts, the head),
attention's 4 hd a visible (query, key) pair a head, the Mamba
convolution and scan; no recompute, no padding, no capacity slack.
"""
from __future__ import annotations


def visible_pairs(Sq, Skv, causal=True, window=None) -> int:
    """(query, key) pairs a head sees with queries at Skv - Sq + i and
    keys at j, every key written (``roofline/work._visible_pairs``)."""
    total = 0
    for i in range(Skv - Sq, Skv):
        hi = min(Skv - 1, i) if causal else Skv - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def attention_prefill_work(S, H, KV, hd, size=2):
    """(flops, bytes) of one causal prefill call at batch 1: 4 hd flops a
    visible pair a head; q and o, k and v read or written once."""
    return 4 * H * hd * visible_pairs(S, S), 2 * S * H * hd * size + 2 * S * KV * hd * size


def attention_decode_work(keys, H, KV, hd, cache_len, size=2):
    """(flops, bytes) of one decode call over a batch whose rows see
    ``keys`` keys each (the slots that hold one, the new one included):
    q and o once, k and v once a live slot, the int32 positions of the
    queries and of every cache slot."""
    B = len(keys)
    live = sum(keys)
    return 4 * H * hd * live, (2 * B * H * hd * size +
                               2 * live * KV * hd * size +
                               4 * B * (1 + cache_len))


def mamba_scan_fused_work(B, T, D, N, size=2, with_state=False):
    """(bytes, float32 operations, exponentials) of ``mamba_scan_fused``:
    dt (float32), x, B, C, A and the input state read once, y (float32)
    and the state written once; a (b, t, d, n) step is dt A, (dt x) B,
    a h + bx (2), h C and its sum (2), plus dt x once a (b, t, d); one
    exponential a step."""
    nbytes = (4 * B * T * D + size * B * T * D + 2 * size * B * T * N +
              4 * D * N + (2 if with_state else 1) * 4 * B * D * N +
              4 * B * T * D)
    return nbytes, 6 * B * T * D * N + B * T * D, B * T * D * N


def _layer_kinds(cfg):
    from perfbench.reference.model import layer_kinds
    return layer_kinds(cfg)


def model_flops(cfg, tokens, keys, heads):
    """The model's operations for ``tokens`` tokens that see ``keys``
    keys in all at each attention layer (a prefill's token t sees t + 1;
    a decode step's row its position + 1), with the head applied to
    ``heads`` of them (a prefill's last token; every decoded one)."""
    D, V = cfg["d_model"], cfg["vocab_size"]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    flat, attn_layers = 0, 0
    for mixer, ffn in _layer_kinds(cfg):
        if mixer == "attn":
            flat += 2 * (2 * D * H * hd + 2 * D * KV * hd)
            attn_layers += 1
        else:
            d_in = cfg["ssm_expand"] * D
            N = cfg["ssm_state_dim"]
            r = max(1, D // 16)
            flat += 2 * (D * 2 * d_in + d_in * (r + 2 * N) + r * d_in +
                         d_in * D)
            flat += 2 * cfg["ssm_conv_width"] * d_in + 6 * d_in * N + d_in
        if ffn == "dense0":
            flat += 6 * D * cfg["first_layer_dense_ff"]
        elif ffn == "dense":
            flat += 6 * D * cfg["d_ff"]
        else:
            F = cfg.get("moe_d_ff") or cfg["d_ff"]
            flat += 2 * D * cfg["num_experts"]
            flat += cfg["num_experts_per_tok"] * 6 * D * F
            flat += 6 * D * cfg.get("num_shared_experts", 0) * F
    return tokens * flat + heads * 2 * D * V + attn_layers * 4 * H * hd * keys
