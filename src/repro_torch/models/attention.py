"""Attention: GQA/MHA with RoPE, QKV bias, logit softcap, full / sliding
-window / local+global variants, bidirectional (encoder) and cross
attention, and ring-buffer KV caches for windowed decode.  The port of
``repro.models.attention``.

``_attend`` is a call into the hand-written ``flash_attention`` kernel
on CUDA and into its plain version on the CPU
(``repro_torch.kernels.flash_attention``), with the model's positions
as the kernel's mask.  The reference's ``_chunked_attend`` and
``_pick_chunk`` only keep XLA from materialising the [Q, S] scores of a
long prefill; the kernel never materialises them, so they are not
ported.

Prefill masks by index: its positions are consecutive (every caller
passes ``arange(S)``), so index i sees index j exactly where position i
sees position j, and the kernel, given no position tensors, bounds its
key loop by the causal and window limits.  Decode masks by the ring
cache's positions.  The encoder calls ``attn_apply`` with
``causal=False``; cross attention (``kv_override``: keys and values
projected from the encoder's output, no RoPE on q or k) also runs with
``causal=False`` and no positions, a mask of every key valid, which is
the reference's ``kpos = arange(Skv)`` under ``causal=False``.

``attend`` is the attention function, with ``flash_attention``'s
signature and that function by default; the plain version, or a
planted fault, may stand in for the kernel through it (``Model``'s
``attend``).

Decode writes the new key and value into the cache in place (the
reference returns new arrays): the caller's state is updated, which
saves a copy of every layer's cache per token.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L


def attn_init(generator, cfg, dtype):
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": L.dense_init(generator, D, H * hd, bias=cfg.qkv_bias,
                           dtype=dtype),
        "wk": L.dense_init(generator, D, KV * hd, bias=cfg.qkv_bias,
                           dtype=dtype),
        "wv": L.dense_init(generator, D, KV * hd, bias=cfg.qkv_bias,
                           dtype=dtype),
        "wo": L.dense_init(generator, H * hd, D, dtype=dtype),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _attend(q, k, v, qpos, kpos, *, causal, window, cap, scale,
            attend=None):
    """q: [B,Q,H,hd]; k,v: [B,S,KV,hd]; qpos: [Q] or [B,Q]; kpos: [S] or
    [B,S], int32, or None for the index.  kpos < 0 marks invalid
    (unwritten ring slots).  Returns [B,Q,H,hd]: the kernel reads the
    transposed views through their strides, and its output has q's
    layout."""
    out = (attend or flash_attention)(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=cap, scale=scale, q_pos=qpos,
        k_pos=kpos)
    return out.transpose(1, 2)


def attn_apply(params, x, positions, cfg, *, layer_window=None, causal=True,
               kv_override=None, return_kv=False, attend=None):
    """Full-sequence (prefill) attention.  positions: [S] int32,
    consecutive (the mask is by index; module doc).

    layer_window: None -> full attention; int -> sliding window.
    kv_override: [B, Skv, D] encoder output for cross attention (keys
        and values computed from it instead of x; no RoPE; pass
        ``causal=False``).
    return_kv: also return (k, v) post-rope for prefill cache population.
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, _ = x.shape
    kv_src = x if kv_override is None else kv_override
    q = _split_heads(L.dense(params["wq"], x), H, hd)
    k = _split_heads(L.dense(params["wk"], kv_src), KV, hd)
    v = _split_heads(L.dense(params["wv"], kv_src), KV, hd)
    if kv_override is None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, None, None, causal=causal, window=layer_window,
                  cap=cfg.attn_logit_softcap, scale=hd ** -0.5,
                  attend=attend)
    out = L.dense(params["wo"], out.reshape(B, S, H * hd))
    if return_kv:
        return out, (k, v)
    return out


def fill_cache_from_prefill(cache, k, v, positions, batch_size):
    """Scatter a full-sequence prefill's (k, v) into a (possibly ring)
    cache. positions: [S] absolute; ring slot = pos % size; only the
    last `size` positions survive (exactly what decode would have
    written).  Written into ``cache`` in place, which is returned."""
    size = cache["k"].shape[1]
    S = k.shape[1]
    take = min(S, size)
    pos_t = positions[S - take:]
    slots = (pos_t % size).long()
    cache["k"][:, slots] = k[:, S - take:]
    cache["v"][:, slots] = v[:, S - take:]
    cache["pos"][:, slots] = pos_t[None].expand(batch_size, take)
    return cache


# ---------------------------------------------------------------------------
# decode with KV cache (ring buffer for windowed layers)
# ---------------------------------------------------------------------------
def init_cache(cfg, batch, seq_len, layer_window, dtype, device=None):
    size = min(seq_len, layer_window) if layer_window else seq_len
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
    }


def attn_decode(params, x, position, cache, cfg, *, layer_window=None,
                attend=None):
    """One-token decode. x: [B,1,D]; position: [B] int32 (absolute);
    cache: dict with ring-buffer k/v/pos, written in place.  Returns
    (out, cache)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B = x.shape[0]
    q = _split_heads(L.dense(params["wq"], x), H, hd)
    k = _split_heads(L.dense(params["wk"], x), KV, hd)
    v = _split_heads(L.dense(params["wv"], x), KV, hd)
    q = L.apply_rope(q, position[:, None], cfg.rope_theta)
    k = L.apply_rope(k, position[:, None], cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = (position % size).long()                     # [B]
    b = torch.arange(B, device=x.device)
    cache["k"][b, slot] = k[:, 0]
    cache["v"][b, slot] = v[:, 0]
    cache["pos"][b, slot] = position

    out = _attend(q, cache["k"], cache["v"], position[:, None],
                  cache["pos"], causal=True, window=layer_window,
                  cap=cfg.attn_logit_softcap, scale=hd ** -0.5,
                  attend=attend)
    out = L.dense(params["wo"], out.reshape(B, 1, H * hd))
    return out, cache


def layer_window_for(cfg, layer_idx):
    """Resolve the attention window for a given layer index."""
    if cfg.attn_type == "swa":
        return cfg.window_size
    if cfg.attn_type == "local_global":
        # even layers local (windowed), odd layers global -- gemma2 style
        return cfg.window_size if layer_idx % 2 == 0 else None
    return None
