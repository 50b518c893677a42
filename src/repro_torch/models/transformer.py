"""Decoder and encoder stacks assembled from a ModelConfig: the port of
``repro.models.transformer``: the attention, Mamba and RWKV6 mixers,
cross attention over an encoder's output (``kind["cross"]``, the audio
family), and the dense, layer-0 dense (``dense0``), MoE and RWKV
channel-mix (``rwkv_cm``) FFNs.  Every block and stack function takes
the encoder's output as ``enc`` (None: no cross attention, as in the
reference); decode recomputes the cross keys and values from ``enc`` at
every step, as the reference does.

Layer stacks keep the reference's (prefix, periodic-group) form and its
parameter tree: the periodic part lives under ``"scanned"`` with a
leading [n_groups] axis on every leaf, so weights cross between the
packages with no reshapes.  Where the reference ``lax.scan``s over the
groups, the port runs a Python loop over that axis.

The De-VertiFL input block (``embed_input``): with one client it is the
plain lookup, the vlm family's image rows (``prefix_emb``) before the
text.  With n clients (the size of the reference's mesh client axis,
which one card does not have) it emulates the reference's ``shard_map``
on one device: client i looks up its column slice of the embedding
table, puts its column slice of ``prefix_emb`` before it, and the
clients' slices meet in ``exchange_features`` (paper Algorithm 2's
zero-padded sum, or a gather).  Every sum there adds exact zeros, so
both modes give the one-client features bit for bit.  The reference's
``_tied_logits`` custom VJP only keeps a vocab-sharded gradient
sharded; autograd of ``h @ table.T`` computes the same gradient here.

``hooks`` (block and stack functions) holds the functions that stand
in for the kernels, each under its keyword and None for the kernel:
``attend`` (``models.attention``; ``flash_attention``), ``route``
(``models.moe``; ``moe_router``), ``wkv`` and ``sscan``
(``models.ssm``; ``rwkv6_scan`` and ``mamba_scan_fused``).  The MoE
load-balance loss is summed over the stack by ``stack_apply``, as in
the reference; prefill and decode drop it.

Training differentiates ``stack_apply``.  Where autograd is recording,
``cfg.remat`` recomputes activations in the backward, as the
reference's ``jax.remat`` does (``torch.utils.checkpoint``,
non-reentrant): the default policy checkpoints each prefix block and
each periodic group (the reference's remat'ed scan body);
``remat_policy="save_mixer_ffn"`` checkpoints each block's mixer and
FFN halves apart, keeping their outputs.  Remat changes memory, not
values.  A remat'ed layer runs its forward twice, so its kernels launch
twice a training step.  The stacked group leaves are unbound once, so
that the backward stacks each leaf's gradient once instead of adding
a full-size zero-padded gradient per group.

Decode writes every layer's cache in place: the attention ring, the
RWKV state and token-shift rows, the Mamba state and conv history.

Spans (``repro_torch.obs.trace``, into the tracer the serving engine
armed): a prefill or decode block's mixer under ``mixer.<attn|mamba|
rwkv>``, every FFN under ``ffn.<mlp|moe|rwkv_cm>`` (the MoE one a
device span too, holding ``moe_apply``'s own).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.obs import trace as _trace
from repro_torch.tree import tree_map


def _unported(what):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (only the reference's "
        "block kinds); see ROADMAP.md, Queue 1 item 6")


# ---------------------------------------------------------------------------
# layer-kind schedule
# ---------------------------------------------------------------------------
def layer_kinds(cfg):
    kinds = []
    for l in range(cfg.num_layers):
        if cfg.ssm_type == "rwkv6":
            mixer = "rwkv"
        elif cfg.ssm_type == "mamba" and (
                cfg.attn_layer_period == 0
                or l % cfg.attn_layer_period != cfg.attn_layer_offset):
            mixer = "mamba"
        else:
            mixer = "attn"
        window = A.layer_window_for(cfg, l) if mixer == "attn" else None
        if mixer == "rwkv":
            ffn = "rwkv_cm"
        elif l == 0 and cfg.first_layer_dense_ff:
            ffn = "dense0"
        elif cfg.num_experts and (l % cfg.moe_every) == cfg.moe_offset:
            ffn = "moe"
        else:
            ffn = "dense"
        kinds.append({
            "mixer": mixer, "ffn": ffn, "window": window,
            "cross": cfg.is_encoder_decoder, "causal": True,
        })
    return kinds


def encoder_kinds(cfg):
    return [{"mixer": "attn", "ffn": "dense", "window": None,
             "cross": False, "causal": False}
            for _ in range(cfg.num_encoder_layers)]


def periodic_split(kinds):
    """Return (prefix_len, period) decomposing kinds into an irregular
    prefix followed by a periodic tail."""
    n = len(kinds)
    for prefix in (0, 1, 2):
        rest = kinds[prefix:]
        if not rest:
            continue
        for period in range(1, min(16, len(rest)) + 1):
            if len(rest) % period:
                continue
            if all(rest[i] == rest[i % period] for i in range(len(rest))):
                return prefix, period
    return n, 1


_MIXERS = ("attn", "mamba", "rwkv")
_FFNS = ("dense", "dense0", "moe", "rwkv_cm")
_MIXER_SPAN = {m: f"mixer.{m}" for m in _MIXERS}
_FFN_SPAN = {"dense": "ffn.mlp", "dense0": "ffn.mlp", "moe": "ffn.moe",
             "rwkv_cm": "ffn.rwkv_cm"}


def _check_kind(kind):
    if kind["mixer"] not in _MIXERS:
        raise _unported(f"the {kind['mixer']!r} mixer")
    if kind["ffn"] not in _FFNS:
        raise _unported(f"the {kind['ffn']!r} FFN")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
def block_init(generator, cfg, kind, dtype):
    _check_kind(kind)
    D, dev = cfg.d_model, generator.device
    p = {"pre_norm": L.norm_init(D, cfg.norm_type, dev)}
    if kind["mixer"] == "attn":
        p["attn"] = A.attn_init(generator, cfg, dtype)
    elif kind["mixer"] == "mamba":
        p.update(S.mamba_init(generator, cfg, dtype))
    elif kind["mixer"] == "rwkv":
        p.update(S.rwkv_init(generator, cfg, dtype))
    if kind["cross"]:
        p["cross_norm"] = L.norm_init(D, cfg.norm_type, dev)
        p["cross"] = A.attn_init(generator, cfg, dtype)
    p["ffn_norm"] = L.norm_init(D, cfg.norm_type, dev)
    if kind["ffn"] == "moe":
        p["moe"] = M.moe_init(generator, cfg, dtype)
    elif kind["ffn"] in ("dense", "dense0"):
        width = cfg.first_layer_dense_ff if kind["ffn"] == "dense0" \
            else cfg.d_ff
        p["ffn"] = L.mlp_init(generator, D, width, cfg.act, dtype)
    return p


def _ffn(p, h2, cfg, kind, hooks, with_aux=False, x_prev=None):
    """The block's FFN on its normed input: (y, aux or None).
    ``x_prev`` is the RWKV channel mix's previous token (None: zeros)."""
    ffn = kind["ffn"]
    with _trace.current().span(_FFN_SPAN[ffn], cat="model",
                               device=ffn == "moe"):
        if ffn == "rwkv_cm":
            return S.rwkv_channel_mix(p, h2, cfg, x_prev=x_prev), None
        if ffn == "moe":
            return M.moe_apply(p["moe"], h2, cfg, hooks.get("route"),
                               with_aux)
        return L.mlp_apply(p["ffn"], h2, cfg.act), None


def _cross(p, x, positions, cfg, kind, hooks, enc):
    """x plus the block's cross attention over ``enc`` (x unchanged
    where the kind has none or ``enc`` is None, as in the reference)."""
    if not kind["cross"] or enc is None:
        return x
    hc = L.apply_norm(p["cross_norm"], x, cfg.norm_type)
    return x + A.attn_apply(p["cross"], hc, positions, cfg, causal=False,
                            kv_override=enc, attend=hooks.get("attend"))


def _mixer_half(p, x, positions, cfg, kind, hooks, enc):
    """x plus the block's mixer (and cross attention)."""
    h = L.apply_norm(p["pre_norm"], x, cfg.norm_type)
    if kind["mixer"] == "attn":
        y = A.attn_apply(p["attn"], h, positions, cfg,
                         layer_window=kind["window"],
                         causal=kind.get("causal", True),
                         attend=hooks.get("attend"))
    elif kind["mixer"] == "mamba":
        y = S.mamba_apply(p, h, cfg, sscan=hooks.get("sscan"))
    elif kind["mixer"] == "rwkv":
        y = S.rwkv_time_mix(p, h, cfg, wkv=hooks.get("wkv"))
    return _cross(p, x + y, positions, cfg, kind, hooks, enc)


def _ffn_half(p, x, cfg, kind, hooks):
    """(x plus the block's FFN, aux)."""
    h2 = L.apply_norm(p["ffn_norm"], x, cfg.norm_type)
    y, aux = _ffn(p, h2, cfg, kind, hooks, with_aux=True)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _call(fn, *args):
    return fn(*args)


def _recomputed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def block_apply(p, x, positions, cfg, kind, hooks=None, enc=None,
                run=_call):
    """Full-sequence block. Returns (x, aux_loss); aux is 0 without MoE.
    ``run(fn, *args)`` runs each half (``_recomputed``: the
    "save_mixer_ffn" remat policy)."""
    _check_kind(kind)
    hooks = hooks or {}
    x = run(_mixer_half, p, x, positions, cfg, kind, hooks, enc)
    return run(_ffn_half, p, x, cfg, kind, hooks)


def block_prefill(p, x, positions, cfg, kind, batch, cache_len, dtype,
                  hooks=None, enc=None):
    """Full-sequence forward that also emits the decode cache for this
    block (forward-only: the inference-prefill path)."""
    _check_kind(kind)
    hooks = hooks or {}
    with _trace.current().span(_MIXER_SPAN[kind["mixer"]], cat="model"):
        y, cache = _mixer_prefill(p, x, positions, cfg, kind, batch,
                                  cache_len, dtype, hooks)
    x = _cross(p, x + y, positions, cfg, kind, hooks, enc)
    h2 = L.apply_norm(p["ffn_norm"], x, cfg.norm_type)
    if kind["ffn"] == "rwkv_cm":
        cache["rwkv"]["x_prev_cm"] = h2[:, -1, :].clone()
    return x + _ffn(p, h2, cfg, kind, hooks)[0], cache


def _mixer_prefill(p, x, positions, cfg, kind, batch, cache_len, dtype,
                   hooks):
    """The block's mixer over the sequence: (y, its decode cache)."""
    h = L.apply_norm(p["pre_norm"], x, cfg.norm_type)
    cache = {}
    if kind["mixer"] == "attn":
        y, (k, v) = A.attn_apply(p["attn"], h, positions, cfg,
                                 layer_window=kind["window"],
                                 causal=kind.get("causal", True),
                                 return_kv=True, attend=hooks.get("attend"))
        empty = A.init_cache(cfg, batch,
                             min(cache_len, kind["window"])
                             if kind["window"] else cache_len,
                             kind["window"], dtype, x.device)
        cache["attn"] = A.fill_cache_from_prefill(empty, k, v, positions,
                                                  batch)
    elif kind["mixer"] == "mamba":
        y, cache["mamba"] = S.mamba_apply(p, h, cfg, return_state=True,
                                          sscan=hooks.get("sscan"))
    elif kind["mixer"] == "rwkv":
        # the normed last rows: what decode's token shift reads
        y, cache["rwkv"] = S.rwkv_time_mix(p, h, cfg, return_state=True,
                                           wkv=hooks.get("wkv"))
    return y, cache


def block_init_cache(cfg, kind, batch, seq_len, dtype, device=None):
    _check_kind(kind)
    if kind["mixer"] == "attn":
        return {"attn": A.init_cache(cfg, batch, seq_len, kind["window"],
                                     dtype, device)}
    if kind["mixer"] == "mamba":
        return {"mamba": S.mamba_init_state(cfg, batch, dtype, device)}
    if kind["mixer"] == "rwkv":
        return {"rwkv": S.rwkv_init_state(cfg, batch, dtype, device)}


def block_decode(p, x, position, cfg, kind, cache, hooks=None, enc=None):
    """One-token decode. Returns (x, cache), the cache written in
    place; the cross attention's keys and values are projected from
    ``enc`` anew (no cache)."""
    _check_kind(kind)
    hooks = hooks or {}
    with _trace.current().span(_MIXER_SPAN[kind["mixer"]], cat="model"):
        y, new_cache = _mixer_decode(p, x, position, cfg, kind, cache,
                                     hooks)
    x = _cross(p, x + y, position[:, None], cfg, kind, hooks, enc)
    h2 = L.apply_norm(p["ffn_norm"], x, cfg.norm_type)
    st = cache.get("rwkv")
    y = _ffn(p, h2, cfg, kind, hooks,
             x_prev=st["x_prev_cm"] if st is not None else None)[0]
    if st is not None:
        st["x_prev_cm"].copy_(h2[:, -1, :])
    return x + y, new_cache


def _mixer_decode(p, x, position, cfg, kind, cache, hooks):
    """The block's mixer for one token: (y, the cache, written in
    place)."""
    h = L.apply_norm(p["pre_norm"], x, cfg.norm_type)
    new_cache = dict(cache)
    if kind["mixer"] == "attn":
        y, new_cache["attn"] = A.attn_decode(
            p["attn"], h, position, cache["attn"], cfg,
            layer_window=kind["window"], attend=hooks.get("attend"))
    elif kind["mixer"] == "mamba":
        y, new_cache["mamba"] = S.mamba_decode(p, h, cache["mamba"], cfg,
                                               sscan=hooks.get("sscan"))
    elif kind["mixer"] == "rwkv":
        st = cache["rwkv"]
        y = S.rwkv_time_mix(p, h, cfg, x_prev=st["x_prev_tm"],
                            state=st["wkv"], state_out=st["wkv"],
                            wkv=hooks.get("wkv"))
        st["x_prev_tm"].copy_(h[:, -1, :])
    return y, new_cache


# ---------------------------------------------------------------------------
# stacks (prefix + periodic groups stacked on a leading axis)
# ---------------------------------------------------------------------------
class StackLayout:
    def __init__(self, cfg, kinds):
        self.kinds = kinds
        if cfg.scan_layers:
            self.prefix, self.period = periodic_split(kinds)
        else:
            self.prefix, self.period = len(kinds), 1
        self.n_groups = (len(kinds) - self.prefix) // self.period \
            if self.prefix < len(kinds) else 0
        self.group_kinds = kinds[self.prefix:self.prefix + self.period] \
            if self.n_groups else []


def _stacked(make, n):
    """``make(g)`` for g < n as one tree with a leading [n] axis on
    every leaf, filled one ``make`` at a time, so that beside the stack
    only one made tree is ever held."""
    first = make(0)
    out = tree_map(lambda t: t.new_empty((n,) + t.shape), first)
    tree_map(lambda dst, src: dst[0].copy_(src), out, first)
    del first
    for g in range(1, n):
        tree_map(lambda dst, src: dst[g].copy_(src), out, make(g))
    return out


def _group(tree, g):
    """Group ``g`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda t: t[g], tree)


def stack_init(generator, cfg, kinds, dtype):
    layout = StackLayout(cfg, kinds)
    params = {}
    for i in range(layout.prefix):
        params[f"layer_{i}"] = block_init(generator, cfg, kinds[i], dtype)
    if layout.n_groups:
        # stacked one layer at a time: a jamba group (8 layers) is 26 GB
        # of bf16, more than the card holds beside the stack twice.  The
        # draws run sub by sub, each over the groups; with a period of
        # one (qwen2, deepseek-moe, rwkv6) that is the layers' own order
        params["scanned"] = {
            f"sub_{j}": _stacked(
                lambda _, kind=kind: block_init(generator, cfg, kind, dtype),
                layout.n_groups)
            for j, kind in enumerate(layout.group_kinds)}
    return params


def stack_apply(params, x, positions, cfg, kinds, hooks=None, enc=None):
    """The stack over [B, S, D]: (x, the summed MoE aux), remat'ed as
    ``cfg`` says where autograd records (module doc)."""
    layout = StackLayout(cfg, kinds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    halves = remat and cfg.remat_policy == "save_mixer_ffn"
    if remat and cfg.remat_policy not in ("", "save_mixer_ffn"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    whole = _recomputed if remat and not halves else _call
    run = _recomputed if halves else _call

    def block(p, x, aux, kind):
        x, a = block_apply(p, x, positions, cfg, kind, hooks, enc, run)
        return x, aux + a

    def group(gparams, x, aux):
        for j, kind in enumerate(layout.group_kinds):
            x, aux = block(gparams[f"sub_{j}"], x, aux, kind)
        return x, aux

    for i in range(layout.prefix):
        x, aux = whole(block, params[f"layer_{i}"], x, aux, kinds[i])
    if layout.n_groups:
        groups = tree_map(lambda t: t.unbind(0), params["scanned"])
        for g in range(layout.n_groups):
            x, aux = whole(group, tree_map(lambda t: t[g], groups), x, aux)
    return x, aux


def stack_init_cache(cfg, kinds, batch, seq_len, dtype, device=None):
    """Every layer's empty cache, on ``device``: CUDA unless the caller
    names another (raises without a card)."""
    from repro_torch.core.protocol import resolve_device
    device = resolve_device(device)
    layout = StackLayout(cfg, kinds)
    cache = {}
    for i in range(layout.prefix):
        cache[f"layer_{i}"] = block_init_cache(cfg, kinds[i], batch, seq_len,
                                               dtype, device)
    if layout.n_groups:
        cache["scanned"] = _stacked(
            lambda _: {f"sub_{j}": block_init_cache(cfg, kind, batch,
                                                    seq_len, dtype, device)
                       for j, kind in enumerate(layout.group_kinds)},
            layout.n_groups)
    return cache


def stack_prefill(params, x, positions, cfg, kinds, batch, cache_len,
                  dtype, hooks=None, enc=None):
    layout = StackLayout(cfg, kinds)
    cache = {}
    for i in range(layout.prefix):
        x, cache[f"layer_{i}"] = block_prefill(
            params[f"layer_{i}"], x, positions, cfg, kinds[i], batch,
            cache_len, dtype, hooks, enc)
    groups = []
    for g in range(layout.n_groups):
        gparams = _group(params["scanned"], g)
        newc = {}
        for j, kind in enumerate(layout.group_kinds):
            x, newc[f"sub_{j}"] = block_prefill(
                gparams[f"sub_{j}"], x, positions, cfg, kind, batch,
                cache_len, dtype, hooks, enc)
        groups.append(newc)
    if groups:
        cache["scanned"] = tree_map(lambda *xs: torch.stack(xs), *groups)
    return x, cache


def stack_decode(params, x, position, cfg, kinds, cache, hooks=None,
                 enc=None):
    """One-token decode over the stack; every layer's cache is written
    in place (the tree's dicts and tensors stay the same objects) and
    ``cache`` is returned."""
    layout = StackLayout(cfg, kinds)
    for i in range(layout.prefix):
        x, _ = block_decode(params[f"layer_{i}"], x, position, cfg,
                            kinds[i], cache[f"layer_{i}"], hooks, enc)
    for g in range(layout.n_groups):
        gparams = _group(params["scanned"], g)
        gcache = _group(cache["scanned"], g)
        for j, kind in enumerate(layout.group_kinds):
            x, _ = block_decode(gparams[f"sub_{j}"], x, position, cfg, kind,
                                gcache[f"sub_{j}"], hooks, enc)
    return x, cache


# ---------------------------------------------------------------------------
# De-VertiFL input block and output head
# ---------------------------------------------------------------------------
EXCHANGE_MODES = ("zeropad_psum", "allgather")


def exchange_features(x_slices, mode):
    """HiddenOutputExchange over client-sharded features: the reference's
    ``exchange_features`` with the mesh's client axis laid out as a
    list.  ``x_slices`` holds the n clients' [..., D/n] slices in client
    order; returns the full-width [..., D].

    'zeropad_psum' (paper Algorithm 2): each client zero-pads its slice
    to full width at offset i * D/n (the [n, ..., D] stack of what the
    clients transmit is materialised), and the padded tensors are summed
    (each element has one nonzero summand, so the order is moot).
    'allgather': the slices are concatenated.  Any other mode raises
    (the reference gathers under any name but 'zeropad_psum')."""
    if mode == "zeropad_psum":
        n, d = len(x_slices), x_slices[0].shape[-1]
        padded = torch.stack([F.pad(x, (i * d, (n - 1 - i) * d))
                              for i, x in enumerate(x_slices)])
        return padded.sum(0)
    if mode == "allgather":
        return torch.cat(x_slices, dim=-1)
    raise ValueError(f"unknown exchange mode {mode!r}; options: "
                     f"{', '.join(EXCHANGE_MODES)}")


def client_inputs(table, ids, prefix_emb, clients):
    """Each client's [B, P + S, D/n] input to the exchange: its column
    slice of ``table`` looked up at ``ids``, after its column slice of
    ``prefix_emb`` (cast to the table's dtype) where there is one.  The
    table is split once, so that the backward concatenates the clients'
    [V, D/n] gradients once instead of adding a zero-padded [V, D]
    gradient per client."""
    d = table.shape[-1] // clients
    tables = table.split(d, dim=-1)
    prefixes = [None] * clients if prefix_emb is None else \
        prefix_emb.split(d, dim=-1)
    out = []
    for t, p in zip(tables, prefixes):
        emb = L.embed({"table": t}, ids)
        if p is not None:
            emb = torch.cat([p.to(emb.dtype), emb], dim=1)
        out.append(emb)
    return out


def embed_input(params, ids, cfg, prefix_emb=None, clients=1):
    """Token embedding with the De-VertiFL vertical input block: the
    reference's ``embed_input`` (``transformer.py:399-448``).
    ``prefix_emb`` [B, P, D] (the vlm family's image rows), cast to the
    table's dtype, goes before the text.  ``clients`` stands for the
    size of the reference's mesh client axis: with 1, or with the input
    block off (``cfg.vfl.enabled`` false), the plain lookup; otherwise
    each client's column slice (``client_inputs``) goes through
    ``exchange_features`` under ``cfg.vfl.exchange``, and d_model must
    divide among the clients, as the reference's ``shard_map``
    requires.  Returns [B, P + S, D], scaled by sqrt(d_model) where the
    config has a final softcap (gemma2), in the table's dtype: by a
    0-d tensor made once per value, dtype and device
    (``_emb_scale``), which a CUDA graph's capture can read."""
    emb_scale = cfg.d_model ** 0.5 if cfg.final_logit_softcap else 1.0
    key = "vfl_embedding" if cfg.vfl.enabled else "embedding"
    if clients == 1 or not cfg.vfl.enabled:
        h = L.embed(params[key], ids)
        if prefix_emb is not None:
            h = torch.cat([prefix_emb.to(h.dtype), h], dim=1)
    else:
        if cfg.d_model % clients:
            raise ValueError(f"d_model {cfg.d_model} does not divide "
                             f"among {clients} clients")
        h = exchange_features(client_inputs(params[key]["table"], ids,
                                            prefix_emb, clients),
                              cfg.vfl.exchange)
    return h * _emb_scale(emb_scale, h.dtype, h.device)


@functools.lru_cache(maxsize=None)
def _emb_scale(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def logits_from_hidden(params, h, cfg):
    key = "vfl_embedding" if cfg.vfl.enabled else "embedding"
    if cfg.tie_embeddings:
        logits = h @ params[key]["table"].T
    else:
        logits = L.dense(params["lm_head"], h)
    return L.softcap(logits.float(), cfg.final_logit_softcap)
