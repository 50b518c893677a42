"""Mixture-of-Experts on one device: the port of ``repro.models.moe``,
with a dropless path beside the reference's capacity dispatch.

Supports Mixtral-style (8 routed, top-2, renormalized) and
DeepSeekMoE-style (64 fine-grained routed top-6 + shared experts that
every token visits, one fused dense FFN of width n_shared * d_ff).

Routing runs the hand-written ``moe_router`` kernel on CUDA and its
plain version on the CPU (``repro_torch.kernels.moe_router``).  The
reference model computes ``softmax`` + ``lax.top_k`` + renormalise
inline (``repro/models/moe.py:193-196``); the kernel computes the same
thing, in ``lax.top_k``'s order.  ``route`` is the router function,
with ``moe_router``'s signature and that function by default; the plain
version, or a planted fault, may stand in for the kernel through it
(``Model``'s ``route``).

A call's capacity is ``C = max(1, int(cf * k * Tg / E))``, at most
``Tg * k``, (token, pick) pairs an expert in each group of ``Tg``
tokens (``_pick_groups``; ``capacity``, ``drops_nothing``).  Two
paths compute the routed experts:

- Padded, where ``C < Tg``: an expert can be sent more pairs than it
  keeps.  Each group dispatches its own tokens into a per-group [E, C,
  D] buffer via a stable sort and a scatter, the experts run as batched
  products over that buffer, and capacity overflow drops (token,
  expert) pairs (the residual keeps the token).  What the port keeps
  exactly, because it decides which pairs are dropped: the stable sort
  by expert, the position of a pair in its expert's run (a cummax of
  run starts), and that a slot's routing competes with every other
  token of its group, padding slots of a decode batch included.
- Dropless, where ``C >= Tg``: an expert gets at most one pair a token,
  so no pair can be dropped, as the published models route.  The
  call's T * k pairs are sorted by expert (stable), each expert's end
  offset in that order is found on the device (``searchsorted``), the
  rows are gathered in sorted order, and the gate, up and down
  products run as grouped matrix products (``torch._grouped_mm``) over
  exactly those T * k rows, each expert's matrices over its own run:
  no [G, E, C, D] buffer, no capacity slack.  Shapes are static and
  nothing is read back to the host, so the serving engine's captured
  decode step replays it, and a token's output depends on its own
  routes alone, not on its batchmates.  Taken where the grouped product
  runs on the device without a host sync: bfloat16, or any float on the
  CPU; a float32 model on CUDA takes the padded path, which at
  ``C >= Tg`` drops nothing either.

Both combine alike: each (token, pick) pair's output back in (token,
pick) order through the inverse of the sort, weighted and summed over
the picks in pick order in the model dtype, with no atomics.

Device spans (``repro_torch.obs.trace``, into the tracer the serving
engine armed): ``moe.route`` (router logits and ``moe_router``),
``moe.dispatch`` (the sort, then run positions and the scatter into
[G, E, C, D], or the offsets and the gather in sorted order),
``moe.experts`` (the three products; arguments ``rows``, the rows they
run over: G * E * C padded, T * k dropless; ``E``, ``D``, ``F``),
``moe.combine`` (inverse-sort gather and weighted sum) and
``moe.shared`` (the shared experts).  Counters, one reading a call:
``moe_calls``, and ``moe_dropless_calls`` on the dropless path.

Not ported: ``_ep_axis`` and ``_moe_expert_compute_ep``, expert
parallelism over a device mesh; with one card there is no mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_router import moe_router
from repro_torch.models import layers as L
from repro_torch.obs import trace as _trace


def moe_init(generator, cfg, dtype):
    E = cfg.num_experts
    Fd = cfg.moe_d_ff or cfg.d_ff
    D = cfg.d_model

    def stack(a, b):
        return L._normal(generator, (E, a, b), a ** -0.5, dtype)

    p = {
        "router": {"kernel": L._normal(generator, (D, E), D ** -0.5,
                                       torch.float32)},
        "experts": {
            "w_gate": stack(D, Fd),
            "w_up": stack(D, Fd),
            "w_down": stack(Fd, D),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_init(generator, D, cfg.num_shared_experts * Fd,
                                 "swiglu", dtype)
    return p


def _pick_groups(total_tokens: int, batch: int) -> int:
    """Groups must divide total tokens; prefer ~>=256 tokens per group so
    capacity quantization stays small."""
    if total_tokens <= 256:
        return 1
    g = batch
    while g > 1 and total_tokens // g < 256:
        g //= 2
    return max(g, 1)


def capacity(cfg, T, B):
    """(G, C) of a call over B rows of T tokens in all: the groups the
    tokens split into and each expert's capacity in a group."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G = _pick_groups(T, B)
    Tg = T // G
    C = max(1, int(cfg.expert_capacity_factor * k * Tg / E))
    return G, min(C, Tg * k)


def drops_nothing(cfg, T, B=1):
    """Whether a call over B rows of T tokens in all can drop no (token,
    pick) pair: C >= Tg, where the dropless path may run."""
    G, C = capacity(cfg, T, B)
    return C >= T // G


def _dispatch(xg, top_idx, E, C):
    """xg: [G, T, D]; top_idx: [G, T, k] int64.

    Returns (buf [G, E, C, D], dest [G, T*k], keep, src, order), the
    pairs in expert-sorted order: ``order`` the stable sort of the
    flattened (token, pick) pairs by expert, ``src`` each sorted pair's
    token, ``keep`` whether it fits its expert's capacity and ``dest``
    its row of the flattened buffer (``E * C``, one row past the
    buffer, for a dropped pair).  Kept pairs have distinct rows, so the
    buffer is written, not summed into; dropped pairs are written to the
    extra row, which is cut off."""
    G, T, D = xg.shape
    k = top_idx.shape[-1]
    flat_e = top_idx.reshape(G, T * k)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    idx = torch.arange(T * k, device=xg.device).expand(G, T * k)
    starts = torch.ones_like(sorted_e, dtype=torch.bool)
    starts[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(starts, idx, 0), dim=1).values
    pos = idx - run_start
    keep = pos < C
    dest = torch.where(keep, sorted_e * C + pos, E * C)
    src = order // k
    g_idx = torch.arange(G, device=xg.device)[:, None]
    buf = xg.new_zeros((G, E * C + 1, D))
    buf[g_idx, dest] = xg[g_idx, src]
    return buf[:, :-1].reshape(G, E, C, D), dest, keep, src, order


def _sorted_pairs(top_idx, E):
    """top_idx: [T, k] int64.  Returns (order [T*k], offs [E] int32): the
    stable sort of the flattened (token, pick) pairs by expert, and each
    expert's end offset in that order (the pairs routed to experts up to
    it), found on the device."""
    sorted_e, order = torch.sort(top_idx.reshape(-1), stable=True)
    experts = torch.arange(E, device=top_idx.device, dtype=sorted_e.dtype)
    offs = torch.searchsorted(sorted_e, experts, right=True, out_int32=True)
    return order, offs


def _grouped_ok(x):
    """Whether ``torch._grouped_mm`` runs on ``x`` without a host sync
    (module doc)."""
    return x.device.type == "cpu" or x.dtype == torch.bfloat16


def _aux_loss(logits, top_idx, cfg):
    """The Switch-style load-balance loss of the reference
    (``moe.py:198-202``) from the router's indices."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(0)                                        # [E]
    ce = F.one_hot(top_idx, E).sum(1).float().mean(0)          # frac routed
    return cfg.router_aux_weight * E * torch.sum(me * ce) / k


def _weighted_sum(slot, w):
    """slot [..., k, D], w [..., k]: the sum over the picks of each
    pick's output times its weight, in pick order."""
    y = slot[..., 0, :] * w[..., 0, None]
    for j in range(1, w.shape[-1]):
        y = y + slot[..., j, :] * w[..., j, None]
    return y


def _padded(xf, top_w, top_idx, ex, G, C, tr):
    """The routed experts over the capacity buffer: [T, D]."""
    T, D = xf.shape
    E, _, Fd = ex["w_gate"].shape
    k = top_idx.shape[-1]
    Tg = T // G
    with tr.span("moe.dispatch", cat="model", device=True):
        xg = xf.reshape(G, Tg, D)
        buf, dest, _, _, order = _dispatch(xg, top_idx.reshape(G, Tg, k),
                                           E, C)
    with tr.span("moe.experts", cat="model", device=True, rows=G * E * C,
                 E=E, D=D, F=Fd):
        h = torch.einsum("gecd,edf->gecf", buf, ex["w_gate"])
        u = torch.einsum("gecd,edf->gecf", buf, ex["w_up"])
        out = torch.einsum("gecf,efd->gecd", F.silu(h) * u, ex["w_down"])
    # a dropped pair reads the zero row past the buffer
    with tr.span("moe.combine", cat="model", device=True):
        wg = top_w.reshape(G, Tg, k).to(xf.dtype)
        out_flat = torch.cat([out.reshape(G, E * C, D),
                              out.new_zeros((G, 1, D))], dim=1)
        dest_tk = torch.empty_like(dest).scatter_(1, order, dest)
        g_idx = torch.arange(G, device=xf.device)[:, None]
        slot = out_flat[g_idx, dest_tk].reshape(G, Tg, k, D)
        return _weighted_sum(slot, wg).reshape(T, D)


def _dropless(xf, top_w, top_idx, ex, tr):
    """The routed experts over the T * k pairs sorted by expert: [T, D]."""
    T, D = xf.shape
    E, _, Fd = ex["w_gate"].shape
    k = top_idx.shape[-1]
    with tr.span("moe.dispatch", cat="model", device=True):
        order, offs = _sorted_pairs(top_idx, E)
        rows = xf.index_select(0, order // k)                  # [T*k, D]
    with tr.span("moe.experts", cat="model", device=True, rows=T * k, E=E,
                 D=D, F=Fd):
        h = torch._grouped_mm(rows, ex["w_gate"], offs=offs)
        u = torch._grouped_mm(rows, ex["w_up"], offs=offs)
        out = torch._grouped_mm(F.silu(h) * u, ex["w_down"], offs=offs)
    with tr.span("moe.combine", cat="model", device=True):
        pair = torch.arange(T * k, device=xf.device)
        inv = torch.empty_like(order).scatter_(0, order, pair)
        slot = out.index_select(0, inv).reshape(T, k, D)
        return _weighted_sum(slot, top_w.to(xf.dtype))


def moe_apply(params, x, cfg, route=None, with_aux=False):
    """x: [B, S, D] -> (y [B, S, D], aux).  ``aux`` is the load-balance
    loss when ``with_aux`` (the reference returns it from
    ``block_apply``), else None."""
    B, S, D = x.shape
    E = cfg.num_experts
    k = cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, D)
    tr = _trace.current()

    with tr.span("moe.route", cat="model", device=True):
        logits = xf.float() @ params["router"]["kernel"]        # [T, E]
        top_w, top_idx, _ = (route or moe_router)(logits, k)
        top_idx = top_idx.long()
    aux = _aux_loss(logits, top_idx, cfg) if with_aux else None

    G, C = capacity(cfg, T, B)
    Tg = T // G

    tr.count("moe_calls")
    if C >= Tg and _grouped_ok(x):
        tr.count("moe_dropless_calls")
        y = _dropless(xf, top_w, top_idx, params["experts"], tr)
    else:
        y = _padded(xf, top_w, top_idx, params["experts"], G, C, tr)
    y = y.reshape(B, S, D)

    if "shared" in params:
        with tr.span("moe.shared", cat="model", device=True):
            y = y + L.mlp_apply(params["shared"], x, "swiglu")
    return y, aux
