"""Mixture-of-Experts with group-local capacity dispatch: the port of
``repro.models.moe`` on one device.

Tokens are reshaped into G groups; each group dispatches its own tokens
into a per-group [E, C, D] buffer via a stable sort and a scatter, the
experts run as batched products over that buffer, and capacity
overflow drops (token, expert) pairs (the residual keeps the token).
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

What the port keeps exactly, because it decides which pairs are
dropped: the capacity ``C = max(1, int(cf * k * Tg / E))``, the stable
sort by expert, the position of a pair in its expert's run (a cummax of
run starts), and that a slot's routing competes with every other token
of its group, padding slots of a decode batch included.

Device spans (``repro_torch.obs.trace``, into the tracer the serving
engine armed): ``moe.route`` (router logits and ``moe_router``),
``moe.dispatch`` (sort, run positions, scatter into [G, E, C, D]),
``moe.experts`` (the three products), ``moe.combine`` (inverse-sort
gather and weighted sum) and ``moe.shared`` (the shared experts).

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


def _aux_loss(logits, top_idx, cfg):
    """The Switch-style load-balance loss of the reference
    (``moe.py:198-202``) from the router's indices."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(0)                                        # [E]
    ce = F.one_hot(top_idx, E).sum(1).float().mean(0)          # frac routed
    return cfg.router_aux_weight * E * torch.sum(me * ce) / k


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

    G = _pick_groups(T, B)
    Tg = T // G
    C = max(1, int(cfg.expert_capacity_factor * k * Tg / E))
    C = min(C, Tg * k)

    with tr.span("moe.dispatch", cat="model", device=True):
        xg = xf.reshape(G, Tg, D)
        buf, dest, _, _, order = _dispatch(xg, top_idx.reshape(G, Tg, k),
                                           E, C)
    ex = params["experts"]
    with tr.span("moe.experts", cat="model", device=True):
        h = torch.einsum("gecd,edf->gecf", buf, ex["w_gate"])
        u = torch.einsum("gecd,edf->gecf", buf, ex["w_up"])
        out = torch.einsum("gecf,efd->gecd", F.silu(h) * u, ex["w_down"])
    # combine: each (token, pick) pair's slot output, back in (token,
    # pick) order through the inverse of the sort (a dropped pair reads
    # the zero row), weighted and summed over the picks in pick order
    # in the model dtype, with no atomics
    with tr.span("moe.combine", cat="model", device=True):
        wg = top_w.reshape(G, Tg, k).to(x.dtype)
        out_flat = torch.cat([out.reshape(G, E * C, D),
                              out.new_zeros((G, 1, D))], dim=1)
        dest_tk = torch.empty_like(dest).scatter_(1, order, dest)
        g_idx = torch.arange(G, device=x.device)[:, None]
        slot = out_flat[g_idx, dest_tk].reshape(G, Tg, k, D)
        y = slot[:, :, 0] * wg[:, :, 0, None]
        for j in range(1, k):
            y = y + slot[:, :, j] * wg[:, :, j, None]
        y = y.reshape(B, S, D)

    if "shared" in params:
        with tr.span("moe.shared", cat="model", device=True):
            y = y + L.mlp_apply(params["shared"], x, "swiglu")
    return y, aux
