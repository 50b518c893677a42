"""Adam/AdamW/SGD with the JAX package's (init, update) interface: the
port of ``repro.optim.optimizers``, written out op for op so that one
step on the same parameters and gradients rounds as the reference does
(``torch.optim.Adam`` fuses its arithmetic differently).

The update is elementwise, so it runs on any tree; the global-norm clip
is not, and the caller chooses it with ``per_client``.  The
federation's leaves carry a leading client axis, over which the
reference ``vmap``s ``update``, making the clip per client:
``per_client=True`` (the default) clips with ``clip_by_global_norm``,
which reduces over every axis but the first.  The LM's training step
(``launch/train.py``) clips the whole tree, as the reference's
``adam(max_grad_norm=1.0)`` does: ``per_client=False``, with
``clip_by_global_norm_tree``.  Nothing infers the choice from shapes.
Moments are float32.  ``update`` writes the new values into the
parameter tensors in place (they are the model's parameters on the hot
path, so no second copy is allocated) and returns the same tree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params, step: int) -> (params, state, info)
    update: Callable
    # whether the clip is per client (a leading axis) or over the tree
    per_client: bool = True


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _per_client(v, leaf):
    """[n] -> broadcastable against a [n, ...] leaf."""
    return v.reshape((-1,) + (1,) * (leaf.dim() - 1))


def clip_by_global_norm(grads, max_norm):
    """Scale each client's gradients so their global L2 norm is at most
    ``max_norm``.  Returns (clipped, norms [n_clients])."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()),
                                  dim=tuple(range(1, g.dim())))
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * _per_client(scale, g)
                               ).to(g.dtype), grads), gn


def clip_by_global_norm_tree(grads, max_norm):
    """Scale the whole tree's gradients so their global L2 norm is at
    most ``max_norm``: the reference's ``clip_by_global_norm``.
    Returns (clipped, norm []), the squares summed leaf by leaf in
    leaf order."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _f32(v):
    return float(np.float32(v))


@torch.no_grad()
def _assign(params, new):
    for p, v in zip(tree_leaves(params), tree_leaves(new)):
        p.copy_(v)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
         max_grad_norm: Optional[float] = 1.0, per_client: bool = True):
    """lr: float or schedule fn step->float.  ``per_client``: the clip
    per client over a leading axis (``info["grad_norm"]`` [n]), or over
    the whole tree (a scalar; zero when nothing is clipped, as in the
    reference)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    clip = clip_by_global_norm if per_client else clip_by_global_norm_tree

    def init(params):
        return {"mu": _zeros_f32(params), "nu": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = None
        if max_grad_norm:
            grads, gn = clip(grads, max_grad_norm)
        elif not per_client:
            gn = torch.zeros((), device=tree_leaves(grads)[0].device)
        # bias corrections in float32 on the host, as the reference
        # computes them from its float32 step count
        t = np.float32(step + 1)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** t)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** t)
        lr_t = lr_fn(step)

        def upd(g, mu, nu, p):
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            mu_hat = mu / bc1
            nu_hat = nu / bc2
            step_v = mu_hat / (torch.sqrt(nu_hat) + eps)
            if weight_decay:
                step_v = step_v + weight_decay * p.float()
            new_p = p.float() - lr_t * step_v
            return new_p.to(p.dtype), mu, nu

        flat = tree_map(upd, grads, state["mu"], state["nu"], params)
        _assign(params, _pick(flat, 0))
        return params, {"mu": _pick(flat, 1), "nu": _pick(flat, 2)}, \
            {"grad_norm": gn}

    return Optimizer(init, update, per_client)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def adamw(lr, weight_decay=0.01, **kw):
    return adam(lr, weight_decay=weight_decay, **kw)


def sgd(lr, momentum=0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if momentum:
            return {"v": _zeros_f32(params)}
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        if momentum:
            new_v = tree_map(lambda v, g: momentum * v + g.float(),
                             state["v"], grads)
            _assign(params, tree_map(
                lambda p, v: (p.float() - lr_t * v).to(p.dtype),
                params, new_v))
            return params, {"v": new_v}, {}
        _assign(params, tree_map(
            lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype),
            params, grads))
        return params, {}, {}

    return Optimizer(init, update)
