"""Dense layers over stacked per-client parameters: the port of
``dense_init`` and ``dense`` from ``repro.models.layers``.

A parameter leaf may carry a leading client axis: ``kernel`` is
[..., in, out] and ``bias`` [..., out], and ``dense`` batches the
matmul over the leading axes, which is the JAX package's vmap over
clients written out.
"""
from __future__ import annotations

import torch


def dense_init(generator, in_dim, out_dim, bias=False, scale=None):
    """One client's dense layer: ``normal * scale`` (default
    ``in_dim ** -0.5``) with a zero bias, drawn on the CPU from
    ``generator`` so the draw is the same whatever device the layer
    later lives on."""
    scale = scale if scale is not None else in_dim ** -0.5
    k = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32) * scale
    p = {"kernel": k}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=torch.float32)
    return p


def dense(params, x):
    """x [..., B, in] @ kernel [..., in, out] + bias [..., out]."""
    y = torch.matmul(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"].unsqueeze(-2)
    return y
