"""Primitive layers as functions over dict params: the port of
``repro.models.layers``.

The paper's MLP federation uses ``dense_init`` and ``dense`` over
stacked per-client parameters: a leaf may carry a leading client axis
(``kernel`` [..., in, out], ``bias`` [..., out]), and ``dense`` batches
the matmul over the leading axes, which is the JAX package's vmap over
clients written out.

The LM zoo (``models/attention.py``, ``models/transformer.py``) uses
the rest.  Init functions take an explicit ``torch.Generator`` and draw
on its device, so a model initialises on the card; norms and rotary
embeddings compute in float32 and cast back, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device: an init
    given one builds the whole tree, shapes and dtypes only, without
    drawing a number or allocating memory (``Model.init_meta``)."""
    device = torch.device("meta")


def _normal(generator, shape, scale, dtype):
    """``normal * scale`` drawn in float32 on the generator's device,
    then cast: the reference's ``jax.random.normal(...) * scale``.  A
    ``MetaGenerator`` gives an empty meta tensor."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return x.to(dtype)


def dense_init(generator, in_dim, out_dim, bias=False, scale=None, *,
               dtype=torch.float32):
    """A dense layer: ``normal * scale`` (default ``in_dim ** -0.5``)
    with a zero bias, in ``dtype``, drawn on the generator's device (the
    MLP federation draws on the CPU, so the draw is the same whatever
    device the layer later lives on)."""
    scale = scale if scale is not None else in_dim ** -0.5
    p = {"kernel": _normal(generator, (in_dim, out_dim), scale, dtype)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype,
                                device=generator.device)
    return p


def dense(params, x):
    """x [..., B, in] @ kernel [..., in, out] + bias [..., out]."""
    y = torch.matmul(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"].unsqueeze(-2)
    return y


def embedding_init(generator, vocab, dim, dtype):
    return {"table": _normal(generator, (vocab, dim), dim ** -0.5, dtype)}


def embed(params, ids):
    return params["table"][ids]


def norm_init(dim, kind="rmsnorm", device=None):
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(params, x, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"]
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: [..., S, H, hd]; positions: [..., S] int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    angles = positions[..., :, None].float() * freqs          # [...,S,hd/2]
    cos = torch.cos(angles)[..., :, None, :]                  # [...,S,1,hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------
def mlp_init(generator, d_model, d_ff, act, dtype, prefix_bias=False):
    if act == "swiglu":
        return {
            "w_gate": dense_init(generator, d_model, d_ff, dtype=dtype),
            "w_up": dense_init(generator, d_model, d_ff, dtype=dtype),
            "w_down": dense_init(generator, d_ff, d_model, dtype=dtype),
        }
    return {
        "wi": dense_init(generator, d_model, d_ff, bias=prefix_bias,
                         dtype=dtype),
        "w_down": dense_init(generator, d_ff, d_model, bias=prefix_bias,
                             dtype=dtype),
    }


def mlp_apply(params, x, act):
    if act == "swiglu":
        h = F.silu(dense(params["w_gate"], x)) * dense(params["w_up"], x)
    elif act == "gelu":
        h = F.gelu(dense(params["wi"], x), approximate="tanh")
    else:
        h = F.relu(dense(params["wi"], x))
    return dense(params["w_down"], h)
