"""State-space mixers: Mamba (S6 selective scan, for Jamba) and RWKV6
"Finch" (data-dependent decay linear attention).  The port of
``repro.models.ssm``.

The reference cuts the sequence into chunks and ``lax.scan``s over them
(``_chunk_count``, the chunked bodies) to bound XLA's activation memory.
Here each recurrence is one call into a hand-written kernel on CUDA and
into its plain version on the CPU (``repro_torch.kernels.rwkv6_scan``,
``repro_torch.kernels.mamba_scan``): the kernel takes any T and carries
the state itself, so the chunking is not ported.  ``wkv`` and ``sscan``
are those functions, with the kernels' signatures and the kernels by
default; the plain versions, or planted faults, may stand in for them
(``Model``'s ``wkv`` and ``sscan``).  The Mamba mixer calls the fused
scan, ``mamba_scan_fused(dt, x, B, C, A, h0)``, which forms the
discretised a = exp(dt A) and bx = (dt x) B itself: the [B, T, d_in, N]
float32 tensors ``_discretise`` describes are not materialised on this
path.

Decode carries explicit recurrent state (the SSM analogue of a KV
cache) and writes it in place: the scans write their new state over the
cache's (``state_out`` / ``h_out``), and the token-shift rows and the
conv history are copied into the cache, where the reference returns new
arrays.  A Mamba decode step runs the scan kernel at T = 1, where the
reference's ``mamba_decode`` steps inline; the two compute the same.

Dtypes follow the reference's promotion: in a bfloat16 model the
projections stay bfloat16, while ``dt`` (a bf16 product plus the
float32 ``dt_bias``), the decays and ``bx`` are float32, as JAX
promotes them (the fused scan forms them in float32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan_fused
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models import layers as L


# ===========================================================================
# Mamba (S6)
# ===========================================================================
def mamba_init(generator, cfg, dtype):
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    N = cfg.ssm_state_dim
    dt_rank = max(1, D // 16)
    dev = generator.device
    return {"mamba": {
        "in_proj": L._normal(generator, (D, 2 * d_in), D ** -0.5, dtype),
        "conv": L._normal(generator, (cfg.ssm_conv_width, d_in), 0.1, dtype),
        "x_proj": L._normal(generator, (d_in, dt_rank + 2 * N),
                            d_in ** -0.5, dtype),
        "dt_proj": L._normal(generator, (dt_rank, d_in), dt_rank ** -0.5,
                             dtype),
        "dt_bias": torch.zeros((d_in,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=dev)).expand(
                d_in, N).contiguous(),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": L._normal(generator, (d_in, D), d_in ** -0.5, dtype),
    }}


def _scan_inputs(m, x_conv, dt_rank, N):
    """(dt, B, C, A) of the scan from the conv output: dt [..., d_in]
    (float32 in a bf16 model), B and C [..., N] (views of the x
    projection, in the model's dtype) and A = -exp(A_log) [d_in, N]."""
    proj = x_conv @ m["x_proj"]
    dt_raw, Bmat, Cmat = proj.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_raw @ m["dt_proj"] + m["dt_bias"])
    A = -torch.exp(m["A_log"])                        # [d_in, N]
    return dt, Bmat, Cmat, A


def _discretise(m, x_conv, dt_rank, N):
    """(dt-scaled decay a, input bx, C) of the scan from the conv output:
    a = exp(dt A) and bx = dt x B over [..., d_in, N] in float32, the
    unfused scan's inputs.  The fused scan forms the same a and bx
    itself (``mamba_scan_fused_ref`` states these expressions)."""
    dt, Bmat, Cmat, A = _scan_inputs(m, x_conv, dt_rank, N)
    a = torch.exp(dt[..., None] * A)
    bx = (dt * x_conv)[..., None] * Bmat[..., None, :].to(dt.dtype)
    return a.float(), bx.float(), Cmat.float()


def mamba_apply(params, x, cfg, *, return_state=False, init_state=None,
                sscan=None):
    """x: [B, S, D]. Full-sequence (prefill) path; the scan starts from
    ``init_state`` (zeros when None)."""
    m = params["mamba"]
    B, S, D = x.shape
    N = cfg.ssm_state_dim
    dt_rank = max(1, D // 16)

    xz = x @ m["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)
    # causal depthwise conv
    w = m["conv"]                                     # [K, d_in]
    K = w.shape[0]
    xp = F.pad(x_in, (0, 0, K - 1, 0))
    x_conv = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    x_conv = F.silu(x_conv)

    dt, Bmat, Cmat, A = _scan_inputs(m, x_conv, dt_rank, N)
    y, h_final = (sscan or mamba_scan_fused)(dt, x_conv, Bmat, Cmat, A,
                                             init_state)
    y = y.to(x.dtype)
    y = y + m["D"].to(x.dtype) * x_conv
    out = (y * F.silu(z)) @ m["out_proj"]
    if return_state:
        return out, {"h": h_final, "conv": xp[:, S:, :].clone()}
    return out


def mamba_init_state(cfg, batch, dtype, device=None):
    d_in = cfg.ssm_expand * cfg.d_model
    return {
        "h": torch.zeros((batch, d_in, cfg.ssm_state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in),
                            dtype=dtype, device=device),
    }


def mamba_decode(params, x, state, cfg, sscan=None):
    """x: [B, 1, D]; state: {'h': [B,d_in,N], 'conv': [B,K-1,d_in]},
    both written in place.  Returns (out, state)."""
    m = params["mamba"]
    N = cfg.ssm_state_dim
    dt_rank = max(1, cfg.d_model // 16)

    xz = x[:, 0] @ m["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)
    hist = torch.cat([state["conv"], x_in[:, None, :]], dim=1)  # [B,K,d]
    x_conv = F.silu(torch.einsum("bkd,kd->bd", hist, m["conv"]))
    dt, Bmat, Cmat, A = _scan_inputs(m, x_conv, dt_rank, N)
    y, _ = (sscan or mamba_scan_fused)(
        dt[:, None], x_conv[:, None], Bmat[:, None], Cmat[:, None], A,
        state["h"], h_out=state["h"])
    y = y[:, 0].to(x.dtype)
    y = y + m["D"].to(x.dtype) * x_conv
    out = ((y * F.silu(z)) @ m["out_proj"])[:, None, :]
    state["conv"].copy_(hist[:, 1:, :])
    return out, state


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================
def rwkv_init(generator, cfg, dtype):
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = D // hd
    lora = 64
    dev = generator.device

    def mat(a, b, sc=None):
        return L._normal(generator, (a, b), sc or a ** -0.5, dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {"rwkv": {
        "wr": {"kernel": mat(D, D)},
        "wk": {"kernel": mat(D, D)},
        "wv": {"kernel": mat(D, D)},
        "wg": {"kernel": mat(D, D)},
        "wo": {"kernel": mat(D, D)},
        # data-dependent decay (the Finch novelty): w = f(x) via LoRA
        "decay_lora_a": mat(D, lora),
        "decay_lora_b": mat(lora, D, 0.01),
        "decay_base": full((D,), -4.0),
        "bonus": full((H, hd), 0.5),
        # token-shift lerp coefficients for r,k,v,g,w
        "mu": full((5, D), 0.5),
        "ln_out": L.norm_init(D, "layernorm", dev),
        # channel mix
        "mu_cm": full((2, D), 0.5),
        "cm_wk": {"kernel": mat(D, cfg.d_ff)},
        "cm_wv": {"kernel": mat(cfg.d_ff, D)},
        "cm_wr": {"kernel": mat(D, D)},
    }}


def _shifted(x, x_prev):
    """x shifted one token right, ``x_prev`` (zeros when None) first."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_time_mix(params, x, cfg, *, x_prev=None, state=None,
                  state_out=None, return_state=False, wkv=None):
    """x: [B,S,D]. x_prev: [B,D] last token of the previous segment
    (decode).  state: [B,H,hd,hd] WKV state (zeros when None); with
    ``state_out`` the final state is written there (decode passes the
    cache's state for both)."""
    p = params["rwkv"]
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd

    shifted = _shifted(x, x_prev)
    mu = p["mu"].to(x.dtype)
    lerp = [x + (shifted - x) * mu[i] for i in range(5)]  # r,k,v,g,w

    r = (lerp[0] @ p["wr"]["kernel"]).reshape(B, S, H, hd)
    k = (lerp[1] @ p["wk"]["kernel"]).reshape(B, S, H, hd)
    v = (lerp[2] @ p["wv"]["kernel"]).reshape(B, S, H, hd)
    g = F.silu(lerp[3] @ p["wg"]["kernel"])
    # data-dependent decay in (0,1): exp(-exp(.)), in float32
    dd = torch.tanh(lerp[4].float() @ p["decay_lora_a"].float()) @ \
        p["decay_lora_b"].float()
    w = torch.exp(-torch.exp(p["decay_base"] + dd)).reshape(B, S, H, hd)

    o, S_fin = (wkv or rwkv6_scan)(r.float(), k.float(), v.float(), w,
                                   p["bonus"], state, state_out=state_out)
    o = o.reshape(B, S, D).to(x.dtype)

    # per-head groupnorm
    of = o.reshape(B, S, H, hd).float()
    of = (of - of.mean(-1, keepdim=True)) * torch.rsqrt(
        of.var(-1, keepdim=True, unbiased=False) + 1e-5)
    o = L.apply_norm(p["ln_out"], of.reshape(B, S, D).to(x.dtype),
                     "layernorm")
    out = (o * g) @ p["wo"]["kernel"]
    if return_state:
        return out, {"wkv": S_fin, "x_prev_tm": x[:, -1, :].clone()}
    return out


def rwkv_channel_mix(params, x, cfg, *, x_prev=None, return_state=False):
    p = params["rwkv"]
    shifted = _shifted(x, x_prev)
    mu = p["mu_cm"].to(x.dtype)
    xk = x + (shifted - x) * mu[0]
    xr = x + (shifted - x) * mu[1]
    kk = torch.square(F.relu(xk @ p["cm_wk"]["kernel"]))
    vv = kk @ p["cm_wv"]["kernel"]
    rr = torch.sigmoid(xr @ p["cm_wr"]["kernel"])
    out = rr * vv
    if return_state:
        return out, x[:, -1, :]
    return out


def rwkv_init_state(cfg, batch, dtype, device=None):
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = D // hd
    return {
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "x_prev_tm": torch.zeros((batch, D), dtype=dtype, device=device),
        "x_prev_cm": torch.zeros((batch, D), dtype=dtype, device=device),
    }
