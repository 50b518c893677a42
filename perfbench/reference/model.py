"""The plain reference of the served decoder-only LMs: float32 PyTorch,
no kernel, no cache manager, no batching engine.

It covers the two families the benchmark serves: DeepSeekMoE
(arXiv:2401.06066: RMSNorm, RoPE attention, a dense first FFN, then
MoE layers of fine-grained routed experts plus shared experts) and
Jamba (arXiv:2403.19887: Mamba layers with one attention layer a period
of eight, MoE on every other layer).  The input block is the plain
full-width lookup of the token table, which the De-VertiFL exchange
(paper Algorithm 2's zero-padded sum over the clients' column slices)
equals exactly.

It reads the weights the benchmark drew, in their tree (the layout of
a checkpoint: ``vfl_embedding``, ``stack`` with ``layer_i`` prefix
layers and ``scanned``/``sub_j`` groups stacked on a leading axis,
``final_norm``, ``lm_head``), and works everything else out itself:
routes, capacity drops, attention, the recurrent state.  Each weight
matrix is cast to float32 where it is used, one layer (one expert) at
a time, so that the reference fits on the card beside the bfloat16
weights.  With ``Precision("fp8")`` every matrix product takes its
weights and its activations rounded to float8 e4m3 (a scale per output
column and per row): the control that must fail the comparison.

Departures from the published descriptions, all shared with the
system under test (the reference follows the served model, not the
paper, where the two differ):

- Jamba's attention layers apply RoPE (``rope_theta`` 10,000) to the
  queries and keys; the published Jamba uses no explicit positional
  encoding in them.
- Jamba's Mamba layers have no bias on the depthwise convolution and no
  RMSNorm on dt, B and C (the published checkpoint has both).
- Capacity: each MoE layer keeps at most ``C = max(1, int(cf * k * Tg /
  E))`` (at most ``Tg * k``) (token, pick) pairs an expert in a group of
  ``Tg`` tokens, pairs taken in token order (GShard-style dropping);
  the published models route without dropping.  Groups: the whole call
  up to 256 tokens, else the batch halved until a group holds 256 or
  more (one group at batch 1).
- Router: softmax over the experts, top-k, the k weights renormalised to
  sum to one (DeepSeekMoE does not renormalise).
- The dense first layer of DeepSeekMoE has width 10,944; the shared
  experts are one SwiGLU FFN of width ``n_shared * moe_d_ff``.
- Weights are random (the benchmark's seed), so nothing here depends on
  a released checkpoint.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
NORM_EPS = 1e-6
ATTN_ROWS = 512          # query rows a block in a prefill's attention
SCAN_CHUNK = 16          # steps a block of the Mamba scan


class Precision:
    """``"f32"``: the reference; ``"fp8"``: the control."""

    def __init__(self, name="f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def weight(self, w):
        """[..., in, out] weights in float32 (fp8: a scale a column)."""
        w = w.float()
        return _fp8(w, -2) if self.name == "fp8" else w

    def act(self, x):
        return _fp8(x, -1) if self.name == "fp8" else x

    def mm(self, x, w):
        return self.act(x) @ self.weight(w)


def _fp8(x, dim):
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


# ---------------------------------------------------------------------------
# the layer plan and the weight tree's layout
# ---------------------------------------------------------------------------
def layer_kinds(cfg):
    """(mixer, ffn) of every layer, from the configuration."""
    kinds = []
    for l in range(cfg["num_layers"]):
        period = cfg.get("attn_layer_period", 0)
        if cfg.get("ssm_type") == "mamba" and (
                period == 0 or l % period != cfg.get("attn_layer_offset", 0)):
            mixer = "mamba"
        else:
            mixer = "attn"
        if l == 0 and cfg.get("first_layer_dense_ff"):
            ffn = "dense0"
        elif cfg.get("num_experts") and \
                l % cfg.get("moe_every", 1) == cfg.get("moe_offset", 0):
            ffn = "moe"
        else:
            ffn = "dense"
        kinds.append((mixer, ffn))
    return kinds


def stack_layout(kinds):
    """(prefix, period) of the weight tree: an irregular prefix of up to
    two layers, then groups of ``period`` layers stacked on a leading
    axis (the tree's ``scanned`` part)."""
    for prefix in (0, 1, 2):
        rest = kinds[prefix:]
        if not rest:
            continue
        for period in range(1, min(16, len(rest)) + 1):
            if len(rest) % period == 0 and all(
                    rest[i] == rest[i % period] for i in range(len(rest))):
                return prefix, period
    return len(kinds), 1


def layer_tree(stack, kinds, l):
    """Layer ``l``'s subtree of a stacked tree (weights or a cache)."""
    prefix, period = stack_layout(kinds)
    if l < prefix:
        return stack[f"layer_{l}"]
    g, j = divmod(l - prefix, period)
    sub = stack["scanned"][f"sub_{j}"]
    return _index(sub, g)


def _index(tree, g):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def rmsnorm(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + NORM_EPS) * \
        scale.float()


def rope(x, pos, theta):
    """x [..., H, hd] float32, pos [...] (one position per row)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos.float()[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x, p, prec):
    h = F.silu(prec.mm(x, p["w_gate"]["kernel"])) * \
        prec.mm(x, p["w_up"]["kernel"])
    return prec.mm(h, p["w_down"]["kernel"])


def _qkv(x, p, pos, cfg, prec):
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = prec.mm(x, p["wq"]["kernel"]).unflatten(-1, (H, hd))
    k = prec.mm(x, p["wk"]["kernel"]).unflatten(-1, (KV, hd))
    v = prec.mm(x, p["wv"]["kernel"]).unflatten(-1, (KV, hd))
    theta = cfg.get("rope_theta", 10000.0)
    return rope(q, pos, theta), rope(k, pos, theta), v


def attention_prefill(x, p, cfg, prec):
    """Causal self-attention over x [S, D]: (out [S, D], k, v [S, KV,
    hd] after RoPE)."""
    S = x.shape[0]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(x, p, pos, cfg, prec)
    rep = H // KV
    kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)     # [H, S, hd]
    vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty((S, H, hd), device=x.device)
    for a in range(0, S, ATTN_ROWS):
        b = min(S, a + ATTN_ROWS)
        qh = q[a:b].transpose(0, 1)                          # [H, r, hd]
        s = (prec.act(qh) @ prec.act(kh[:, :b]).transpose(1, 2)) * hd ** -0.5
        mask = torch.arange(b, device=x.device)[None, :] > \
            torch.arange(a, b, device=x.device)[:, None]
        s.masked_fill_(mask, float("-inf"))
        pr = torch.softmax(s, dim=-1)
        out[a:b] = (prec.act(pr) @ prec.act(vh[:, :b])).transpose(0, 1)
    return prec.mm(out.reshape(S, H * hd), p["wo"]["kernel"]), k, v


def attention_decode(x, p, cfg, pos, k_cache, v_cache, prec):
    """One new token a row: x [B, D] at positions pos [B], over the keys
    and values of positions 0 .. pos - 1 in ``k_cache``/``v_cache`` [B,
    S, KV, hd] (read, not written) and its own.  Returns (out [B, D], k,
    v [B, KV, hd])."""
    B = x.shape[0]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q, k, v = _qkv(x, p, pos, cfg, prec)
    S = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    kc = k_cache.to(torch.float32, copy=True)
    vc = v_cache.to(torch.float32, copy=True)
    kc[rows, pos] = k
    vc[rows, pos] = v
    rep = H // KV
    qg = q.unflatten(1, (KV, rep))                            # [B, KV, r, hd]
    s = torch.einsum("bgrd,bsgd->bgrs", prec.act(qg), prec.act(kc)) * \
        hd ** -0.5
    mask = torch.arange(S, device=x.device)[None, :] > pos[:, None]
    s.masked_fill_(mask[:, None, None, :], float("-inf"))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", prec.act(pr), prec.act(vc))
    return prec.mm(o.reshape(B, H * hd), p["wo"]["kernel"]), k, v


def pick_groups(T, batch):
    if T <= 256:
        return 1
    g = batch
    while g > 1 and T // g < 256:
        g //= 2
    return max(g, 1)


def moe(x, p, cfg, prec, batch, log=None):
    """Top-k MoE over x [T, D] with group-local capacity: y [T, D].
    ``log``, a list, gets the router logits."""
    T, D = x.shape
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    logits = prec.mm(x, p["router"]["kernel"])                  # [T, E]
    if log is not None:
        log.append(logits)
    probs = torch.softmax(logits, dim=-1)
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_i = order[:, :k]
    top_w = probs.gather(1, top_i)
    top_w = top_w / top_w.sum(-1, keepdim=True)

    G = pick_groups(T, batch)
    Tg = T // G
    C = min(max(1, int(cfg.get("expert_capacity_factor", 1.25) * k * Tg / E)),
            Tg * k)
    # a (token, pick) pair is kept while its expert, in its group, has
    # taken fewer than C pairs of earlier tokens or earlier picks
    flat_e = top_i.reshape(G, Tg * k)
    sorted_e, sort_idx = torch.sort(flat_e, dim=1, stable=True)
    idx = torch.arange(Tg * k, device=x.device).expand(G, -1)
    starts = torch.ones_like(sorted_e, dtype=torch.bool)
    starts[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(starts, idx, 0), dim=1).values
    keep_sorted = (idx - run_start) < C
    keep = torch.empty_like(keep_sorted).scatter_(1, sort_idx, keep_sorted)
    keep = keep.reshape(T, k)

    y = torch.zeros((T, D), device=x.device)
    ex = p["experts"]
    for e in range(E):
        tok, pick = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(prec.mm(xe, ex["w_gate"][e])) * prec.mm(xe, ex["w_up"][e])
        out = prec.mm(h, ex["w_down"][e])
        y.index_add_(0, tok, out * top_w[tok, pick][:, None])
    if "shared" in p:
        y = y + swiglu(x, p["shared"], prec)
    return y


def _conv(hist, w):
    """Causal depthwise convolution: hist [..., K, d] (oldest first) by
    w [K, d]."""
    return (hist * w.float()).sum(-2)


def _ssm_inputs(xc, m, cfg, prec):
    N = cfg["ssm_state_dim"]
    dt_rank = max(1, cfg["d_model"] // 16)
    proj = prec.mm(xc, m["x_proj"])
    dt_raw, Bm, Cm = proj.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(prec.mm(dt_raw, m["dt_proj"]) + m["dt_bias"].float())
    A = -torch.exp(m["A_log"].float())
    return dt, Bm, Cm, A


def mamba_prefill(x, p, cfg, prec):
    """The Mamba mixer over x [S, D] from a zero state: (out [S, D],
    final state h [d_in, N], the last K-1 pre-convolution inputs)."""
    m = p["mamba"]
    S = x.shape[0]
    xz = prec.mm(x, m["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)
    K = m["conv"].shape[0]
    xp = F.pad(x_in, (0, 0, K - 1, 0))
    w = m["conv"].float()
    xc = F.silu(sum(xp[i:i + S] * w[i] for i in range(K)))
    dt, Bm, Cm, A = _ssm_inputs(xc, m, cfg, prec)
    y, h = selective_scan(dt, xc, Bm, Cm, A)
    y = y + m["D"].float() * xc
    return prec.mm(y * F.silu(z), m["out_proj"]), h, xp[S:]


def selective_scan(dt, x, Bm, Cm, A, h0=None):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = h_t C_t over [T,
    d] inputs, in blocks of ``SCAN_CHUNK`` steps: within a block h_t =
    exp(S_t) h_0 + sum_{s <= t} exp(S_t - S_s) dt_s x_s B_s with S_t the
    block's running sum of dt A (every exponent <= 0)."""
    T, d = x.shape
    N = A.shape[1]
    h = torch.zeros((d, N), device=x.device) if h0 is None else h0.float()
    y = torch.empty((T, d), device=x.device)
    for a in range(0, T, SCAN_CHUNK):
        b = min(T, a + SCAN_CHUNK)
        L = b - a
        cum = torch.cumsum(dt[a:b, :, None] * A, dim=0)           # [L, d, N]
        bx = (dt[a:b] * x[a:b])[:, :, None] * Bm[a:b, None, :].float()
        diff = cum[:, None] - cum[None, :]                        # [t, s, d, N]
        tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        w = torch.exp(diff.masked_fill(~tri[:, :, None, None], float("-inf")))
        hs = torch.exp(cum) * h + torch.einsum("tsdn,sdn->tdn", w, bx)
        y[a:b] = torch.einsum("tdn,tn->td", hs, Cm[a:b].float())
        h = hs[-1]
    return y, h


def mamba_decode(x, p, cfg, h, conv, prec):
    """One token a row: x [B, D], state h [B, d_in, N] and the last K-1
    pre-convolution inputs conv [B, K-1, d_in] (read, not written).
    Returns (out [B, D], new h, new conv)."""
    m = p["mamba"]
    xz = prec.mm(x, m["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)
    hist = torch.cat([conv.float(), x_in[:, None]], dim=1)
    xc = F.silu(_conv(hist, m["conv"]))
    dt, Bm, Cm, A = _ssm_inputs(xc, m, cfg, prec)
    h_new = torch.exp(dt[:, :, None] * A) * h.float() + \
        (dt * xc)[:, :, None] * Bm[:, None, :].float()
    y = torch.einsum("bdn,bn->bd", h_new, Cm.float()) + m["D"].float() * xc
    return prec.mm(y * F.silu(z), m["out_proj"]), h_new, hist[:, 1:]


def ffn(x, p, kind, cfg, prec, batch, log=None):
    if kind == "moe":
        return moe(x, p["moe"], cfg, prec, batch, log)
    return swiglu(x, p["ffn"], prec)


def _embed(params, ids, prec):
    table = params["vfl_embedding"]["table"]
    e = table[ids].float()
    return _fp8(e, -1) if prec.name == "fp8" else e


def _head(params, h, prec):
    h = rmsnorm(h, params["final_norm"]["scale"])
    return prec.mm(h, params["lm_head"]["kernel"])


# ---------------------------------------------------------------------------
# the two passes the comparison needs
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg, ids, prec=None, log=None):
    """A prompt ids [S] from nothing.  Returns {"logits": the last
    position's [V], "kv": {layer: (k, v) [S, KV, hd]}, "state": {layer:
    (h [d_in, N], the last K-1 pre-convolution inputs [K-1, d_in])} of
    every Mamba layer}.  ``log``, a list, gets each MoE layer's router
    logits."""
    prec = prec or Precision()
    kinds = layer_kinds(cfg)
    stack = params["stack"]
    x = _embed(params, ids, prec)
    kv, state = {}, {}
    for l, (mixer, kind) in enumerate(kinds):
        p = layer_tree(stack, kinds, l)
        h = rmsnorm(x, p["pre_norm"]["scale"])
        if mixer == "attn":
            y, k, v = attention_prefill(h, p["attn"], cfg, prec)
            kv[l] = (k, v)
        else:
            y, hs, conv = mamba_prefill(h, p, cfg, prec)
            state[l] = (hs, conv)
        x = x + y
        x = x + ffn(rmsnorm(x, p["ffn_norm"]["scale"]), p, kind, cfg, prec,
                    1, log)
    return {"logits": _head(params, x[-1:], prec)[0], "kv": kv,
            "state": state}


@torch.no_grad()
def decode(params, cfg, ids, pos, cache, prec=None):
    """One decode step of a batch: ids [B] at positions pos [B], from
    ``cache(l)``, layer l's state before the step: ``{"k", "v"}`` [B, S,
    KV, hd] for an attention layer, ``{"h", "conv"}`` for a Mamba layer.
    Returns {"logits": [B, V], "new": {layer: (k, v) or (h, conv)}}."""
    prec = prec or Precision()
    kinds = layer_kinds(cfg)
    stack = params["stack"]
    x = _embed(params, ids, prec)
    B = ids.shape[0]
    new = {}
    for l, (mixer, kind) in enumerate(kinds):
        p = layer_tree(stack, kinds, l)
        st = cache(l)
        h = rmsnorm(x, p["pre_norm"]["scale"])
        if mixer == "attn":
            y, k, v = attention_decode(h, p["attn"], cfg, pos, st["k"],
                                       st["v"], prec)
            new[l] = (k, v)
        else:
            y, hn, conv = mamba_decode(h, p, cfg, st["h"], st["conv"], prec)
            new[l] = (hn, conv)
        x = x + y
        x = x + ffn(rmsnorm(x, p["ffn_norm"]["scale"]), p, kind, cfg, prec,
                    B)
    return {"logits": _head(params, x, prec), "new": new}


def gap(logits, token):
    """How far the served token's logit lies below the best: >= 0."""
    return float(logits.max() - logits[token])


def rel_err(a, b, dim=None):
    """||a - b|| / ||b|| in float64 sums: over everything, or over the
    dims ``dim`` (one error a row)."""
    a, b = a.double(), b.double()
    if dim is None:
        return math.sqrt(float(((a - b) ** 2).sum()) /
                         max(float((b ** 2).sum()), 1e-300))
    return torch.sqrt(((a - b) ** 2).sum(dim) /
                      (b ** 2).sum(dim).clamp(min=1e-300))
