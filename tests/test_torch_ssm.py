"""The port's ssm and hybrid families against the JAX package's: configs,
the RWKV6 time and channel mixes, the Mamba mixer (prefill with a state,
decode), blocks, the model's forward / prefill / decode and the serving
engine, for reduced rwkv6-1.6b and jamba-v0.1-52b.

The reference initialises each reduced model; its weights cross to the
port by key, inputs are made with numpy from a seed, and both packages
run them on the CPU in float32.  Outputs and decode states agree within
1e-5 of each output's max (float32 in another summation order, as
tests/test_torch_lm.py), and greedy tokens are identical.  jamba runs at
the reduced config's capacity factor 8.0 and at the default 1.25, as
tests/test_torch_moe.py does.  One bfloat16 case per family holds the
dtype promotion (JAX widens a bf16 product plus a float32 bias to
float32) at the bf16 tolerance of tests/test_kernels.py.  The scans'
kernels are held to their plain versions on the card in
tests/test_torch_rwkv6_scan.py, tests/test_torch_mamba_scan.py and
chip_smoke.py.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import (
    params_from_numpy, params_to_numpy, state_to_numpy)
from repro_torch.kernels import (
    mamba_scan, mamba_scan_fused, mamba_scan_fused_ref, rwkv6_scan,
    rwkv6_scan_ref)
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves, tree_map
from test_torch_lm import _leaves, _tokens, _x, close, ref_tree_map
from test_torch_support import reference, to_np

ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b"]
# (arch, capacity factor): jamba also at the default 1.25, which drops
# (token, expert) pairs
CASES = [("rwkv6-1.6b", 8.0), ("jamba-v0.1-52b", 8.0),
         ("jamba-v0.1-52b", 1.25)]
SEQ = 24
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.fixture(scope="module")
def pair(ref):
    """(arch, capacity factor, dtype) -> (reference model, its params,
    port model, port params), the port's weights carried across from
    the reference's init."""
    made = {}

    def get(arch, cf=8.0, dtype="float32"):
        if (arch, cf, dtype) not in made:
            kw = {"dtype": dtype}
            if arch == "jamba-v0.1-52b":
                kw["expert_capacity_factor"] = cf
            rmodel = ref.lm.build_model(
                ref.reduced.reduced_config(arch).replace(**kw))
            rparams = rmodel.init(ref.jax.random.PRNGKey(0))
            model = build_model(reduced_config(arch).replace(**kw))
            params = params_from_numpy(to_np(rparams), "cpu", dtype=None)
            made[arch, cf, dtype] = (rmodel, rparams, model, params)
        return made[arch, cf, dtype]
    return get


def _sub(tree, j):
    """Group 0's sub-layer ``j`` of a stacked tree (the reference's or
    the port's)."""
    sub = tree["stack"]["scanned"][f"sub_{j}"]
    if isinstance(tree_leaves(sub)[0], torch.Tensor):
        return tree_map(lambda t: t[0], sub)
    return ref_tree_map(lambda t: t[0], sub)


def _close_bf16(ours, theirs):
    """Every leaf within BF16_TOL of the max of the matching reference
    leaf: tests/test_kernels.py's bf16 rule."""
    close(ours, theirs, rtol=BF16_TOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(ref, name):
    ours, theirs = get_config(name), ref.configs.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_counts() == theirs.param_counts()
    assert dataclasses.asdict(reduced_config(name)) == \
        dataclasses.asdict(ref.reduced.reduced_config(name))


def _meta_init(model):
    """The model's tree on the meta device (no memory): shapes and
    dtypes only."""
    return model.init_meta()


@pytest.mark.parametrize("name,layers,count", [
    ("rwkv6-1.6b", 24, 1_584_091_136),
    ("jamba-v0.1-52b", 16, 26_053_480_448)])
def test_full_size_tree_is_the_reference_tree(ref, name, layers, count):
    """The served sizes: the port's tree at full width (jamba at 16 of
    its 32 layers, as chip_smoke.py serves it) has the reference's
    leaves, shapes and dtypes, and chip_smoke.py's parameter count."""
    cfg = get_config(name).replace(num_layers=layers)
    ours = _meta_init(build_model(cfg))
    theirs = ref.jax.eval_shape(
        ref.lm.build_model(ref.configs.get_config(name).replace(
            num_layers=layers)).init, ref.jax.random.PRNGKey(0))
    shapes = lambda tree: [                        # noqa: E731
        (tuple(a.shape), str(a.dtype).split(".")[-1])
        for a in tree_leaves(tree)]
    assert shapes(ours) == [(tuple(a.shape), str(a.dtype))
                            for a in _leaves(theirs)]
    assert sum(math.prod(t.shape) for t in tree_leaves(ours)) == count


# ---------------------------------------------------------------------------
# ssm.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_mix(ref, pair, with_state):
    """Full sequence from zeros, or from a previous token and a random
    WKV state (the decode path at S = 24)."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("rwkv6-1.6b")
    rp, p = _sub(rparams, 0), _sub(params, 0)
    cfg = model.cfg
    x = _x(20, 2, SEQ, cfg.d_model)
    kw_r, kw = {}, {}
    if with_state:
        prev = _x(21, 2, cfg.d_model)
        st = _x(22, 2, 4, 64, 64) * 0.3
        kw_r = {"x_prev": jnp.asarray(prev), "state": jnp.asarray(st)}
        kw = {"x_prev": torch.tensor(prev), "state": torch.tensor(st)}
    y_r, st_r = ref.ssm.rwkv_time_mix(rp, jnp.asarray(x), rmodel.cfg,
                                      return_state=True, **kw_r)
    y, st = S.rwkv_time_mix(p, torch.tensor(x), cfg, return_state=True,
                            **kw)
    close({"y": y, "st": st}, {"y": y_r, "st": st_r})


def test_rwkv_time_mix_writes_the_state_in_place(pair):
    _, _, model, params = pair("rwkv6-1.6b")
    p, cfg = _sub(params, 0), model.cfg
    x = torch.tensor(_x(23, 2, 1, cfg.d_model))
    st = torch.tensor(_x(24, 2, 4, 64, 64))
    want_y, want = S.rwkv_time_mix(p, x, cfg, state=st.clone(),
                                   return_state=True)
    y = S.rwkv_time_mix(p, x, cfg, state=st, state_out=st)
    assert torch.equal(y, want_y) and torch.equal(st, want["wkv"])


@pytest.mark.parametrize("with_prev", [False, True])
def test_rwkv_channel_mix(ref, pair, with_prev):
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("rwkv6-1.6b")
    cfg = model.cfg
    x = _x(25, 2, SEQ, cfg.d_model)
    prev = _x(26, 2, cfg.d_model) if with_prev else None
    y_r, last_r = ref.ssm.rwkv_channel_mix(
        _sub(rparams, 0), jnp.asarray(x), rmodel.cfg,
        x_prev=None if prev is None else jnp.asarray(prev),
        return_state=True)
    y, last = S.rwkv_channel_mix(
        _sub(params, 0), torch.tensor(x), cfg,
        x_prev=None if prev is None else torch.tensor(prev),
        return_state=True)
    close({"y": y, "last": last}, {"y": y_r, "last": last_r})


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply(ref, pair, with_state):
    """Prefill from zeros, or from a random state; the state returned
    (h and the conv history) agrees too."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("jamba-v0.1-52b")
    cfg = model.cfg
    assert model.kinds[0]["mixer"] == "mamba"
    rp, p = _sub(rparams, 0), _sub(params, 0)
    x = _x(27, 2, SEQ, cfg.d_model)
    h0 = _x(28, 2, 2 * cfg.d_model, cfg.ssm_state_dim) if with_state \
        else None
    y_r, st_r = ref.ssm.mamba_apply(
        rp, jnp.asarray(x), rmodel.cfg, return_state=True,
        init_state=None if h0 is None else jnp.asarray(h0))
    y, st = S.mamba_apply(p, torch.tensor(x), cfg, return_state=True,
                          init_state=None if h0 is None else
                          torch.tensor(h0))
    close({"y": y, "st": st}, {"y": y_r, "st": st_r})


def test_mamba_decode(ref, pair):
    """Three decode steps from a random state: the reference steps the
    recurrence inline, the port through the scan at T = 1; the state is
    written in place."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("jamba-v0.1-52b")
    cfg = model.cfg
    rp, p = _sub(rparams, 0), _sub(params, 0)
    d_in = 2 * cfg.d_model
    st_np = {"h": _x(29, 2, d_in, cfg.ssm_state_dim),
             "conv": _x(30, 2, cfg.ssm_conv_width - 1, d_in)}
    st_r = {k: jnp.asarray(v) for k, v in st_np.items()}
    st = params_from_numpy(st_np, "cpu")
    held = dict(st)
    for i in range(3):
        x = _x(31 + i, 2, 1, cfg.d_model)
        y_r, st_r = ref.ssm.mamba_decode(rp, jnp.asarray(x), st_r,
                                         rmodel.cfg)
        y, st = S.mamba_decode(p, torch.tensor(x), st, cfg)
        close({"y": y, "st": st}, {"y": y_r, "st": st_r})
    assert all(st[k] is held[k] for k in held)


# ---------------------------------------------------------------------------
# blocks and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,cf", CASES)
def test_blocks(ref, pair, arch, cf):
    """block_apply / block_prefill / block_decode of every kind in the
    periodic group (rwkv: rwkv + rwkv_cm; jamba: mamba + dense, then
    attention + moe)."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch, cf)
    cfg = model.cfg
    x = _x(40, 1, SEQ, cfg.d_model)
    pos = np.arange(SEQ, dtype=np.int32)
    layout = T.StackLayout(cfg, model.kinds)
    want = [("rwkv", "rwkv_cm")] if arch == "rwkv6-1.6b" else \
        [("mamba", "dense"), ("attn", "moe")]
    assert [(kd["mixer"], kd["ffn"]) for kd in layout.group_kinds] == want
    for j, kind in enumerate(layout.group_kinds):
        rp, p = _sub(rparams, j), _sub(params, j)
        y_r, aux_r = ref.transformer.block_apply(
            rp, jnp.asarray(x), jnp.asarray(pos), rmodel.cfg, kind)
        y, aux = T.block_apply(p, torch.tensor(x), torch.tensor(pos), cfg,
                               kind)
        close({"y": y, "aux": aux}, {"y": y_r, "aux": aux_r})
        y_r, c_r = ref.transformer.block_prefill(
            rp, jnp.asarray(x), jnp.asarray(pos), rmodel.cfg, kind, 1, 40,
            jnp.float32)
        y, c = T.block_prefill(p, torch.tensor(x), torch.tensor(pos), cfg,
                               kind, 1, 40, torch.float32)
        close({"y": y, "c": c}, {"y": y_r, "c": c_r})
        for step in range(2):
            xd = _x(41 + step, 1, 1, cfg.d_model)
            position = np.array([SEQ + step], np.int32)
            y_r, c_r = ref.transformer.block_decode(
                rp, jnp.asarray(xd), jnp.asarray(position), rmodel.cfg,
                kind, c_r)
            y, c = T.block_decode(p, torch.tensor(xd),
                                  torch.tensor(position), cfg, kind, c)
            close({"y": y, "c": c}, {"y": y_r, "c": c_r})


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(ref, pair, arch):
    _, rparams, model, _ = pair(arch)
    ours = model.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: tree_map(                 # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)
    assert shapes(ours) == shapes(to_np(rparams))


@pytest.mark.parametrize("arch,cf", CASES)
def test_forward_logits(ref, pair, arch, cf):
    rmodel, rparams, model, params = pair(arch, cf)
    toks = _tokens(42, model.cfg, 2, SEQ)
    logits_r, aux_r = rmodel.forward_logits(
        rparams, {"tokens": ref.jnp.asarray(toks)})
    logits, aux = model.forward_logits(params, {"tokens": torch.tensor(toks)})
    assert logits.shape == (2, SEQ, model.vocab) and \
        logits.dtype == torch.float32
    close({"logits": logits, "aux": aux}, {"logits": logits_r, "aux": aux_r})
    assert (float(aux) > 0) == (arch == "jamba-v0.1-52b")


@pytest.mark.parametrize("arch,cf", CASES)
def test_prefill_then_decode_steps(ref, pair, arch, cf):
    """Prefill a prompt into a 40-slot cache, then three decode steps:
    logits and the whole decode state (recurrent states, token-shift
    rows, conv history, KV cache) agree."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch, cf)
    toks = _tokens(43, model.cfg, 1, SEQ + 3)
    logits_r, st_r = rmodel.prefill(
        rparams, {"tokens": jnp.asarray(toks[:, :SEQ])}, cache_len=40)
    logits, st = model.prefill(params, {"tokens": torch.tensor(
        toks[:, :SEQ])}, cache_len=40)
    close({"logits": logits, "state": st},
          {"logits": logits_r, "state": st_r})
    for i in range(SEQ, SEQ + 3):
        tok = toks[:, i:i + 1]
        logits_r, st_r = rmodel.decode_step(rparams, st_r, jnp.asarray(tok))
        logits, st = model.decode_step(params, st, torch.tensor(tok))
        close({"logits": logits, "state": st},
              {"logits": logits_r, "state": st_r})
        assert int(logits.argmax()) == int(jnp.argmax(logits_r))


def test_bfloat16_rwkv_model_matches_reference(ref, pair):
    """A bfloat16 rwkv6: forward logits, and a prefill then two decode
    steps, within the bf16 tolerance; the WKV state is float32 and the
    token-shift rows bfloat16 in both."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("rwkv6-1.6b", dtype="bfloat16")
    toks = _tokens(44, model.cfg, 1, SEQ + 2)
    logits_r, _ = rmodel.forward_logits(
        rparams, {"tokens": jnp.asarray(toks[:, :SEQ])})
    logits, _ = model.forward_logits(params,
                                     {"tokens": torch.tensor(toks[:, :SEQ])})
    _close_bf16(logits, logits_r)
    logits_r, st_r = rmodel.prefill(
        rparams, {"tokens": jnp.asarray(toks[:, :SEQ])}, cache_len=40)
    logits, st = model.prefill(params, {"tokens": torch.tensor(
        toks[:, :SEQ])}, cache_len=40)
    _close_bf16({"logits": logits, "state": st},
                {"logits": logits_r, "state": st_r})
    for i in range(SEQ, SEQ + 2):
        tok = toks[:, i:i + 1]
        logits_r, st_r = rmodel.decode_step(rparams, st_r, jnp.asarray(tok))
        logits, st = model.decode_step(params, st, torch.tensor(tok))
        _close_bf16({"logits": logits, "state": st},
                    {"logits": logits_r, "state": st_r})
    dtypes = tree_map(lambda t: str(t.dtype).split(".")[-1], st["cache"])
    assert dtypes == ref_tree_map(lambda a: str(a.dtype), st_r["cache"])


def test_bfloat16_jamba_blocks_match_reference(ref, pair):
    """A bfloat16 jamba, block by block on the reference's own hidden
    states: block_apply, block_prefill and two block_decode steps of
    every kind (mamba + dense, attention + moe) within the bf16
    tolerance, the Mamba state float32 and the conv history bfloat16
    in both.  Whole-model logits are not compared in bf16: a bf16
    rounding can move a top-k pick of a later MoE layer, and that
    token's output with it."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("jamba-v0.1-52b",
                                          dtype="bfloat16")
    cfg, rcfg = model.cfg, rmodel.cfg
    toks = _tokens(44, cfg, 1, SEQ)
    h = ref.transformer.embed_input(rparams, jnp.asarray(toks), rcfg)
    pos = np.arange(SEQ, dtype=np.int32)
    layout = T.StackLayout(cfg, model.kinds)
    for g in range(layout.n_groups):
        for j, kind in enumerate(layout.group_kinds):
            sub = f"sub_{j}"
            rp = ref_tree_map(lambda t: t[g],
                              rparams["stack"]["scanned"][sub])
            p = tree_map(lambda t: t[g], params["stack"]["scanned"][sub])
            x = torch.tensor(np.asarray(h.astype(jnp.float32))).bfloat16()
            y_r, _ = ref.transformer.block_apply(rp, h, jnp.asarray(pos),
                                                 rcfg, kind)
            y, _ = T.block_apply(p, x, torch.tensor(pos), cfg, kind)
            _close_bf16(y, y_r)
            y_r, c_r = ref.transformer.block_prefill(
                rp, h, jnp.asarray(pos), rcfg, kind, 1, 40, jnp.bfloat16)
            y, c = T.block_prefill(p, x, torch.tensor(pos), cfg, kind, 1,
                                   40, torch.bfloat16)
            _close_bf16({"y": y, "c": c}, {"y": y_r, "c": c_r})
            assert tree_map(lambda t: str(t.dtype).split(".")[-1], c) == \
                ref_tree_map(lambda a: str(a.dtype), c_r)
            for step in range(2):
                xd = y_r[:, -1:] if step == 0 else yd_r
                position = np.array([SEQ + step], np.int32)
                yd_r, c_r = ref.transformer.block_decode(
                    rp, xd, jnp.asarray(position), rcfg, kind, c_r)
                yd, c = T.block_decode(
                    p, torch.tensor(np.asarray(xd.astype(
                        jnp.float32))).bfloat16(), torch.tensor(position),
                    cfg, kind, c)
                _close_bf16({"y": yd, "c": c}, {"y": yd_r, "c": c_r})
            h = y_r


def test_bfloat16_promotion_of_the_mamba_discretisation(ref, pair):
    """dt = softplus(dt_raw @ dt_proj + dt_bias), a and bx are float32
    in a bf16 model, as JAX promotes them: the scan's inputs agree with
    the reference's at float32 precision, not only at bf16's."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("jamba-v0.1-52b", dtype="bfloat16")
    rp, p = _sub(rparams, 0)["mamba"], _sub(params, 0)["mamba"]
    x_conv = _x(45, 1, 5, 2 * model.cfg.d_model)
    xr = jnp.asarray(x_conv).astype(jnp.bfloat16)
    proj = xr @ rp["x_proj"]
    dt_raw, Bm, Cm = jnp.split(proj, [16, 24], axis=-1)
    dt = ref.jax.nn.softplus(dt_raw @ rp["dt_proj"] + rp["dt_bias"])
    a_r = jnp.exp(dt[..., None] * -jnp.exp(rp["A_log"]))
    bx_r = (dt * xr)[..., None] * Bm[:, :, None, :].astype(dt.dtype)
    assert dt.dtype == a_r.dtype == bx_r.dtype == jnp.float32
    a, bx, c = S._discretise(p, torch.tensor(x_conv).bfloat16(), 16, 8)
    close({"a": a, "bx": bx, "c": c}, {"a": a_r, "bx": bx_r, "c": Cm})


@pytest.mark.parametrize("arch", ARCHS)
def test_hooks_reach_every_layer(pair, arch):
    """``Model(cfg, wkv=..., sscan=...)`` calls the hook once per RWKV
    or Mamba layer in forward, prefill and decode (decode in place, at
    T = 1); the plain version given as the hook is what the CPU path
    runs anyway."""
    _, _, model, params = pair(arch)
    key, plain = ("wkv", rwkv6_scan_ref) if arch == "rwkv6-1.6b" else \
        ("sscan", mamba_scan_fused_ref)
    mixer = "rwkv" if arch == "rwkv6-1.6b" else "mamba"
    n = sum(kd["mixer"] == mixer for kd in model.kinds)
    assert n == 2
    calls = []

    def hook(*args, **kw):
        calls.append((args[0].shape[1], kw.get("state_out",
                                              kw.get("h_out")) is not None))
        return plain(*args, **kw)

    hooked = build_model(model.cfg, **{key: hook})
    toks = {"tokens": torch.tensor(_tokens(46, model.cfg, 1, SEQ))}
    assert torch.equal(hooked.forward_logits(params, toks)[0],
                       model.forward_logits(params, toks)[0])
    assert calls == [(SEQ, False)] * n
    calls.clear()
    logits, st = hooked.prefill(params, toks, cache_len=40)
    want, want_st = model.prefill(params, toks, cache_len=40)
    assert torch.equal(logits, want) and calls == [(SEQ, False)] * n
    calls.clear()
    tok = torch.tensor([[3]])
    logits, _ = hooked.decode_step(params, st, tok)
    assert calls == [(1, True)] * n
    assert torch.equal(logits, model.decode_step(params, want_st, tok)[0])


# ---------------------------------------------------------------------------
# decode equals forward, inside the port (tests/test_decode_consistency.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(pair, arch):
    """Token-by-token decode from an empty state reproduces the full
    forward's logits (the reference's tolerance, 2e-3)."""
    _, _, model, params = pair(arch)
    toks = torch.tensor(_tokens(47, model.cfg, 2, SEQ)).long()
    full, _ = model.forward_logits(params, {"tokens": toks})
    state = model.init_decode_state(2, SEQ, device="cpu")
    steps = []
    for t in range(SEQ):
        lg, state = model.decode_step(params, state, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(pair, arch):
    """Prefill n tokens then decode the rest equals the forward; and one
    decode step after prefill(n) equals prefill(n + 1) within 1e-5,
    which a decode from a zeroed recurrent state does not."""
    _, _, model, params = pair(arch)
    toks = torch.tensor(_tokens(48, model.cfg, 1, SEQ)).long()
    full, _ = model.forward_logits(params, {"tokens": toks})
    n = 10
    logits, st = model.prefill(params, {"tokens": toks[:, :n]},
                               cache_len=SEQ)
    out = [logits[:, 0]]
    for t in range(n, SEQ):
        lg, st = model.decode_step(params, st, toks[:, t:t + 1])
        out.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(out, 1), full[:, n - 1:],
                               atol=2e-3, rtol=2e-3)
    want, _ = model.prefill(params, {"tokens": toks[:, :n + 1]})
    _, st = model.prefill(params, {"tokens": toks[:, :n]}, cache_len=SEQ)
    carried, _ = model.decode_step(params, st, toks[:, n:n + 1])
    torch.testing.assert_close(carried, want, atol=1e-5, rtol=1e-5)
    _, st = model.prefill(params, {"tokens": toks[:, :n]}, cache_len=SEQ)
    for sub in st["cache"]["scanned"].values():
        for mixer, leaf in (("rwkv", "wkv"), ("mamba", "h")):
            if mixer in sub:
                sub[mixer][leaf].zero_()
    zeroed, _ = model.decode_step(params, st, toks[:, n:n + 1])
    # 0.0065 for jamba (its short Mamba memory), far above 1e-5
    assert float((zeroed - want).norm() / want.norm()) > 1e-3


# ---------------------------------------------------------------------------
# interop and serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_trees_and_states_cross_both_ways(ref, pair, arch):
    """The reference's decode state and a bfloat16 weight tree cross to
    the port and back bit for bit, each leaf in its own dtype."""
    rmodel, _, model, _ = pair(arch)
    st_r = to_np(rmodel.init_decode_state(2, 40))
    st = params_from_numpy(st_r, "cpu", dtype=None)
    fresh = model.init_decode_state(2, 40, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), st) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), fresh)
    for a, b in zip(tree_leaves(state_to_numpy(st)), _leaves(st_r),
                    strict=True):
        assert np.array_equal(a, b)
    rbf = to_np(ref.lm.build_model(rmodel.cfg.replace(
        dtype="bfloat16")).init(ref.jax.random.PRNGKey(1)))
    ours = params_from_numpy(rbf, "cpu", dtype=None)
    want = build_model(model.cfg.replace(dtype="bfloat16")).init(
        torch.Generator().manual_seed(0))
    assert tree_map(lambda t: t.dtype, ours) == \
        tree_map(lambda t: t.dtype, want)
    for a, b in zip(tree_leaves(params_to_numpy(ours)), _leaves(rbf),
                    strict=True):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch,cf", CASES)
def test_engine_greedy_tokens_match_reference(ref, pair, arch, cf):
    """Two slots for four requests, so slots refill and a prefill's
    recurrent state is spliced into a running batch."""
    rmodel, rparams, model, params = pair(arch, cf)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in (5, 9, 3, 7)]
    outs = []
    for eng, req, m, p in ((ref.engine.ServingEngine, ref.engine.Request,
                            rmodel, rparams),
                           (ServingEngine, Request, model, params)):
        engine = eng(m, p, max_batch=2, cache_len=64)
        for i, prompt in enumerate(prompts):
            engine.submit(req(uid=i, prompt=prompt, max_new_tokens=6))
        outs.append(engine.run())
        assert engine.stats["done"] == len(prompts)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(capsys, arch):
    out = serve_main(["--arch", arch, "--device", "cpu", "--reduced",
                      "--batch", "2", "--steps", "12", "--cache", "32"])
    assert out.shape == (12, 2)
    assert "on cpu" in capsys.readouterr().out


def test_cpu_path_launches_no_scan_kernel(pair):
    def counts():
        return (rwkv6_scan.launches, mamba_scan.launches,
                mamba_scan_fused.launches)
    before = counts()
    for arch in ARCHS:
        _, _, model, params = pair(arch)
        model.prefill(params, {"tokens": torch.tensor([[1, 2, 3]])})
    assert counts() == before


@pytest.mark.parametrize("kind", [
    {"mixer": "mamba2", "ffn": "dense"}, {"mixer": "rwkv", "ffn": "glu"}])
def test_unknown_kinds_and_hooks_raise(kind):
    """A mixer or FFN the port does not know raises in every block
    function (none is run as another kind), and so does a hook name."""
    cfg = reduced_config("rwkv6-1.6b")
    kind = {**kind, "window": None, "cross": False}
    x = torch.zeros(1, 2, cfg.d_model)
    calls = [
        lambda: T.block_init(torch.Generator(), cfg, kind, torch.float32),
        lambda: T.block_apply({}, x, torch.arange(2), cfg, kind),
        lambda: T.block_prefill({}, x, torch.arange(2), cfg, kind, 1, 4,
                                torch.float32),
        lambda: T.block_init_cache(cfg, kind, 1, 4, torch.float32),
        lambda: T.block_decode({}, x[:, :1], torch.zeros(1), cfg, kind,
                               {})]
    for call in calls:
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            call()
    with pytest.raises(TypeError, match="unknown kernel hooks"):
        build_model(cfg, scan=rwkv6_scan_ref)
