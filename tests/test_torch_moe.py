"""The port's MoE family against the JAX package's: configs, the router
inside ``moe_apply``, the dispatch, blocks, the model's forward (with
the load-balance loss), prefill, decode and the serving engine, for
reduced deepseek-moe-16b and mixtral-8x22b.

The reference initialises each reduced model; its weights cross to the
port by key, inputs are made with numpy from a seed, and both packages
run them on the CPU in float32.  Each case runs at the reduced config's
capacity factor 8.0 (no pair dropped) and at the default 1.25 (pairs
dropped, so the drop order is held too).  Outputs agree within 1e-5 of
each output's max (float32 in another summation order, as
tests/test_torch_lm.py), routing indices are equal, and greedy tokens
are identical.  Routes can only agree where no two probabilities sit
within float drift of the k-th pick: each test asserts that the
smallest gap between the k-th and (k+1)-th probability it saw is above
1e-6 (the smallest seen on the CPU is 2.5e-4).  The kernel
on the card is held to its plain version in
tests/test_torch_moe_router.py and chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import moe_router, moe_router_ref
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves, tree_map
from test_torch_lm import _tokens, _x, close, ref_tree_map
from test_torch_support import reference, to_np

ARCHS = ["deepseek-moe-16b", "mixtral-8x22b"]
FACTORS = [8.0, 1.25]
SEQ = 24
MIN_MARGIN = 1e-6


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.fixture(scope="module")
def pair(ref):
    """(arch, capacity factor) -> (reference model, its params, port
    model, port params), the port's weights carried across from the
    reference's init."""
    made = {}

    def get(arch, cf=8.0):
        if (arch, cf) not in made:
            rcfg = ref.reduced.reduced_config(arch).replace(
                expert_capacity_factor=cf)
            rmodel = ref.lm.build_model(rcfg)
            rparams = rmodel.init(ref.jax.random.PRNGKey(0))
            model = build_model(reduced_config(arch).replace(
                expert_capacity_factor=cf))
            params = params_from_numpy(to_np(rparams), "cpu", dtype=None)
            made[arch, cf] = (rmodel, rparams, model, params)
        return made[arch, cf]
    return get


class Routes:
    """A ``route`` that runs the router and keeps every call's
    probabilities and indices."""

    def __init__(self):
        self.calls = []

    def __call__(self, logits, k):
        out = moe_router(logits, k)
        self.calls.append((torch.softmax(logits, -1), out[1]))
        return out

    def min_margin(self, k):
        """The smallest gap between the k-th and (k+1)-th probability
        of any routed token."""
        gaps = [(v[:, k - 1] - v[:, k]).min()
                for v in (torch.sort(p, -1, descending=True).values
                          for p, _ in self.calls)]
        return float(min(gaps))


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


def test_full_deepseek_moe_16b_is_the_served_size():
    cfg = get_config("deepseek-moe-16b")
    assert cfg.param_counts()["total"] == 16_375_611_392
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.num_shared_experts, cfg.moe_d_ff, cfg.first_layer_dense_ff,
            cfg.vocab_size, cfg.dtype) == \
        (28, 2048, 16, 16, 128, 64, 6, 2, 1408, 10944, 102400, "bfloat16")
    layout = T.StackLayout(cfg, T.layer_kinds(cfg))
    assert (layout.prefix, layout.period, layout.n_groups) == (1, 1, 27)
    assert layout.kinds[0]["ffn"] == "dense0" and \
        layout.group_kinds[0]["ffn"] == "moe"


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------
def test_pick_groups_matches_reference(ref):
    for tokens in (1, 8, 48, 256, 257, 512, 1326, 4096):
        for batch in (1, 2, 4, 8):
            assert M._pick_groups(tokens, batch) == \
                ref.moe._pick_groups(tokens, batch), (tokens, batch)


@pytest.mark.parametrize("C", [1, 5, 80])
def test_dispatch_matches_reference(ref, C):
    """Sort order, capacity positions, drops and the buffer, exactly."""
    G, Tg, k, E, D = 2, 40, 2, 4, 8
    rng = np.random.default_rng(0)
    top = np.argsort(rng.random((G, Tg, E)), -1)[..., :k].astype(np.int32)
    xg = _x(1, G, Tg, D)
    theirs = ref.moe._dispatch(ref.jnp.asarray(xg), ref.jnp.asarray(top), E,
                               C)
    ours = M._dispatch(torch.tensor(xg), torch.tensor(top).long(), E, C)
    for name, a, b in zip(("buf", "dest", "keep", "src", "order"), ours,
                          theirs[:5]):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert (C >= Tg * k) == bool(ours[2].all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_tree_matches_reference(ref, arch, dtype):
    """Keys, shapes and dtypes; the router stays float32 in a bf16 tree."""
    jdt = getattr(ref.jnp, dtype)
    cfg = reduced_config(arch)
    theirs = ref.moe.moe_init(ref.jax.random.PRNGKey(0),
                              ref.reduced.reduced_config(arch), jdt)
    ours = M.moe_init(torch.Generator().manual_seed(0), cfg,
                      getattr(torch, dtype))
    shapes = lambda tree: tree_map(                 # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)
    assert shapes(ours) == shapes(to_np(theirs))
    assert ours["router"]["kernel"].dtype == torch.float32
    assert ("shared" in ours) == (arch == "deepseek-moe-16b")


# B, S: one group, a decode batch, and two groups (T = 512, G = 2)
MOE_SHAPES = [(2, SEQ), (8, 1), (4, 128)]


@pytest.mark.parametrize("B,S", MOE_SHAPES)
@pytest.mark.parametrize("cf", FACTORS + [0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(ref, arch, cf, B, S):
    """At 0.25 most pairs are dropped, so the order of the stable sort
    decides the output."""
    jax, jnp = ref.jax, ref.jnp
    rcfg = ref.reduced.reduced_config(arch).replace(
        expert_capacity_factor=cf)
    cfg = reduced_config(arch).replace(expert_capacity_factor=cf)
    rp = ref.moe.moe_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p = params_from_numpy(to_np(rp), "cpu", dtype=None)
    x = _x(1, B, S, cfg.d_model)
    y_r, aux_r = ref.moe.moe_apply(rp, jnp.asarray(x), rcfg)
    routes = Routes()
    y, aux = M.moe_apply(p, torch.tensor(x), cfg, routes, with_aux=True)
    close(y, y_r)
    assert abs(float(aux) - float(aux_r)) <= 1e-5 * abs(float(aux_r))
    k = cfg.num_experts_per_tok
    logits_r = jnp.asarray(x).reshape(B * S, -1) @ rp["router"]["kernel"]
    _, idx_r = jax.lax.top_k(jax.nn.softmax(logits_r, -1), k)
    (_, idx), = routes.calls
    assert np.array_equal(idx.numpy(), np.asarray(idx_r))
    assert routes.min_margin(k) > MIN_MARGIN
    # the capacity the reference computes, and the pairs it drops
    G = M._pick_groups(B * S, B)
    C = min(max(1, int(cf * k * (B * S // G) / cfg.num_experts)),
            B * S // G * k)
    counts = torch.stack([torch.bincount(g.flatten(), minlength=4)
                          for g in idx.long().reshape(G, -1, k)])
    dropped = int((counts - C).clamp(min=0).sum())
    if cf == 8.0:
        assert dropped == 0
    elif cf == 0.25 or (B, S) == (8, 1):
        assert dropped > 0, (cf, B, S, C)


def test_moe_apply_drops_only_what_capacity_drops(pair):
    """At capacity factor ~0 (C = 1) the routed part keeps one pair per
    expert: the output moves away from the lossless one, and a route
    that keeps every pair (capacity 64) restores it."""
    _, _, model, params = pair("mixtral-8x22b")
    cfg = model.cfg
    p = tree_map(lambda t: t[0], params["stack"]["scanned"]["sub_0"])["moe"]
    x = torch.tensor(_x(2, 1, 8, cfg.d_model))
    tight, _ = M.moe_apply(p, x, cfg.replace(expert_capacity_factor=1e-9))
    ample, _ = M.moe_apply(p, x, cfg.replace(expert_capacity_factor=64.0))
    lossless, _ = M.moe_apply(p, x, cfg)
    assert float(tight.abs().sum()) < float(ample.abs().sum())
    assert torch.equal(ample, lossless)


# ---------------------------------------------------------------------------
# blocks and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks(ref, pair, arch, cf):
    """block_apply (with aux) / block_prefill / block_decode of every
    kind in the periodic group (deepseek: dense0 then moe)."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch, cf)
    cfg = model.cfg
    x = _x(10, 1, SEQ, cfg.d_model)
    pos = np.arange(SEQ, dtype=np.int32)
    layout = T.StackLayout(cfg, model.kinds)
    want = ["dense0", "moe"] if arch == "deepseek-moe-16b" else ["moe"]
    assert [kd["ffn"] for kd in layout.group_kinds] == want
    for j, kind in enumerate(layout.group_kinds):
        rp = ref_tree_map(lambda t: t[0],
                          rparams["stack"]["scanned"][f"sub_{j}"])
        p = tree_map(lambda t: t[0], params["stack"]["scanned"][f"sub_{j}"])
        y_r, aux_r = ref.transformer.block_apply(
            rp, jnp.asarray(x), jnp.asarray(pos), rmodel.cfg, kind)
        y, aux = T.block_apply(p, torch.tensor(x), torch.tensor(pos), cfg,
                               kind)
        close({"y": y, "aux": aux}, {"y": y_r, "aux": aux_r})
        assert (float(aux) == 0.0) == (kind["ffn"] != "moe")
        y_r, c_r = ref.transformer.block_prefill(
            rp, jnp.asarray(x), jnp.asarray(pos), rmodel.cfg, kind, 1, 40,
            jnp.float32)
        y, c = T.block_prefill(p, torch.tensor(x), torch.tensor(pos), cfg,
                               kind, 1, 40, torch.float32)
        close({"y": y, "c": c}, {"y": y_r, "c": c_r})
        xd = _x(11, 1, 1, cfg.d_model)
        position = np.array([SEQ], np.int32)
        y_r, c_r = ref.transformer.block_decode(
            rp, jnp.asarray(xd), jnp.asarray(position), rmodel.cfg, kind,
            c_r)
        y, c = T.block_decode(p, torch.tensor(xd), torch.tensor(position),
                              cfg, kind, c)
        close({"y": y, "c": c}, {"y": y_r, "c": c_r})


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(ref, pair, arch):
    _, rparams, model, _ = pair(arch)
    ours = model.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: tree_map(                 # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)
    assert shapes(ours) == shapes(to_np(rparams))


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_with_aux(ref, pair, arch, cf):
    rmodel, rparams, model, params = pair(arch, cf)
    toks = _tokens(12, model.cfg, 2, SEQ)
    logits_r, aux_r = rmodel.forward_logits(
        rparams, {"tokens": ref.jnp.asarray(toks)})
    routes = Routes()
    logits, aux = build_model(model.cfg, route=routes).forward_logits(
        params, {"tokens": torch.tensor(toks)})
    assert logits.shape == (2, SEQ, model.vocab)
    close({"logits": logits, "aux": aux}, {"logits": logits_r, "aux": aux_r})
    assert float(aux) > 0
    assert routes.min_margin(model.cfg.num_experts_per_tok) > MIN_MARGIN


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps(ref, pair, arch, cf):
    """Prefill a prompt into a 40-slot cache, then three decode steps:
    logits and the whole decode state agree."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch, cf)
    routes = Routes()
    hooked = build_model(model.cfg, route=routes)
    toks = _tokens(13, model.cfg, 1, SEQ + 3)
    logits_r, st_r = rmodel.prefill(
        rparams, {"tokens": jnp.asarray(toks[:, :SEQ])}, cache_len=40)
    logits, st = hooked.prefill(params, {"tokens": torch.tensor(
        toks[:, :SEQ])}, cache_len=40)
    close({"logits": logits, "state": st},
          {"logits": logits_r, "state": st_r})
    for i in range(SEQ, SEQ + 3):
        tok = toks[:, i:i + 1]
        logits_r, st_r = rmodel.decode_step(rparams, st_r, jnp.asarray(tok))
        logits, st = hooked.decode_step(params, st, torch.tensor(tok))
        close({"logits": logits, "state": st},
              {"logits": logits_r, "state": st_r})
        assert int(logits.argmax()) == int(jnp.argmax(logits_r))
    assert routes.min_margin(model.cfg.num_experts_per_tok) > MIN_MARGIN


@pytest.mark.parametrize("arch", ARCHS)
def test_route_reaches_every_moe_layer(pair, arch):
    """``Model(cfg, route=...)`` calls ``route`` once per MoE layer in
    forward, prefill and decode; the plain version given as ``route``
    is what the CPU path runs anyway."""
    _, _, model, params = pair(arch)
    n_moe = sum(kd["ffn"] == "moe" for kd in model.kinds)
    assert n_moe == (1 if arch == "deepseek-moe-16b" else 2)
    calls = []

    def route(logits, k):
        calls.append(logits.shape)
        return moe_router_ref(logits, k)

    hooked = build_model(model.cfg, route=route)
    toks = {"tokens": torch.tensor(_tokens(14, model.cfg, 1, SEQ))}
    assert torch.equal(hooked.forward_logits(params, toks)[0],
                       model.forward_logits(params, toks)[0])
    assert calls == [(SEQ, model.cfg.num_experts)] * n_moe
    calls.clear()
    logits, st = hooked.prefill(params, toks, cache_len=40)
    want, want_st = model.prefill(params, toks, cache_len=40)
    assert torch.equal(logits, want) and len(calls) == n_moe
    calls.clear()
    tok = torch.tensor([[3]])
    logits, _ = hooked.decode_step(params, st, tok)
    assert calls == [(1, model.cfg.num_experts)] * n_moe
    assert torch.equal(logits, model.decode_step(params, want_st, tok)[0])


def test_moe_tree_crosses_both_ways(ref):
    """A bfloat16 MoE tree, its routers and norms float32, crosses from
    the reference to the port and back bit for bit, each leaf in its
    own dtype."""
    rcfg = ref.reduced.reduced_config("deepseek-moe-16b").replace(
        dtype="bfloat16")
    rparams = to_np(ref.lm.build_model(rcfg).init(ref.jax.random.PRNGKey(1)))
    ours = params_from_numpy(rparams, "cpu", dtype=None)
    routers = [t for t in tree_leaves(ours) if t.shape[-2:] == (256, 4)]
    assert routers and all(t.dtype == torch.float32 for t in routers)
    assert ours["stack"]["scanned"]["sub_1"]["moe"]["experts"]["w_up"] \
        .dtype == torch.bfloat16
    want = build_model(reduced_config("deepseek-moe-16b").replace(
        dtype="bfloat16")).init(torch.Generator().manual_seed(0))
    assert tree_map(lambda t: t.dtype, ours) == \
        tree_map(lambda t: t.dtype, want)
    back = params_to_numpy(ours)
    for a, b in zip(tree_leaves(back), tree_leaves(rparams), strict=True):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_reference(ref, pair, arch, cf):
    """Two slots for four requests, so slots refill; at capacity 1.25 a
    decode step's C is 1 and the padding slot competes for it."""
    rmodel, rparams, model, params = pair(arch, cf)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in (5, 9, 3, 7)]
    routes = Routes()
    outs = []
    for mod, eng, req, m, p in (
            (ref.engine, ref.engine.ServingEngine, ref.engine.Request,
             rmodel, rparams),
            (None, ServingEngine, Request, build_model(model.cfg,
                                                       route=routes),
             params)):
        engine = eng(m, p, max_batch=2, cache_len=64)
        for i, prompt in enumerate(prompts):
            engine.submit(req(uid=i, prompt=prompt, max_new_tokens=6))
        outs.append(engine.run())
        assert engine.stats["done"] == len(prompts)
    assert outs[1] == outs[0]
    assert routes.min_margin(model.cfg.num_experts_per_tok) > MIN_MARGIN


def test_serve_cli_runs_deepseek_on_the_cpu(capsys):
    out = serve_main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                      "--reduced", "--batch", "2", "--steps", "20",
                      "--cache", "32"])
    assert out.shape == (20, 2)
    assert "on cpu" in capsys.readouterr().out
