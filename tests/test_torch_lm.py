"""The port's dense-family LM against the JAX package's: configs, layers,
attention, blocks, the model's forward / prefill / decode and the
continuous-batching engine.

The reference initialises each reduced model; its weights cross to the
port by key (``repro_torch.interop``), inputs are made with numpy from a
seed, and both packages run them on the CPU in float32.  Outputs agree
within 1e-5 of each output's max (float32 in another summation order),
and greedy tokens are identical.  The kernel on the card is held to its
plain version in tests/test_torch_flash_attention.py and chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import (
    params_from_numpy, params_to_numpy, state_to_numpy)
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import make_serve_step
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import reference, to_np

ARCHS = ["qwen2-7b", "qwen2-7b-swa", "gemma2-2b", "qwen1.5-0.5b"]
DENSE = ["qwen2-7b", "qwen2-7b-swa", "qwen1.5-0.5b", "qwen1.5-4b",
         "qwen1.5-4b-swa", "gemma2-2b"]
RTOL = 1e-5
SEQ = 24            # longer than the reduced window (16): the ring wraps


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.fixture(scope="module")
def pair(ref):
    """arch -> (reference model, its params, port model, port params),
    the port's weights carried across from the reference's init."""
    made = {}

    def get(arch):
        if arch not in made:
            rmodel = ref.lm.build_model(ref.reduced.reduced_config(arch))
            rparams = rmodel.init(ref.jax.random.PRNGKey(0))
            model = build_model(reduced_config(arch))
            params = params_from_numpy(to_np(rparams), "cpu", dtype=None)
            made[arch] = (rmodel, rparams, model, params)
        return made[arch]
    return get


def close(ours, theirs, rtol=RTOL):
    """Every leaf of ``ours`` (tensors) within ``rtol`` of the max of
    the matching leaf of ``theirs`` (JAX or numpy arrays)."""
    ours = state_to_numpy(ours) if isinstance(ours, dict) else \
        state_to_numpy({"x": ours})["x"]
    for a, b in zip(tree_leaves(ours), _leaves(theirs), strict=True):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (a.shape, b.shape)
        err = float(np.abs(a.astype(np.float32) - b).max()) if a.size else 0
        assert err <= rtol * max(float(np.abs(b).max()), 1e-30), err


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _tokens(seed, cfg, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DENSE)
def test_config_matches_reference(ref, name):
    ours, theirs = get_config(name), ref.configs.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_counts() == theirs.param_counts()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_matches_reference(ref, arch):
    assert dataclasses.asdict(reduced_config(arch)) == \
        dataclasses.asdict(ref.reduced.reduced_config(arch))


def test_full_qwen2_7b_is_the_cell_size():
    cfg = get_config("qwen2-7b")
    assert cfg.param_counts()["total"] == 7_615_283_200
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.dtype) == \
        (28, 3584, 28, 4, 128, 18944, "bfloat16")


def test_every_reference_arch_is_listed_and_input_shapes_match(ref):
    """Every architecture of the reference is one of the port's (the
    paper's MLPs by their own ``MLPConfig``), each LM with the
    reference's config, and the input shapes are the reference's."""
    assert list_configs() == sorted(ref.configs.list_configs())
    lms = [n for n in list_configs() if not n.startswith("paper-mlp")]
    assert {"llava-next-34b", "seamless-m4t-medium"} <= set(lms)
    for name in lms:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(ref.configs.get_config(name)), name
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in ref.configs.INPUT_SHAPES.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(ref, kind):
    jnp = ref.jnp
    x = _x(0, 2, 5, 32) * 3 + 1
    p = {"scale": _x(1, 32), "bias": _x(2, 32)}
    if kind == "rmsnorm":
        del p["bias"]
    theirs = ref.layers.apply_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    ours = L.apply_norm(params_from_numpy(p, "cpu"), torch.tensor(x), kind)
    close(ours, theirs)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(ref, per_row):
    jnp = ref.jnp
    x = _x(3, 2, 6, 4, 64)
    pos = np.arange(6, dtype=np.int32) + 100
    if per_row:
        pos = np.stack([pos, pos * 7]).astype(np.int32)
    theirs = ref.layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    ours = L.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6)
    close(ours, theirs)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
def test_mlp_apply_and_softcap(ref, act):
    jnp = ref.jnp
    rp = ref.layers.mlp_init(ref.jax.random.PRNGKey(0), 32, 48, act,
                             jnp.float32)
    x = _x(4, 2, 5, 32)
    theirs = ref.layers.mlp_apply(rp, jnp.asarray(x), act)
    ours = L.mlp_apply(params_from_numpy(to_np(rp), "cpu"), torch.tensor(x),
                       act)
    close(ours, theirs)
    close(L.softcap(ours, 3.0), ref.layers.softcap(theirs, 3.0))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _layer0(pair, arch):
    rmodel, rparams, model, params = pair(arch)
    take0 = lambda t: t[0]                      # noqa: E731
    rp = ref_tree_map(take0, rparams["stack"]["scanned"]["sub_0"])
    return rmodel, rp, model, tree_map(
        take0, params["stack"]["scanned"]["sub_0"])


def ref_tree_map(fn, tree):
    return {k: ref_tree_map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


@pytest.mark.parametrize("offset", [0, 100])
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_apply_and_cache_fill(ref, pair, arch, offset):
    """Prefill masks by index; with consecutive positions from any
    offset that is the reference's mask by position."""
    jnp = ref.jnp
    rmodel, rp, model, p = _layer0(pair, arch)
    cfg = model.cfg
    window = model.kinds[0]["window"]
    x = _x(5, 2, SEQ, cfg.d_model)
    pos = np.arange(SEQ, dtype=np.int32) + offset
    out_r, (k_r, v_r) = ref.attention.attn_apply(
        rp["attn"], jnp.asarray(x), jnp.asarray(pos), rmodel.cfg,
        layer_window=window, return_kv=True)
    out, (k, v) = A.attn_apply(p["attn"], torch.tensor(x), torch.tensor(pos),
                               cfg, layer_window=window, return_kv=True)
    close({"o": out, "k": k, "v": v}, {"o": out_r, "k": k_r, "v": v_r})

    cache_r = ref.attention.fill_cache_from_prefill(
        ref.attention.init_cache(rmodel.cfg, 2, 40, window, jnp.float32),
        k_r, v_r, jnp.asarray(pos), 2)
    cache = A.fill_cache_from_prefill(
        A.init_cache(cfg, 2, 40, window, torch.float32), k, v,
        torch.tensor(pos), 2)
    close(cache, cache_r)
    assert np.array_equal(cache["pos"].numpy(), np.asarray(cache_r["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_decode(ref, pair, arch):
    """Two decode steps over a prefilled cache with per-row positions."""
    jnp = ref.jnp
    rmodel, rp, model, p = _layer0(pair, arch)
    cfg = model.cfg
    window = model.kinds[0]["window"]
    k0, v0 = _x(6, 2, SEQ, cfg.num_kv_heads, 64), \
        _x(7, 2, SEQ, cfg.num_kv_heads, 64)
    pos = np.arange(SEQ, dtype=np.int32)
    cache_r = ref.attention.fill_cache_from_prefill(
        ref.attention.init_cache(rmodel.cfg, 2, 40, window, jnp.float32),
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(pos), 2)
    cache = params_from_numpy(to_np(cache_r), "cpu", dtype=None)
    position = np.array([SEQ, SEQ - 3], np.int32)
    for step in range(2):
        x = _x(8 + step, 2, 1, cfg.d_model)
        out_r, cache_r = ref.attention.attn_decode(
            rp["attn"], jnp.asarray(x), jnp.asarray(position), cache_r,
            rmodel.cfg, layer_window=window)
        out, cache = A.attn_decode(p["attn"], torch.tensor(x),
                                   torch.tensor(position), cache, cfg,
                                   layer_window=window)
        close(out, out_r)
        close(cache, cache_r)
        position = position + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks(ref, pair, arch):
    """block_apply / block_prefill / block_decode of every kind in the
    periodic group (gemma2: local then global)."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch)
    cfg = model.cfg
    x = _x(10, 1, SEQ, cfg.d_model)
    pos = np.arange(SEQ, dtype=np.int32)
    layout = T.StackLayout(cfg, model.kinds)
    assert layout.n_groups and (layout.prefix, layout.period) == \
        (0, 2 if arch == "gemma2-2b" else 1)
    for j, kind in enumerate(layout.group_kinds):
        rp = ref_tree_map(lambda t: t[0],
                          rparams["stack"]["scanned"][f"sub_{j}"])
        p = tree_map(lambda t: t[0], params["stack"]["scanned"][f"sub_{j}"])
        y_r, _ = ref.transformer.block_apply(rp, jnp.asarray(x),
                                             jnp.asarray(pos), rmodel.cfg,
                                             kind)
        y, aux = T.block_apply(p, torch.tensor(x), torch.tensor(pos), cfg,
                               kind)
        close(y, y_r)
        assert float(aux) == 0.0
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


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(ref, pair, arch):
    rmodel, rparams, model, _ = pair(arch)
    ours = model.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: tree_map(                 # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)
    assert shapes(ours) == shapes(to_np(rparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(ref, pair, arch):
    rmodel, rparams, model, params = pair(arch)
    toks = _tokens(12, model.cfg, 2, SEQ)
    logits_r, _ = rmodel.forward_logits(rparams,
                                        {"tokens": ref.jnp.asarray(toks)})
    logits, aux = model.forward_logits(params, {"tokens": torch.tensor(toks)})
    assert logits.shape == (2, SEQ, model.vocab) and \
        logits.dtype == torch.float32
    close(logits, logits_r)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps(ref, pair, arch):
    """Prefill a prompt longer than the window into a 40-slot cache, then
    three decode steps: logits and the whole decode state agree."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch)
    toks = _tokens(13, model.cfg, 1, SEQ + 3)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_attend_reaches_every_layer(pair, arch):
    """``Model(cfg, attend=...)`` calls ``attend`` once a layer: by index in
    prefill, by the ring's positions in decode; the plain version given
    as ``attend`` is what the CPU path runs anyway."""
    _, _, model, params = pair(arch)
    calls = []

    def attend(q, k, v, **kw):
        calls.append((kw["q_pos"], kw["k_pos"]))
        return flash_attention_ref(q, k, v, **kw)

    hooked = build_model(model.cfg, attend=attend)
    toks = {"tokens": torch.tensor(_tokens(14, model.cfg, 1, SEQ))}
    logits, st = hooked.prefill(params, toks, cache_len=40)
    assert len(calls) == model.cfg.num_layers
    assert all(qp is None and kp is None for qp, kp in calls)
    want, want_st = model.prefill(params, toks, cache_len=40)
    assert torch.equal(logits, want)
    calls.clear()
    tok = torch.tensor([[3]])
    logits, _ = hooked.decode_step(params, st, tok)
    assert len(calls) == model.cfg.num_layers
    assert all(qp is not None and kp is not None for qp, kp in calls)
    assert torch.equal(logits, model.decode_step(params, want_st, tok)[0])


def test_decode_state_crosses_both_ways(ref, pair):
    rmodel, rparams, model, params = pair("gemma2-2b")
    st_r = rmodel.init_decode_state(2, 40)
    st = params_from_numpy(to_np(st_r), "cpu", dtype=None)
    fresh = model.init_decode_state(2, 40, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), st) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), fresh)
    back = state_to_numpy(st)
    for a, b in zip(tree_leaves(back), _leaves(to_np(st_r)), strict=True):
        assert np.array_equal(a, b)
    bf = params_from_numpy(tree_map(lambda a: np.asarray(
        ref.jnp.asarray(a).astype(ref.jnp.bfloat16)), to_np(rparams)), "cpu",
        dtype=None)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bf))
    np.testing.assert_array_equal(
        params_to_numpy(tree_map(lambda t: t.float(), bf))["final_norm"][
            "scale"], np.ones(model.cfg.d_model, np.float32))


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b"])
def test_decode_state_defaults_to_the_card(arch):
    """Without ``device`` the decode caches go to CUDA, as every other
    entry point of the port does: here, without a card, that raises
    (there is no fallback); ``device="cpu"`` still allocates on the CPU,
    and so does the stack's own cache."""
    model = build_model(reduced_config(arch))
    if torch.cuda.is_available():
        leaves = tree_leaves(model.init_decode_state(2, 16))
        assert all(t.device.type == "cuda" for t in leaves)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init_decode_state(2, 16)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.stack_init_cache(model.cfg, model.kinds, 2, 16, model.dtype)
    leaves = tree_leaves(model.init_decode_state(2, 16, device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    leaves = tree_leaves(T.stack_init_cache(model.cfg, model.kinds, 2, 16,
                                            model.dtype, "cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
ENGINE_CASES = [(arch, (5, 9, 3, 7), 6) for arch in ARCHS] + [
    # prompts past the reduced window: the ring wraps while serving
    ("qwen2-7b-swa", (20, 13, 18), 8), ("gemma2-2b", (20, 13, 18), 8)]


@pytest.mark.parametrize("arch,lengths,n_new", ENGINE_CASES)
def test_engine_greedy_tokens_match_reference(ref, pair, arch, lengths,
                                              n_new):
    rmodel, rparams, model, params = pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in lengths]
    outs = []
    for mod, eng, req, p in ((ref.engine, ref.engine.ServingEngine,
                              ref.engine.Request, rparams),
                             (None, ServingEngine, Request, params)):
        engine = eng(rmodel if mod else model, p, max_batch=2, cache_len=64)
        for i, prompt in enumerate(prompts):
            engine.submit(req(uid=i, prompt=prompt, max_new_tokens=n_new))
        outs.append(engine.run())
        assert engine.stats["done"] == len(prompts)
    assert outs[1] == outs[0]
    assert engine.prefills == len(prompts) and engine.decode_steps >= n_new


def test_engine_stop_token_and_temperature(pair):
    _, _, model, params = pair("qwen1.5-0.5b")
    greedy = ServingEngine(model, params, max_batch=1, cache_len=64)
    greedy.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=6))
    stream = greedy.run()[0]
    stop = ServingEngine(model, params, max_batch=1, cache_len=64)
    stop.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=6,
                        stop_token=stream[2]))
    assert stop.run()[0] == stream[:stream.index(stream[2])]
    runs = []
    for _ in range(2):
        hot = ServingEngine(model, params, max_batch=2, cache_len=64, seed=3)
        for i in range(3):
            hot.submit(Request(uid=i, prompt=[4, 5], max_new_tokens=5,
                               temperature=1.0))
        runs.append(hot.run())
    assert runs[0] == runs[1]
    assert all(0 <= t < model.vocab for v in runs[0].values() for t in v)


def test_serve_step_matches_reference(ref, pair):
    jnp = ref.jnp
    rmodel, rparams, model, params = pair("qwen2-7b")
    step_r = ref.serve.make_serve_step(rmodel)
    step = make_serve_step(model)
    st_r = rmodel.init_decode_state(3, 32)
    st = model.init_decode_state(3, 32, device="cpu")
    tok_r = jnp.zeros((3, 1), jnp.int32)
    tok = torch.zeros((3, 1), dtype=torch.int32)
    for _ in range(5):
        tok_r, st_r = step_r(rparams, st_r, tok_r)
        tok, st = step(params, st, tok)
        assert tok.dtype == torch.int32
        assert np.array_equal(tok.numpy(), np.asarray(tok_r))


def test_serve_cli_runs_on_the_cpu(capsys):
    out = serve_main(["--arch", "gemma2-2b", "--device", "cpu", "--reduced",
                      "--batch", "2", "--steps", "20", "--cache", "32"])
    assert out.shape == (20, 2)
    assert "on cpu" in capsys.readouterr().out
