"""The port's vlm and audio families against the JAX package's: configs,
bidirectional and cross attention, blocks with an encoder memory, the
encoder, the model's forward / prefill / decode with image rows
(llava-next-34b) and frames (seamless-m4t-medium), and the serving
engine, at the reduced configs.

The reference initialises each reduced model; its weights cross to the
port by key (``repro_torch.interop``, the ``encoder`` subtree included),
inputs are made with numpy from a seed, and both packages run them on
the CPU in float32.  Outputs, decode states and the encoder memory agree
within 1e-5 of each output's max (float32 in another summation order, as
tests/test_torch_lm.py), and greedy tokens are identical.  The kernel on
the card is held to its plain version at these families' shapes in
chip_smoke.py.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_map
from test_torch_lm import _leaves, _tokens, _x, close, ref_tree_map
from test_torch_ssm import _meta_init
from test_torch_support import reference, to_np

VLM, AUDIO = "llava-next-34b", "seamless-m4t-medium"
ARCHS = [VLM, AUDIO]
SEQ = 12


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


def _prefix(seed, cfg, B=1):
    """Image rows (vlm) or frames (audio), [B, P, D], from a seed."""
    return _x(seed, B, cfg.num_prefix_embeddings, cfg.d_model)


def _batches(ref, cfg, toks, prefix):
    """The same batch for both packages: tokens and the prefix."""
    ours = {"tokens": torch.tensor(toks), "prefix_emb": torch.tensor(prefix)}
    theirs = {"tokens": ref.jnp.asarray(toks),
              "prefix_emb": ref.jnp.asarray(prefix)}
    return ours, theirs


def _sub(tree, j, port):
    sub = tree["scanned"][f"sub_{j}"]
    return tree_map(lambda t: t[0], sub) if port else \
        ref_tree_map(lambda t: t[0], sub)


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


def test_reduced_configs_keep_the_family_shapes():
    vlm, audio = reduced_config(VLM), reduced_config(AUDIO)
    assert (vlm.modality, vlm.num_prefix_embeddings) == ("vision_text", 8)
    assert (audio.num_encoder_layers, audio.num_prefix_embeddings) == (2, 16)
    assert audio.num_heads == audio.num_kv_heads == 4      # still MHA


@pytest.mark.parametrize("name,count", [(VLM, 34_388_917_248),
                                        (AUDIO, 877_260_800)])
def test_full_size_tree_is_the_reference_tree(ref, name, count):
    """The served sizes at full width and depth: the port's tree (the
    encoder and the cross attention included) has the reference's
    leaves, shapes and dtypes, and chip_smoke.py's parameter count."""
    ours = _meta_init(build_model(get_config(name)))
    theirs = ref.jax.eval_shape(
        ref.lm.build_model(ref.configs.get_config(name)).init,
        ref.jax.random.PRNGKey(0))
    shapes = lambda tree: [                        # noqa: E731
        (tuple(a.shape), str(a.dtype).split(".")[-1])
        for a in _leaves(tree)]
    assert shapes(ours) == [(tuple(a.shape), str(a.dtype))
                            for a in _leaves(theirs)]
    assert sum(math.prod(t.shape) for t in _leaves(ours)) == count


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(pair, arch):
    _, rparams, model, _ = pair(arch)
    ours = model.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: tree_map(                 # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)
    assert shapes(ours) == shapes(to_np(rparams))
    if arch == AUDIO:
        assert set(ours["encoder"]) == {"stack", "final_norm"}
        assert {"cross", "cross_norm"} <= set(
            ours["stack"]["scanned"]["sub_0"])
    assert model.kinds[0]["cross"] == (arch == AUDIO)
    assert [k["causal"] for k in model.enc_kinds] == \
        [False] * model.cfg.num_encoder_layers


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq", [1, 5, SEQ])
def test_attn_apply_cross(ref, pair, Sq):
    """kv_override: keys and values from the encoder memory (Skv = 16
    frames, not the queries' length), no RoPE, every key visible."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(AUDIO)
    cfg = model.cfg
    rp = _sub(rparams["stack"], 0, False)["cross"]
    p = _sub(params["stack"], 0, True)["cross"]
    x = _x(20, 2, Sq, cfg.d_model)
    enc = _prefix(21, cfg, B=2)
    pos = np.arange(Sq, dtype=np.int32) + 3
    theirs = ref.attention.attn_apply(
        rp, jnp.asarray(x), jnp.asarray(pos), rmodel.cfg, causal=False,
        kv_override=jnp.asarray(enc))
    ours = A.attn_apply(p, torch.tensor(x), torch.tensor(pos), cfg,
                        causal=False, kv_override=torch.tensor(enc))
    assert ours.shape == (2, Sq, cfg.d_model)
    close(ours, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_apply_bidirectional(ref, pair, arch):
    """causal=False with RoPE: the encoder's self-attention (seamless)
    and a decoder layer's weights run bidirectionally (llava)."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch)
    cfg = model.cfg
    tree = (rparams["encoder"]["stack"], params["encoder"]["stack"]) \
        if arch == AUDIO else (rparams["stack"], params["stack"])
    rp, p = _sub(tree[0], 0, False)["attn"], _sub(tree[1], 0, True)["attn"]
    x = _x(22, 2, SEQ, cfg.d_model)
    pos = np.arange(SEQ, dtype=np.int32)
    theirs = ref.attention.attn_apply(rp, jnp.asarray(x), jnp.asarray(pos),
                                      rmodel.cfg, causal=False)
    ours = A.attn_apply(p, torch.tensor(x), torch.tensor(pos), cfg,
                        causal=False)
    close(ours, theirs)
    causal = A.attn_apply(p, torch.tensor(x), torch.tensor(pos), cfg)
    assert not torch.allclose(causal[:, :-1], ours[:, :-1])


# ---------------------------------------------------------------------------
# blocks, encoder
# ---------------------------------------------------------------------------
def test_blocks_with_enc(ref, pair):
    """block_apply / block_prefill / block_decode of the decoder's cross
    kind with an encoder memory, and of the encoder's kind (causal
    False); without ``enc`` the cross kind skips its cross attention,
    as the reference does."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(AUDIO)
    cfg = model.cfg
    x = _x(23, 1, SEQ, cfg.d_model)
    enc = _prefix(24, cfg)
    pos = np.arange(SEQ, dtype=np.int32)
    kind = model.kinds[0]
    rp, p = _sub(rparams["stack"], 0, False), _sub(params["stack"], 0, True)
    for e_r, e in ((jnp.asarray(enc), torch.tensor(enc)), (None, None)):
        y_r, _ = ref.transformer.block_apply(rp, jnp.asarray(x),
                                             jnp.asarray(pos), rmodel.cfg,
                                             kind, e_r)
        y, aux = T.block_apply(p, torch.tensor(x), torch.tensor(pos), cfg,
                               kind, enc=e)
        close(y, y_r)
        assert float(aux) == 0.0
    y_r, c_r = ref.transformer.block_prefill(
        rp, jnp.asarray(x), jnp.asarray(pos), rmodel.cfg, kind, 1, 40,
        jnp.float32, jnp.asarray(enc))
    y, c = T.block_prefill(p, torch.tensor(x), torch.tensor(pos), cfg, kind,
                           1, 40, torch.float32, enc=torch.tensor(enc))
    close({"y": y, "c": c}, {"y": y_r, "c": c_r})
    xd = _x(25, 1, 1, cfg.d_model)
    position = np.array([SEQ], np.int32)
    y_r, c_r = ref.transformer.block_decode(
        rp, jnp.asarray(xd), jnp.asarray(position), rmodel.cfg, kind, c_r,
        jnp.asarray(enc))
    y, c = T.block_decode(p, torch.tensor(xd), torch.tensor(position), cfg,
                          kind, c, enc=torch.tensor(enc))
    close({"y": y, "c": c}, {"y": y_r, "c": c_r})

    ekind = model.enc_kinds[0]
    rp = _sub(rparams["encoder"]["stack"], 0, False)
    p = _sub(params["encoder"]["stack"], 0, True)
    y_r, _ = ref.transformer.block_apply(rp, jnp.asarray(x), jnp.asarray(pos),
                                         rmodel.cfg, ekind)
    y, _ = T.block_apply(p, torch.tensor(x), torch.tensor(pos), cfg, ekind)
    close(y, y_r)


def test_encode(ref, pair):
    rmodel, rparams, model, params = pair(AUDIO)
    frames = _prefix(26, model.cfg, B=2)
    theirs = rmodel._encode(rparams, ref.jnp.asarray(frames))
    ours = model._encode(params, torch.tensor(frames))
    assert ours.shape == frames.shape and ours.dtype == torch.float32
    close(ours, theirs)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(ref, pair, arch):
    """Logits at the text positions only: after the image rows (vlm),
    over the encoder's memory of the frames (audio)."""
    rmodel, rparams, model, params = pair(arch)
    cfg = model.cfg
    ours, theirs = _batches(ref, cfg, _tokens(27, cfg, 2, SEQ),
                            _prefix(28, cfg, B=2))
    logits_r, _ = rmodel.forward_logits(rparams, theirs)
    logits, _ = model.forward_logits(params, ours)
    assert logits.shape == (2, SEQ, model.vocab)
    close(logits, logits_r)
    if arch == VLM:
        # the image rows reach the text's logits
        other = dict(ours, prefix_emb=ours["prefix_emb"] + 1.0)
        assert not torch.allclose(model.forward_logits(params, other)[0],
                                  logits)
        # without a prefix the vlm is a text decoder
        bare_r, _ = rmodel.forward_logits(rparams,
                                          {"tokens": theirs["tokens"]})
        close(model.forward_logits(params, {"tokens": ours["tokens"]})[0],
              bare_r)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps(ref, pair, arch):
    """Prefill into a 40-slot cache, then three decode steps: logits and
    the whole decode state (``enc`` included) agree."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch)
    cfg = model.cfg
    toks = _tokens(29, cfg, 1, SEQ + 3)
    ours, theirs = _batches(ref, cfg, toks[:, :SEQ], _prefix(30, cfg))
    logits_r, st_r = rmodel.prefill(rparams, theirs, cache_len=40)
    logits, st = model.prefill(params, ours, cache_len=40)
    assert ("enc" in st) == (arch == AUDIO) == ("enc" in st_r)
    rows = SEQ + (cfg.num_prefix_embeddings if arch == VLM else 0)
    assert int(st["position"][0]) == rows
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
def test_decode_equals_forward(pair, arch):
    """Token-by-token decode reproduces the forward logits, as the
    reference's tests/test_decode_consistency.py holds it: seamless from
    init_decode_state with ``enc`` set to the encoder's memory; llava
    after a prefill of its image rows and the first token."""
    _, _, model, params = pair(arch)
    cfg = model.cfg
    B = 2
    toks = torch.tensor(_tokens(31, cfg, B, SEQ))
    prefix = torch.tensor(_prefix(32, cfg, B=B))
    full, _ = model.forward_logits(params, {"tokens": toks,
                                            "prefix_emb": prefix})
    if arch == AUDIO:
        state = model.init_decode_state(B, SEQ, device="cpu")
        state["enc"] = model._encode(params, prefix)
        steps = []
        first = 0
    else:
        lg, state = model.prefill(
            params, {"tokens": toks[:, :1], "prefix_emb": prefix},
            cache_len=cfg.num_prefix_embeddings + SEQ)
        steps = [lg[:, 0]]
        first = 1
    for t in range(first, SEQ):
        lg, state = model.decode_step(params, state, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    close(torch.stack(steps, 1), full.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_attend_reaches_every_attention(pair, arch):
    """``attend`` is called by every attention: llava's 2 decoder layers
    a call; seamless's 2 encoder, 2 self and 2 cross attentions a
    prefill (non-causal over the 16 frames) and 2 + 2 a decode step (so
    chip_smoke.py counts 36 and 24 launches at full depth)."""
    _, _, model, params = pair(arch)
    cfg = model.cfg
    calls = []

    def attend(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[2], k.shape[2]))
        return flash_attention_ref(q, k, v, **kw)

    hooked = build_model(cfg, attend=attend)
    batch = {"tokens": torch.tensor(_tokens(33, cfg, 1, 5)),
             "prefix_emb": torch.tensor(_prefix(34, cfg))}
    logits, st = hooked.prefill(params, batch, cache_len=40)
    P, L = cfg.num_prefix_embeddings, cfg.num_layers
    if arch == VLM:
        assert calls == [(True, P + 5, P + 5)] * L
    else:
        assert calls == [(False, P, P)] * cfg.num_encoder_layers + \
            [(True, 5, 5), (False, 5, P)] * L
    want, want_st = model.prefill(params, batch, cache_len=40)
    assert torch.equal(logits, want)
    calls.clear()
    tok = torch.tensor([[3]])
    logits, _ = hooked.decode_step(params, st, tok)
    assert calls == ([(True, 1, 40)] * L if arch == VLM else
                     [(True, 1, 40), (False, 1, P)] * L)
    assert torch.equal(logits, model.decode_step(params, want_st, tok)[0])


def test_decode_state_has_a_zero_encoder_memory(ref, pair):
    rmodel, _, model, _ = pair(AUDIO)
    st = model.init_decode_state(3, 20, device="cpu")
    st_r = rmodel.init_decode_state(3, 20)
    assert st["enc"].shape == st_r["enc"].shape == (
        3, model.cfg.num_prefix_embeddings, model.cfg.d_model)
    assert not st["enc"].any() and st["enc"].dtype == model.dtype
    assert "enc" not in pair(VLM)[2].init_decode_state(3, 20, device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _biased(ref, pair):
    """The reduced seamless with a random bias on the encoder's final
    norm, in both packages: the engine's zero frames then make a nonzero
    memory (with the init's zero biases it is exactly 0, and every cross
    attention over it gives 0), so each slot's ``enc`` matters."""
    rmodel, rparams, model, params = pair(AUDIO)
    bias = _x(35, model.cfg.d_model)
    rparams = dict(rparams, encoder=dict(
        rparams["encoder"], final_norm=dict(
            rparams["encoder"]["final_norm"], bias=ref.jnp.asarray(bias))))
    params = dict(params, encoder=dict(
        params["encoder"], final_norm=dict(
            params["encoder"]["final_norm"], bias=torch.tensor(bias))))
    return rmodel, rparams, model, params


@pytest.mark.parametrize("arch,lengths,n_new", [
    (VLM, (5, 9, 3, 7), 6), (VLM, (20, 13, 18), 8),
    (AUDIO, (5, 9, 3, 7), 6), (AUDIO, (2, 16, 11), 10)])
def test_engine_greedy_tokens_match_reference(ref, pair, arch, lengths,
                                              n_new):
    """Greedy tokens of both engines over the same prompts, more than the
    2 slots (so slots refill), each with the engine's zero prefix."""
    rmodel, rparams, model, params = \
        _biased(ref, pair) if arch == AUDIO else pair(arch)
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
    if arch == AUDIO:
        # every slot's memory: the encoder of zero frames, not zero
        zero = model._encode(params, torch.zeros(
            1, model.cfg.num_prefix_embeddings, model.cfg.d_model))
        assert zero.abs().min() > 0
        assert all(torch.equal(engine.state["enc"][i], zero[0])
                   for i in range(2))


def test_vlm_request_overflowing_the_cache_is_refused(ref, pair):
    """The documented difference: a vlm request's image rows take cache
    slots.  The reference's ``submit`` counts only the prompt and the new
    tokens, so it accepts a request whose rows overflow ``cache_len``,
    and its prefill keeps only the last ``cache_len`` positions: image
    rows are dropped.  The port's ``submit`` counts the image rows and
    refuses such a request; one that fits is accepted."""
    rmodel, rparams, model, params = pair(VLM)
    P = model.cfg.num_prefix_embeddings
    cache_len, prompt, n_new = 16, list(range(1, 11)), 4   # 10 + 4 <= 16
    assert len(prompt) + n_new <= cache_len < P + len(prompt) + n_new
    rengine = ref.engine.ServingEngine(rmodel, rparams, max_batch=1,
                                       cache_len=cache_len)
    rengine.submit(ref.engine.Request(uid=0, prompt=prompt,
                                      max_new_tokens=n_new))
    batch = {"tokens": ref.jnp.asarray([prompt], ref.jnp.int32),
             "prefix_emb": ref.jnp.zeros((1, P, model.cfg.d_model))}
    _, st = rmodel.prefill(rparams, batch, cache_len=cache_len)
    kept = np.asarray(st["cache"]["scanned"]["sub_0"]["attn"]["pos"])
    assert kept.min() == P + len(prompt) - cache_len > 0    # rows 0.. gone
    engine = ServingEngine(model, params, max_batch=1, cache_len=cache_len)
    with pytest.raises(ValueError, match=f"after {P} image rows"):
        engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=n_new))
    engine.submit(Request(uid=1, prompt=prompt[:4], max_new_tokens=n_new))
    assert len(engine.run()[1]) == n_new


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(capsys, arch):
    out = serve_main(["--arch", arch, "--device", "cpu", "--reduced",
                      "--batch", "2", "--steps", "6", "--cache", "32"])
    assert out.shape == (6, 2)
    assert "on cpu" in capsys.readouterr().out
