"""The zoo's configurations chip_smoke.py serves past their windows
(gemma2-2b, qwen1.5-4b and -swa, qwen2-7b-swa, mixtral-8x22b at 13
layers) and the plain versions behind the reference's long input shapes,
against the JAX package.

At full size only the trees are compared (on the meta device, against
``jax.eval_shape`` of the reference's ``Model.init``, and the parameter
counts chip_smoke.py checks on the card).  At the reduced size the
reference initialises each model and its weights cross to the port by key
(``repro_torch.interop``); prompts longer than the reduced window (16) go
into caches larger than it, so every ring wraps in the prefill's fill and
again in decode.  Engine tokens are identical, f32 outputs and decode
states agree within 1e-5 of each output's max (tests/test_torch_lm.py's
rule), and decode equals the port's own forward.  The scans and the
split-K arithmetic are held at the sizes the long shapes give them: over
200 and more chunks, across a chunk boundary, and over a ring at
positions above 2^19.
"""
import math
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import (
    combine_ref, decode_partials_ref, flash_attention_ref, ops)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_chunked_ref
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from test_torch_lm import _leaves, _tokens, close
from test_torch_ssm import _meta_init
from test_torch_support import chip_smoke, reference, to_np

WINDOWED = ["gemma2-2b", "qwen1.5-4b-swa", "qwen2-7b-swa", "mixtral-8x22b"]
CACHE = 64          # slots a sequence: past the reduced window of 16


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.fixture(scope="module")
def pair(ref):
    """arch -> (reference model, its params, port model, port params)."""
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


# ---------------------------------------------------------------------------
# the full-size trees chip_smoke.py serves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,layers", [
    ("gemma2-2b", None), ("qwen1.5-4b", None), ("qwen2-7b-swa", None),
    ("mixtral-8x22b", 13)])
def test_full_size_tree_is_the_reference_tree(ref, name, layers):
    """The port's tree at full width (mixtral at chip_smoke.py's 13 of 56
    layers) has the reference's leaves, shapes and dtypes, and the
    parameter count chip_smoke.py holds the card's tree to."""
    cfg, theirs_cfg = get_config(name), ref.configs.get_config(name)
    if layers:
        cfg, theirs_cfg = (c.replace(num_layers=layers)
                           for c in (cfg, theirs_cfg))
    ours = _meta_init(build_model(cfg))
    theirs = ref.jax.eval_shape(ref.lm.build_model(theirs_cfg).init,
                                ref.jax.random.PRNGKey(0))
    shapes = [(tuple(a.shape), str(a.dtype).split(".")[-1])
              for a in _leaves(ours)]
    assert shapes == [(tuple(a.shape), str(a.dtype))
                      for a in _leaves(theirs)]
    count = sum(math.prod(t.shape) for t in _leaves(ours))
    assert count == sum(math.prod(a.shape) for a in _leaves(theirs))
    assert count == chip_smoke().SERVED_PARAMS[cfg.name, cfg.num_layers]


def test_mixtral_depth_is_the_most_that_fits():
    """chip_smoke.py's cut: 13 layers of bf16 weights (65.9 GB) leave
    room on an 80 GB card; 14 (70.9 GB) do not leave the phase's peak
    under 76 GB beside the rings, the prefill and the plain checks."""
    cs = chip_smoke()
    cfg = get_config("mixtral-8x22b")
    outer = 2 * cfg.vocab_size * cfg.d_model + cfg.d_model  # untied, norm
    per_layer = (cs.SERVED_PARAMS["mixtral-8x22b", 13] - outer) / 13
    assert cs.MIXTRAL_LAYERS == 13
    assert per_layer == 2_504_060_928
    assert cs.SERVED_PARAMS["mixtral-8x22b", 13] * 2 < 66e9
    assert (cs.SERVED_PARAMS["mixtral-8x22b", 13] + per_layer) * 2 > 70e9


# ---------------------------------------------------------------------------
# reduced, served past the window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", WINDOWED)
def test_engine_past_the_window_matches_reference(ref, pair, arch):
    """Prompts of 17-40 tokens and 12 new ones on 2 slots of 64: every
    ring (16 slots) wraps in the prefill's fill and in decode, and the
    greedy tokens are the reference engine's."""
    rmodel, rparams, model, params = pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in (40, 17, 29, 33)]
    assert min(map(len, prompts)) > model.cfg.window_size
    outs = []
    for eng, req, m, p in ((ref.engine.ServingEngine, ref.engine.Request,
                            rmodel, rparams),
                           (ServingEngine, Request, model, params)):
        engine = eng(m, p, max_batch=2, cache_len=CACHE)
        for i, prompt in enumerate(prompts):
            engine.submit(req(uid=i, prompt=prompt, max_new_tokens=12))
        outs.append(engine.run())
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", WINDOWED)
def test_prefill_and_decode_past_the_window_match_reference(ref, pair,
                                                            arch):
    """A 30-token prompt into a 64-slot cache (the rings keep the last 16
    positions), then 10 decode steps: logits and the whole decode state
    agree with the reference's within 1e-5."""
    jnp = ref.jnp
    rmodel, rparams, model, params = pair(arch)
    toks = _tokens(21, model.cfg, 1, 40)
    logits_r, st_r = rmodel.prefill(
        rparams, {"tokens": jnp.asarray(toks[:, :30])}, cache_len=CACHE)
    logits, st = model.prefill(params, {"tokens": torch.tensor(
        toks[:, :30])}, cache_len=CACHE)
    close({"logits": logits, "state": st},
          {"logits": logits_r, "state": st_r})
    for i in range(30, 40):
        tok = toks[:, i:i + 1]
        logits_r, st_r = rmodel.decode_step(rparams, st_r, jnp.asarray(tok))
        logits, st = model.decode_step(params, st, torch.tensor(tok))
        close({"logits": logits, "state": st},
              {"logits": logits_r, "state": st_r})


@pytest.mark.parametrize("arch", WINDOWED)
def test_decode_equals_forward_past_the_window(pair, arch):
    """chip_smoke.py's decode-vs-forward check at the reduced size: each
    decode step's logits after a prefill past the window equal the last
    logits of a prefill of the prompt and the tokens so far (float32,
    within 1e-5); its planted fault, every ring holding one ring's
    earlier positions, moves them far off."""
    cs = chip_smoke()
    _, _, model, params = pair(arch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "DEVICE", "cpu")
        mp.setattr(cs, "ZOO_DECODE_CHECKS", (0, 4, 9))
        prompt = _tokens(22, model.cfg, 30).tolist()
        generated = _tokens(23, model.cfg, 10).tolist()
        got = cs._decode_vs_forward(model, params, prompt, generated, CACHE)
    assert max(got["logits_rel_l2"]) <= 1e-5, got
    assert all(got["same_top1"]), got
    assert min(got["fault_logits_rel_l2"]) > cs.CARRY_LOGIT_RTOL, got


@pytest.mark.parametrize("arch", WINDOWED)
def test_rings_after_a_prefill_past_the_window(pair, arch):
    """What decode reads after the prefill's fill: every windowed layer's
    ring holds exactly the last 16 positions (``slot = pos % 16``), a
    global layer (gemma2's odd layers) every position; ``_stale_rings``
    moves every ring's keys out of its window."""
    cs = chip_smoke()
    _, _, model, params = pair(arch)
    S, w = 30, model.cfg.window_size
    _, st = model.prefill(params, {"tokens": torch.tensor(
        _tokens(24, model.cfg, 1, S))}, cache_len=CACHE)
    rings = cs._rings(st, CACHE)
    assert rings
    for c in rings:
        pos = c["pos"].reshape(-1, w)
        want = torch.arange(S - w, S, dtype=torch.int32)
        assert all(torch.equal(p.sort().values, want) for p in pos)
        assert all(torch.equal(p.long() % w, torch.arange(w)) for p in pos)
    if arch == "gemma2-2b":
        full = [c for c in cs._rings(st, math.inf)
                if not any(c is r for r in rings)]
        assert full and all(int(c["pos"].max()) == S - 1 and
                            int((c["pos"] >= 0).sum(-1).min()) == S
                            for c in full)
    cs._stale_rings(st, CACHE)
    for c in rings:
        assert bool((S - c["pos"][c["pos"] >= 0] > w).all())


def test_window_cuts_shorten_the_layer_window():
    """The planted window faults: a windowed call's own window less 1 or
    32 keys, a call without one the rows less 1 or 32."""
    cs = chip_smoke()
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        FA = sys.modules["repro_torch.kernels.flash_attention"]
        mp.setattr(FA, "flash_attention",
                   lambda q, k, v, **kw: seen.append(kw["window"]))
        cuts = cs._window_cuts(100)
        for name in ("one_key", "one_tile"):
            fn = cuts[name][0]
            fn(None, None, None, window=16)
            fn(None, None, None, window=None)
    assert seen == [15, 99, -16, 68]


def test_row_slices_reach_every_key_their_mask_sees():
    """The long shapes' checked rows: the first and last 256 query rows,
    each with the first key its causal (and windowed) mask reaches."""
    cs = chip_smoke()
    assert cs._row_slices(32768, None) == [(0, 256, 0), (32512, 32768, 0)]
    assert cs._row_slices(524288, 4096) == [(0, 256, 0),
                                            (524032, 524288, 519937)]


# ---------------------------------------------------------------------------
# the plain versions at the long shapes' sizes
# ---------------------------------------------------------------------------
def _rwkv(seed, T, H=2, hd=64):
    """r, k, v, w [1, T, H, hd] and u [H, hd] as
    tests/test_torch_rwkv6_scan.py draws them: w in (0.45, 0.95)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((1, T, H, hd), np.float32)
    k = rng.standard_normal((1, T, H, hd), np.float32) * 0.3
    v = rng.standard_normal((1, T, H, hd), np.float32)
    w = 1 / (1 + np.exp(-rng.standard_normal((1, T, H, hd), np.float32)))
    w = (w * 0.5 + 0.45).astype(np.float32)
    u = rng.standard_normal((H, hd), np.float32) * 0.2
    return [torch.tensor(x) for x in (r, k, v, w)], torch.tensor(u)


def _scan_close(ours, theirs, tol=2e-5):
    scale = max(1.0, float(theirs.abs().max()))
    assert float((ours - theirs).abs().max()) <= tol * scale


def test_rwkv6_chunked_route_over_200_chunks():
    """The chunked route's algorithm (``rwkv6_scan_chunked_ref``) over
    201 chunks of 64 and a tail of 17 steps against the plain scan,
    output and final state (float32 in another order: 2e-5)."""
    T = 201 * 64 + 17
    (r, k, v, w), u = _rwkv(0, T)
    o, s = rwkv6_scan_chunked_ref(r, k, v, w, u, chunk=64)
    o_p, s_p = rwkv6_scan_ref(r, k, v, w, u)
    _scan_close(o, o_p)
    _scan_close(s, s_p)


def test_rwkv6_state_carried_across_a_chunk_boundary():
    """chip_smoke.py's long_500k window check at the reduced size: the
    chunked route over the first 200 chunks, its state at that boundary
    carried into the last 64 chunks, is bitwise the route over all 264
    chunks there; the plain scan from that state agrees within 2e-5;
    from a dropped (zero) state it does not."""
    T, t0 = 264 * 64, 200 * 64
    (r, k, v, w), u = _rwkv(1, T)
    o, s = rwkv6_scan_chunked_ref(r, k, v, w, u, chunk=64)
    _, s0 = rwkv6_scan_chunked_ref(*(x[:, :t0] for x in (r, k, v, w)), u,
                                   chunk=64)
    tail = [x[:, t0:] for x in (r, k, v, w)]
    o1, s1 = rwkv6_scan_chunked_ref(*tail, u, s0, chunk=64)
    assert torch.equal(o1, o[:, t0:]) and torch.equal(s1, s)
    o_p, s_p = rwkv6_scan_ref(*tail, u, s0)
    _scan_close(o[:, t0:], o_p)
    _scan_close(s, s_p)
    o_z, _ = rwkv6_scan_chunked_ref(*tail, u, chunk=64)
    assert float((o_z - o_p).abs().max()) > 1.0


def test_num_splits_at_the_long_caches():
    """decode_32k's 32,800 slots are 129 splits of 256 (32,768 are 128);
    long_500k's 4,096-slot ring 16; a function of Skv alone."""
    assert ops.num_splits(32_768) == 128
    assert ops.num_splits(32_800) == 129
    assert ops.num_splits(4096) == 16
    assert ops.route(1, 7, 128, torch.bfloat16) == "split_k_wgmma"
    assert ops.route(32_768, 7, 128, torch.bfloat16) == "wgmma"
    assert ops.route(5731, 2, 256, torch.bfloat16) == "wgmma"


def _ring_at(B, size, last):
    """Ring positions after decoding up to ``last[b]`` inclusive: slot s
    holds the newest p <= last[b] with p % size == s."""
    kpos = torch.full((B, size), -1, dtype=torch.int32)
    for b, n in enumerate(last):
        p = torch.arange(max(0, n + 1 - size), n + 1, dtype=torch.int32)
        kpos[b, (p % size).long()] = p
    return kpos


@pytest.mark.parametrize("window", [None, 4096])
def test_split_k_over_a_ring_past_2_19(window):
    """The split-K arithmetic (partials a split of 256 slots, then the
    combine) over a 4,096-slot ring whose positions lie above 2^19, as
    long_500k's decode reads it, against the plain version (float32 in
    another order: 1e-5 absolute and relative)."""
    rng = np.random.default_rng(5)
    B, H, KV, size, hd = 2, 4, 2, 4096, 64
    q, k, v = (torch.tensor(rng.standard_normal(s, np.float32))
               for s in ((B, H, 1, hd), (B, KV, size, hd),
                         (B, KV, size, hd)))
    last = [524_288 + 4127, 524_288 + 40_000]
    pos = {"q_pos": torch.tensor(last, dtype=torch.int32)[:, None],
           "k_pos": _ring_at(B, size, last)}
    assert int(pos["k_pos"].min()) > 2 ** 19
    m, l, o = decode_partials_ref(q, k, v, n_splits=ops.num_splits(size),
                                  window=window, **pos)
    want = flash_attention_ref(q, k, v, window=window, **pos)
    got = combine_ref(m, l, o)
    assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
