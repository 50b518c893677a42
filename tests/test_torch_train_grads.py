"""The port's LM loss and its gradients against the JAX package's, and
the four LM kernels' autograd Functions.

``Model.loss`` and every gradient leaf against ``jax.value_and_grad``
of the reference's ``Model.loss`` from the same weights (carried across
by ``repro_torch.interop``), for the eight reduced archs, in float32 on
the CPU, over a batch with masked (-1) labels: the loss, ``ce`` and
``aux`` within 1e-6 of their value and every gradient leaf within 5e-5
of its largest |entry| (float32 in another summation order: the worst
leaf reads 1.0e-5, rwkv6's).  Remat on and off give bitwise equal
gradients.

Each Function's forward is the kernel, which the CPU cannot run; here
it is swapped for the plain version (the module's launcher patched), so
that ``torch.autograd.gradcheck`` in float64 at tiny shapes checks the
backward code the card runs.  The kernels' forwards are held to the
plain versions in the kernel test files and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan_fused
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan import mamba_scan_fused_ref
from repro_torch.kernels.moe_router import moe_router
from repro_torch.kernels.moe_router import ops as router_ops
from repro_torch.kernels.moe_router import moe_router_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import reference, to_np

ARCHS = ["qwen1.5-0.5b", "deepseek-moe-16b", "rwkv6-1.6b", "jamba-v0.1-52b",
         "llava-next-34b", "seamless-m4t-medium", "gemma2-2b",
         "mixtral-8x22b"]
LOSS_RTOL = 1e-6
GRAD_RTOL = 5e-5


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def lm_batch(cfg, seed=0, B=2, S=16):
    """Tokens and labels (numpy seed), some labels masked with -1, and
    the vlm / audio families' ``prefix_emb`` rows."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][0, :3] = -1
    batch["labels"][-1, -2:] = -1
    if cfg.modality != "text" or cfg.is_encoder_decoder:
        batch["prefix_emb"] = rng.standard_normal(
            (B, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return batch


def port_grads(model, params, batch):
    """(loss, metrics, gradient leaves in leaf order) of ``Model.loss``."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, met = model.loss(live, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    return loss, met, [torch.zeros_like(p) if g is None else g
                       for g, p in zip(grads, tree_leaves(live))]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(ref, arch):
    jax = ref.jax
    rcfg = ref.reduced.reduced_config(arch)
    rmodel = ref.lm.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = reduced_config(arch)
    batch = lm_batch(cfg)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(rparams, {
            k: jax.numpy.asarray(v) for k, v in batch.items()})

    model = build_model(cfg)
    params = params_from_numpy(to_np(rparams), "cpu", dtype=None)
    loss, met, grads = port_grads(model, params, batch)
    for ours, theirs in ((loss, rloss), (met["ce"], rmet["ce"]),
                         (met["aux"], rmet["aux"])):
        theirs = float(theirs)
        assert abs(float(ours.detach()) - theirs) <= \
            LOSS_RTOL * max(abs(theirs), 1.0)
    assert float(met["tokens"]) == float(rmet["tokens"]) == 27.0
    if cfg.num_experts:
        assert float(met["aux"]) > 0
    theirs = _leaves(to_np(rgrads))
    assert len(grads) == len(theirs)
    for g, t in zip(grads, theirs):
        t = np.asarray(t, np.float32)
        assert g.shape == t.shape
        err = float(np.abs(g.numpy() - t).max())
        assert err <= GRAD_RTOL * max(float(np.abs(t).max()), 1e-30), err
    # the kernels' inputs get gradients: the attention projections, the
    # router, the scans' inputs
    named = dict(zip(_paths(params), grads))
    for key in ("wq", "router", "wr", "x_proj"):
        hit = [g for p, g in named.items() if key in p]
        assert all(float(g.abs().max()) > 0 for g in hit), key


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


@pytest.mark.parametrize("arch,policy", [
    ("qwen1.5-0.5b", ""), ("jamba-v0.1-52b", ""),
    ("seamless-m4t-medium", ""), ("deepseek-moe-16b", "save_mixer_ffn"),
    ("rwkv6-1.6b", "save_mixer_ffn")])
def test_remat_gradients_bitwise(arch, policy):
    """Remat changes memory, not values: the loss and every gradient
    with ``remat=True`` (each policy) bitwise those without."""
    cfg = reduced_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = lm_batch(cfg, seed=1)
    off = port_grads(build_model(cfg), params, batch)
    on = port_grads(build_model(cfg.replace(remat=True,
                                            remat_policy=policy)),
                    params, batch)
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in zip(off[2], on[2]))


def test_remat_policy_unknown_is_refused():
    cfg = reduced_config("qwen1.5-0.5b", remat=True, remat_policy="dots")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat_policy"):
        port_grads(model, params, lm_batch(cfg))


def test_forward_keeps_no_graph_in_serving():
    """prefill and decode build no graph, even from weights that
    require grad; forward_logits does."""
    cfg = reduced_config("qwen1.5-0.5b")
    model = build_model(cfg)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(torch.Generator().manual_seed(0)))
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    logits, state = model.prefill(params, {"tokens": tokens}, cache_len=8)
    assert logits.grad_fn is None
    assert all(t.grad_fn is None for t in tree_leaves(state["cache"]))
    logits, _ = model.decode_step(params, state, tokens[:, :1])
    assert logits.grad_fn is None
    assert model.forward_logits(params, {"tokens": tokens})[0].grad_fn \
        is not None


# ---------------------------------------------------------------------------
# the Functions, forward swapped for the plain version
# ---------------------------------------------------------------------------
def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale
                            ).requires_grad_()


@pytest.mark.parametrize("case", [
    dict(Sq=5, Skv=5, H=2, KV=1, causal=True),
    dict(Sq=3, Skv=6, H=2, KV=2, causal=False),
    dict(Sq=6, Skv=6, H=4, KV=2, causal=True, window=3, softcap=2.0),
    dict(Sq=1, Skv=6, H=2, KV=1, causal=True, positions=True)])
def test_flash_attention_function_gradcheck(monkeypatch, case):
    monkeypatch.setattr(flash_ops, "_launch", lambda q, k, v, causal, window,
                        softcap, scale, q_pos, k_pos: flash_attention_ref(
                            q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale, q_pos=q_pos,
                            k_pos=k_pos))
    rng = np.random.default_rng(0)
    B, hd = 2, 4
    q = _f64(rng, B, case["H"], case["Sq"], hd)
    k = _f64(rng, B, case["KV"], case["Skv"], hd)
    v = _f64(rng, B, case["KV"], case["Skv"], hd)
    q_pos = k_pos = None
    if case.get("positions"):
        q_pos = torch.tensor([[5], [3]], dtype=torch.int32)
        k_pos = torch.tensor([[0, 1, 2, 3, 4, 5], [0, 1, 2, 3, -1, -1]],
                             dtype=torch.int32)
    args = (case["causal"], case.get("window"), case.get("softcap", 0.0),
            0.5, q_pos, k_pos)

    def fn(q, k, v):
        return flash_ops.FlashAttentionFunction.apply(q, k, v, *args)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    # the Function's gradient is the plain version's
    g = torch.from_numpy(rng.standard_normal(q.shape))
    ours = torch.autograd.grad(fn(q, k, v), (q, k, v), g)
    plain = torch.autograd.grad(flash_attention_ref(
        q, k, v, causal=args[0], window=args[1], softcap=args[2],
        scale=0.5, q_pos=q_pos, k_pos=k_pos), (q, k, v), g)
    assert all(torch.equal(a, b) for a, b in zip(ours, plain))


def test_flash_attention_function_wrong_mask_differs(monkeypatch):
    """A backward that recomputes with another mask (a planted fault of
    chip_smoke.py) gives another gradient."""
    monkeypatch.setattr(flash_ops, "_launch", lambda q, k, v, *a:
                        flash_attention_ref(q, k, v, causal=True))

    class NonCausal(flash_ops.FlashAttentionFunction):
        @staticmethod
        def plain(q, k, v, **kw):
            return flash_attention_ref(q, k, v, **{**kw, "causal": False})
    rng = np.random.default_rng(1)
    q, k, v = (_f64(rng, 1, 2, 5, 4) for _ in range(3))
    args = (True, None, 0.0, 0.5, None, None)
    good = torch.autograd.grad(flash_ops.FlashAttentionFunction.apply(
        q, k, v, *args).sum(), q)[0]
    bad = torch.autograd.grad(NonCausal.apply(q, k, v, *args).sum(), q)[0]
    assert float((good - bad).abs().max()) > 1e-2


@pytest.mark.parametrize("T,E,k", [(5, 8, 2), (3, 16, 4), (4, 6, 6)])
def test_moe_router_function_gradcheck(monkeypatch, T, E, k):
    monkeypatch.setattr(router_ops, "_launch", lambda logits, k, bt,
                        launch=None: moe_router_ref(logits, k, bt=bt))
    rng = np.random.default_rng(T * E + k)
    # distinct logits spaced 0.1 apart: no pick moves under gradcheck's
    # 1e-6 perturbations
    logits = torch.from_numpy(np.stack([rng.permutation(E) * 0.1
                                        for _ in range(T)])).requires_grad_()

    def weights(logits):
        return router_ops.MoeRouterFunction.apply(logits, k, 4)[0]
    assert torch.autograd.gradcheck(weights, (logits,))
    g = torch.from_numpy(rng.standard_normal((T, k)))
    ours = torch.autograd.grad(weights(logits), logits, g)[0]
    plain = torch.autograd.grad(moe_router_ref(logits, k, bt=4)[0], logits,
                                g)[0]
    assert torch.allclose(ours, plain, rtol=1e-12, atol=1e-15)
    w, idx, stats = router_ops.MoeRouterFunction.apply(logits, k, 4)
    assert not idx.requires_grad and not stats.requires_grad


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_function_gradcheck(monkeypatch, with_state):
    monkeypatch.setattr(rwkv_ops, "_launch", lambda route, r, k, v, w, u,
                        state, state_out: rwkv6_scan_ref(r, k, v, w, u,
                                                         state))
    rng = np.random.default_rng(2)
    B, T, H, hd = 2, 4, 2, 3
    r, k, v = (_f64(rng, B, T, H, hd) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.2, 0.95, (B, T, H, hd))
                         ).requires_grad_()
    u = _f64(rng, H, hd)
    state = _f64(rng, B, H, hd, hd) if with_state else None
    inputs = (r, k, v, w, u) + ((state,) if with_state else ())

    def fn(*xs):
        return rwkv_ops.Rwkv6ScanFunction.apply(
            *xs[:5], xs[5] if with_state else None)
    assert torch.autograd.gradcheck(fn, inputs)
    go = torch.from_numpy(rng.standard_normal((B, T, H, hd)))
    gs = torch.from_numpy(rng.standard_normal((B, H, hd, hd)))
    ours = torch.autograd.grad(fn(*inputs), inputs, (go, gs))
    plain = torch.autograd.grad(rwkv6_scan_ref(*inputs[:5], state), inputs,
                                (go, gs))
    assert all(torch.equal(a, b) for a, b in zip(ours, plain))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_scan_fused_function_gradcheck(monkeypatch, with_state):
    monkeypatch.setattr(mamba_ops, "_launch_fused", lambda dt, x, Bm, Cm, A,
                        h0, h_out: mamba_scan_fused_ref(dt, x, Bm, Cm, A, h0))
    rng = np.random.default_rng(3)
    B, T, D, N = 2, 4, 3, 2
    dt = torch.from_numpy(rng.uniform(0.1, 1.0, (B, T, D))).requires_grad_()
    x = _f64(rng, B, T, D)
    Bm, Cm = _f64(rng, B, T, N), _f64(rng, B, T, N)
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, (D, N))).requires_grad_()
    h0 = _f64(rng, B, D, N) if with_state else None
    inputs = (dt, x, Bm, Cm, A) + ((h0,) if with_state else ())

    def fn(*xs):
        return mamba_ops.MambaScanFusedFunction.apply(
            *xs[:5], xs[5] if with_state else None)
    assert torch.autograd.gradcheck(fn, inputs)
    gy = torch.from_numpy(rng.standard_normal((B, T, D)))
    gh = torch.from_numpy(rng.standard_normal((B, D, N)))
    ours = torch.autograd.grad(fn(*inputs), inputs, (gy, gh))
    plain = torch.autograd.grad(mamba_scan_fused_ref(*inputs[:5], h0),
                                inputs,
                                (gy, gh))
    assert all(torch.equal(a, b) for a, b in zip(ours, plain))


@pytest.mark.cuda
def test_kernels_refuse_in_place_state_with_grad():
    """On the card a state written in place has no gradient: the entry
    points refuse it rather than drop the gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, T, H, hd = 1, 4, 2, 64
    r = torch.randn(B, T, H, hd, device="cuda", requires_grad=True)
    w = torch.rand(B, T, H, hd, device="cuda")
    u = torch.randn(H, hd, device="cuda")
    s = torch.zeros(B, H, hd, hd, device="cuda")
    with pytest.raises(ValueError, match="state_out"):
        rwkv6_scan(r, r, r, w, u, s, state_out=s)
    D, N = 64, 16
    dt = torch.rand(B, T, D, device="cuda", requires_grad=True)
    Bm = torch.randn(B, T, N, device="cuda")
    A = -torch.rand(D, N, device="cuda")
    h = torch.zeros(B, D, N, device="cuda")
    with pytest.raises(ValueError, match="h_out"):
        mamba_scan_fused(dt, dt.detach(), Bm, Bm, A, h, h_out=h)


@pytest.mark.cuda
def test_kernels_differentiate_on_the_card():
    """Each entry point's gradient on the card (the kernel forward,
    the Function's backward) against the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    q = torch.randn(2, 4, 128, 64, device="cuda", requires_grad=True)
    kv = torch.randn(2, 2, 128, 64, device="cuda", requires_grad=True)
    g = torch.randn_like(q)
    ours = torch.autograd.grad(flash_attention(q, kv, kv), (q, kv), g)
    plain = torch.autograd.grad(flash_attention_ref(q, kv, kv), (q, kv), g)
    for a, b in zip(ours, plain):
        assert float((a - b).norm() / b.norm()) < 1e-4
    logits = torch.randn(64, 16, device="cuda", requires_grad=True)
    gw = torch.randn(64, 2, device="cuda")
    ours = torch.autograd.grad(moe_router(logits, 2)[0], logits, gw)[0]
    plain = torch.autograd.grad(moe_router_ref(logits, 2)[0], logits, gw)[0]
    assert float((ours - plain).norm() / plain.norm()) < 1e-4
