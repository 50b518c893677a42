"""The port's LM training (``repro_torch.launch.train``,
``repro_torch.optim.schedule``, ``repro_torch.data.lm``) against the JAX
package's, on the CPU in float32.

The schedules give the reference's float32 values (one ulp apart only
where XLA's float32 cosine is not the correctly rounded one, which the
test checks), the Markov batches are exactly the reference's, and the
training steps replay the reference's from its weights: 5 steps of
``make_train_step`` and 4 of ``make_federated_train_step`` (2 pods,
FedAvg every 2) for the eight reduced archs, and 2 more of each from the
reference's weights and Adam moments after 2 of its steps.  The first step's loss
(from the same weights) within 1e-6 of the reference's, a later step's
within 3e-5 and its grad norm within 1e-4 (the two trajectories drift
apart by float32 roundings: rwkv6's pods read 1.2e-5 at step 3); the final
weights within 5% of the distance the reference's moved (per leaf, L2),
and no entry more than two learning rates away: Adam's normalised
update turns a gradient entry at float32 noise level into a step of up
to lr either way, which no tighter elementwise bound can survive; the
moments within 1% (L2).  The worst readings: 1.5% of the movement and
1.55 lr (rwkv6's pods).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.reduced import reduced_config
from repro_torch.data import MarkovLM, markov_lm_batches
from repro_torch.interop import params_from_numpy
from repro_torch.launch.train import (
    main, make_federated_train_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import (
    adam, constant_schedule, cosine_schedule, linear_warmup_cosine)
from repro_torch.tree import tree_leaves
from test_torch_support import reference, to_np
from test_torch_train_grads import ARCHS, lm_batch

LR = 1e-3
FIRST_LOSS_RTOL = 1e-6
LOSS_RTOL = 3e-5
GN_RTOL = 1e-4
MOVED_RTOL = 0.05
MOMENT_RTOL = 1e-2


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(ref, batch):
    return {k: ref.jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# schedules and data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("linear_warmup_cosine", (3e-4, 10, 50)),
    ("linear_warmup_cosine", (3e-4, 10, 100)),
    ("linear_warmup_cosine", (1e-3, 0, 7)),
    ("linear_warmup_cosine", (2e-3, 3, 30)),
    ("cosine_schedule", (3e-4, 50)),
    ("cosine_schedule", (1.0, 200)),
    ("constant_schedule", (3e-4,))])
def test_schedules_match_reference(ref, name, args):
    """Steps 0 to total + 5: equal to the reference's float32, except
    one ulp where XLA's cos of the same float32 argument is not the
    correctly rounded cosine, which the port computes."""
    jnp = ref.jnp
    theirs_fn = getattr(ref.lr_schedule, name)(*args)
    ours_fn = {"linear_warmup_cosine": linear_warmup_cosine,
               "cosine_schedule": cosine_schedule,
               "constant_schedule": constant_schedule}[name](*args)
    total = args[-1] if name != "constant_schedule" else 10
    warmup = args[1] if name == "linear_warmup_cosine" else 0
    ulp_steps = []
    for step in range(total + 6):
        theirs = np.float32(theirs_fn(jnp.int32(step)))
        ours = ours_fn(step)
        assert isinstance(ours, float)
        if np.float32(ours) == theirs:
            continue
        gap = abs(int(np.float32(ours).view(np.int32))
                  - int(theirs.view(np.int32)))
        assert gap == 1, (step, ours, theirs)
        # the cosine's argument, as both compute it
        span = max(total - warmup, 1)
        x = np.float32(np.pi) * np.clip(np.float32(step - warmup)
                                        / np.float32(span), 0, 1)
        assert np.float32(jnp.cos(jnp.float32(x))) != \
            np.float32(np.cos(np.float64(x))), step
        ulp_steps.append(step)
    assert len(ulp_steps) <= 2, ulp_steps


@pytest.mark.parametrize("seed", [0, 3])
def test_markov_batches_exact(ref, seed):
    theirs = ref.lm_data.markov_lm_batches(97, 3, 20, seed=seed)
    ours = markov_lm_batches(97, 3, 20, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    chain, rchain = MarkovLM(50, seed=seed), ref.lm_data.MarkovLM(50,
                                                                  seed=seed)
    np.testing.assert_array_equal(chain.next_states, rchain.next_states)
    np.testing.assert_array_equal(chain.cum_probs, rchain.cum_probs)


# ---------------------------------------------------------------------------
# training steps against the reference
# ---------------------------------------------------------------------------
def _assert_trained_close(ours, theirs, start, moments=None):
    """Final weights within MOVED_RTOL of the reference's movement and
    two lr elementwise; moments (pairs) within MOMENT_RTOL, L2."""
    for a, b, c in zip(tree_leaves(ours), _leaves(theirs), _leaves(start),
                       strict=True):
        a, b, c = (np.asarray(x, np.float32) for x in (a.detach(), b, c))
        moved = float(np.linalg.norm(b - c))
        assert float(np.linalg.norm(a - b)) <= MOVED_RTOL * moved + 1e-12
        assert float(np.abs(a - b).max(initial=0)) <= 2 * LR
    for a, b in moments or ():
        for x, y in zip(tree_leaves(a), _leaves(b), strict=True):
            y = np.asarray(y, np.float32)
            assert float(np.linalg.norm(x.numpy() - y)) <= \
                MOMENT_RTOL * float(np.linalg.norm(y)) + 1e-30


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(ref, arch):
    """5 steps under linear_warmup_cosine (2 warmup) and the default
    whole-tree clip at 1.0 (every step clips: the grad norms are
    12-98)."""
    jax, jnp = ref.jax, ref.jnp
    cfg = reduced_config(arch)
    rmodel = ref.lm.build_model(ref.reduced.reduced_config(arch))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    ropt = ref.optim.adam(ref.lr_schedule.linear_warmup_cosine(LR, 2, 5))
    rfn = jax.jit(ref.train.make_train_step(rmodel, ropt))
    opt = adam(linear_warmup_cosine(LR, 2, 5), per_client=False)
    fn = make_train_step(build_model(cfg), opt)
    params = params_from_numpy(to_np(rparams), "cpu", dtype=None)
    state = opt.init(params)
    rp, rs, rstep, step = rparams, ropt.init(rparams), jnp.int32(0), 0
    for seed in range(5):
        batch = lm_batch(cfg, seed=seed)
        rp, rs, rstep, rm = rfn(rp, rs, rstep, _jax(ref, batch))
        params, state, step, m = fn(params, state, step, _torch(batch))
        assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "tokens"]
        assert m["grad_norm"].shape == ()
        loss_tol = LOSS_RTOL if seed else FIRST_LOSS_RTOL
        for key, tol in (("loss", loss_tol), ("ce", loss_tol),
                         ("grad_norm", GN_RTOL)):
            assert abs(float(m[key]) - float(rm[key])) <= \
                tol * float(rm[key]), (seed, key)
        assert float(m["grad_norm"]) > 1.0
    assert step == int(rstep) == 5
    _assert_trained_close(params, to_np(rp), to_np(rparams),
                          [(state[k], to_np(rs[k])) for k in ("mu", "nu")])


@pytest.mark.parametrize("arch", ARCHS)
def test_federated_steps_match_reference(ref, arch):
    """4 steps of 2 pods (different initial weights) with FedAvg every
    2 steps: against the reference's vmapped step; after each FedAvg the
    pods are bitwise equal."""
    jax, jnp = ref.jax, ref.jnp
    cfg = reduced_config(arch)
    rmodel = ref.lm.build_model(ref.reduced.reduced_config(arch))
    rpf = jax.tree.map(lambda a, b: jnp.stack([a, b]),
                       rmodel.init(jax.random.PRNGKey(0)),
                       rmodel.init(jax.random.PRNGKey(1)))
    start = to_np(rpf)
    ropt = ref.optim.adam(ref.lr_schedule.linear_warmup_cosine(LR, 2, 5))
    rsf = jax.vmap(ropt.init)(rpf)
    rfn = jax.jit(ref.train.make_federated_train_step(rmodel, ropt, 2, 2))
    opt = adam(linear_warmup_cosine(LR, 2, 5), per_client=False)
    fn = make_federated_train_step(build_model(cfg), opt, 2, 2)
    pf = params_from_numpy(start, "cpu", dtype=None)
    sf = opt.init(pf)
    rstep, step = jnp.int32(0), 0
    for i in range(4):
        batch = {k: v.reshape((2, 2) + v.shape[1:])
                 for k, v in lm_batch(cfg, seed=10 + i, B=4).items()}
        rpf, rsf, rstep, rm = rfn(rpf, rsf, rstep, _jax(ref, batch))
        pf, sf, step, m = fn(pf, sf, step, _torch(batch))
        assert sorted(m) == ["loss"]
        assert abs(float(m["loss"]) - float(rm["loss"])) <= \
            (LOSS_RTOL if i else FIRST_LOSS_RTOL) * float(rm["loss"])
        averaged = all(torch.equal(t[0], t[1]) for t in tree_leaves(pf))
        assert averaged == (i % 2 == 1)
    _assert_trained_close(pf, to_np(rpf), start,
                          [(sf[k], to_np(rsf[k])) for k in ("mu", "nu")])


@pytest.mark.parametrize("pods", [False, True])
def test_continue_from_the_reference_state(ref, pods):
    """The reference trains 2 steps; its weights and Adam moments (a
    stacked [2] tree with pods) cross to the port
    (``params_from_numpy``), and both go on for 2 steps."""
    jax, jnp = ref.jax, ref.jnp
    arch = "deepseek-moe-16b"
    cfg = reduced_config(arch)
    rmodel = ref.lm.build_model(ref.reduced.reduced_config(arch))
    ropt = ref.optim.adam(ref.lr_schedule.linear_warmup_cosine(LR, 2, 5))
    opt = adam(linear_warmup_cosine(LR, 2, 5), per_client=False)
    model = build_model(cfg)
    if pods:
        rp = jax.tree.map(lambda a, b: jnp.stack([a, b]),
                          rmodel.init(jax.random.PRNGKey(0)),
                          rmodel.init(jax.random.PRNGKey(1)))
        rs = jax.vmap(ropt.init)(rp)
        rfn = jax.jit(ref.train.make_federated_train_step(rmodel, ropt, 2, 2))
        fn = make_federated_train_step(model, opt, 2, 2)

        def batch_of(i):
            return {k: v.reshape((2, 2) + v.shape[1:])
                    for k, v in lm_batch(cfg, seed=30 + i, B=4).items()}
    else:
        rp = rmodel.init(jax.random.PRNGKey(0))
        rs = ropt.init(rp)
        rfn = jax.jit(ref.train.make_train_step(rmodel, ropt))
        fn = make_train_step(model, opt)

        def batch_of(i):
            return lm_batch(cfg, seed=30 + i)
    rstep = jnp.int32(0)
    for i in range(2):
        rp, rs, rstep, _ = rfn(rp, rs, rstep, _jax(ref, batch_of(i)))
    start = to_np(rp)
    params = params_from_numpy(start, "cpu", dtype=None)
    state = params_from_numpy(to_np(rs), "cpu", dtype=None)
    assert sorted(state) == ["mu", "nu"]
    step = int(rstep)
    for i in range(2, 4):
        rp, rs, rstep, rm = rfn(rp, rs, rstep, _jax(ref, batch_of(i)))
        params, state, step, m = fn(params, state, step,
                                    _torch(batch_of(i)))
        assert abs(float(m["loss"]) - float(rm["loss"])) <= \
            LOSS_RTOL * float(rm["loss"])
    assert step == int(rstep) == 4
    _assert_trained_close(params, to_np(rp), start,
                          [(state[k], to_np(rs[k])) for k in ("mu", "nu")])


def test_pod_step_is_the_plain_step_on_its_slice():
    """A pod's step without FedAvg is bitwise make_train_step on its
    slice of the weights, the state and the batch."""
    cfg = reduced_config("deepseek-moe-16b")
    model = build_model(cfg)
    opt = adam(linear_warmup_cosine(LR, 2, 5), per_client=False)
    pods = [model.init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    pf = _stack(pods)
    sf = opt.init(pf)
    batch = {k: v.reshape((2, 2) + v.shape[1:])
             for k, v in lm_batch(cfg, seed=5, B=4).items()}
    plain = make_train_step(model, opt)
    want = []
    for pod in range(2):
        p = pods[pod]
        s = opt.init(p)
        p, s, _, _ = plain(p, s, 0, _torch({k: v[pod]
                                            for k, v in batch.items()}))
        want.append((p, s))
    pf, sf, step, _ = make_federated_train_step(model, opt, 2, 2)(
        pf, sf, 0, _torch(batch))
    assert step == 1
    for pod, (p, s) in enumerate(want):
        assert all(torch.equal(a[pod], b) for a, b in
                   zip(tree_leaves(pf), tree_leaves(p)))
        assert all(torch.equal(a[pod], b) for a, b in
                   zip(tree_leaves(sf), tree_leaves(s)))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def test_federated_step_refuses_a_per_client_clip():
    model = build_model(reduced_config("qwen1.5-0.5b"))
    with pytest.raises(ValueError, match="per_client=False"):
        make_federated_train_step(model, adam(LR), 2, 2)


def test_whole_tree_clip_against_per_client():
    """The LM step's clip reduces the whole tree to one norm; the
    federation's (the default) one norm per leading index."""
    grads = {"a": torch.ones(2, 3) * torch.tensor([[1.0], [10.0]]),
             "b": torch.full((4,), 2.0)}
    params = {k: torch.zeros_like(v) for k, v in grads.items()}
    tree = adam(1.0, per_client=False)
    _, _, info = tree.update(grads, tree.init(params), params, 0)
    assert info["grad_norm"].shape == ()
    assert float(info["grad_norm"]) == pytest.approx(
        (3 * 1 + 3 * 100 + 4 * 4) ** 0.5, rel=1e-6)
    none = adam(1.0, per_client=False, max_grad_norm=None)
    _, _, info = none.update(grads, none.init(params), params, 0)
    assert float(info["grad_norm"]) == 0.0


# ---------------------------------------------------------------------------
# the CLI, resume, learning
# ---------------------------------------------------------------------------
def test_main_on_the_cpu(capsys):
    losses = main(["--device", "cpu", "--reduced", "--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out[0].startswith("step    0 loss=")
    assert out[1].startswith("step    2 loss=")
    assert out[-1] == "done"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])


def _batches(cfg, n, seed=3):
    it = markov_lm_batches(cfg.vocab_size, 2, 32, seed=seed)
    return [_torch(next(it)) for _ in range(n)]


def test_checkpoint_resume_exact(tmp_path):
    """Stop at step 4, save the weights and the Adam state, load them
    and go on: bitwise the uninterrupted run (the reference's
    tests/test_system.py::test_checkpoint_resume_exact)."""
    cfg = reduced_config("qwen1.5-0.5b", vocab_size=128)
    model = build_model(cfg)
    opt = adam(1e-3, per_client=False)
    fn = make_train_step(model, opt)
    batches = _batches(cfg, 8)

    def init():
        params = model.init(torch.Generator().manual_seed(0))
        return params, opt.init(params)
    p1, s1 = init()
    step = 0
    for b in batches:
        p1, s1, step, _ = fn(p1, s1, step, b)
    p2, s2 = init()
    step = 0
    for b in batches[:4]:
        p2, s2, step, _ = fn(p2, s2, step, b)
    save_checkpoint(str(tmp_path), 4, {"params": p2, "opt": s2})
    fresh, fresh_state = init()
    restored = load_checkpoint(str(tmp_path), 4,
                               {"params": fresh, "opt": fresh_state})
    assert os.listdir(tmp_path) == ["state_00000004.npz"]
    p2, s2 = restored["params"], restored["opt"]
    for b in batches[4:]:
        p2, s2, step, _ = fn(p2, s2, step, b)
    assert step == 8
    for a, b in zip(tree_leaves({"p": p1, "s": s1}),
                    tree_leaves({"p": p2, "s": s2})):
        assert torch.equal(a, b)


def test_lm_training_learns():
    """The reference's tests/test_system.py::test_lm_training_learns:
    30 steps of reduced qwen1.5-0.5b over a 256-token Markov stream
    (batch 4, seq 64, adam at lr 3e-3, as there) take the loss at least
    0.5 down and under ln(256)."""
    cfg = reduced_config("qwen1.5-0.5b", vocab_size=256)
    model = build_model(cfg)
    opt = adam(3e-3, per_client=False)
    fn = make_train_step(model, opt)
    params = model.init(torch.Generator().manual_seed(0))
    state = opt.init(params)
    it = markov_lm_batches(cfg.vocab_size, 4, 64)
    step, losses = 0, []
    for _ in range(30):
        params, state, step, m = fn(params, state, step, _torch(next(it)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert losses[-1] < np.log(256)
