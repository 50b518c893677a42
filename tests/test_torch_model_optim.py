"""The port's model, optimizer and exchange against the JAX package's,
on the same weights and inputs (made with numpy from a seed).  float32
in both: elementwise work (optimizer, exchange, FedAvg) is allclose at
1e-6; a forward through matmuls, whose sums the two libraries take in
another order, at tests/test_kernels.py's float32 rule (2e-5 of the
output's scale)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.exchange import fedavg, hidden_output_exchange
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models.mlp_model import PaperMLP
from repro_torch.optim import adam, adamw, sgd
from test_torch_support import reference, to_np

RTOL = ATOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def close_trees(ours, theirs, **kw):
    ours = params_to_numpy(ours)
    for name in theirs:
        for leaf in theirs[name]:
            close(ours[name][leaf], theirs[name][leaf], **kw)


def _ref_params(ref, arch, n):
    model = ref.mlp.PaperMLP(ref.configs.get_config(arch))
    keys = ref.jax.random.split(ref.jax.random.PRNGKey(n), n)
    return model, to_np(ref.jax.vmap(model.init)(keys))


@pytest.mark.parametrize("arch,n", [("paper-mlp-mnist", 3),
                                    ("paper-mlp-titanic", 4)])
def test_paper_mlp_forward_on_carried_weights(ref, arch, n):
    jax = ref.jax
    rmodel, rparams = _ref_params(ref, arch, n)
    model = PaperMLP(get_config(arch), n)
    model.load_params(params_from_numpy(rparams, "cpu"))
    close_trees(model.params(), rparams, rtol=0, atol=0)    # a copy

    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 16, model.in_features)).astype(np.float32)
    h1 = np.maximum(rng.standard_normal((n, 16, 10)), 0).astype(np.float32)
    logits = jax.vmap(lambda p, xi: rmodel.head(
        p, rmodel.forward_hidden(p, xi)))(rparams, x)
    with torch.no_grad():
        ours = model.head(model.forward_hidden(torch.tensor(x)))
        h2 = model.forward_from(torch.tensor(h1), start=1, upto=2)
    scale = max(1.0, float(np.abs(logits).max()))
    close(ours, logits, rtol=2e-5, atol=2e-5 * scale)
    ref_h2 = jax.vmap(lambda p, h: rmodel.forward_from(
        p, h, start=1, upto=2))(rparams, h1)
    close(h2, ref_h2, rtol=2e-5, atol=2e-5)


def test_init_draws_live_clients_first():
    cfg = get_config("paper-mlp-titanic")
    three = PaperMLP(cfg, 3).init_params(torch.Generator().manual_seed(5))
    five = PaperMLP(cfg, 5).init_params(torch.Generator().manual_seed(5))
    for name in three:
        assert torch.equal(three[name]["kernel"], five[name]["kernel"][:3])
        assert not three[name]["bias"].any()
    k0 = PaperMLP(get_config("paper-mlp-mnist"), 8).init_params(
        torch.Generator().manual_seed(0))["layer_0"]["kernel"]
    assert k0.shape == (8, 784, 10)
    assert abs(float(k0.std()) / (2 / 784) ** 0.5 - 1) < 0.05


def _grads(seed, params, scale):
    rng = np.random.default_rng(seed)
    return {k: {leaf: (rng.standard_normal(v.shape) * scale).astype(
        np.float32) for leaf, v in layer.items()}
        for k, layer in params.items()}


@pytest.mark.parametrize("steps,max_grad_norm,kind", [
    (1, None, "adam"), (10, None, "adam"), (1, 1.0, "adam"),
    (10, 0.5, "adam"), (10, None, "adamw"), (10, None, "sgd")])
def test_optimizer_steps_match(ref, steps, max_grad_norm, kind):
    """The per-client (vmapped) update of the reference, step for step:
    parameters and float32 moments."""
    jax = ref.jax
    _, params = _ref_params(ref, "paper-mlp-titanic", 3)
    if kind == "adam":
        ropt = ref.optim.adam(1e-3, max_grad_norm=max_grad_norm)
        opt = adam(1e-3, max_grad_norm=max_grad_norm)
    elif kind == "adamw":
        ropt = ref.optim.adamw(1e-3, max_grad_norm=None)
        opt = adamw(1e-3, max_grad_norm=None)
    else:
        ropt = ref.optim.sgd(1e-2, momentum=0.9)
        opt = sgd(1e-2, momentum=0.9)
    rstate = jax.vmap(ropt.init)(params)
    ours = params_from_numpy(params, "cpu")
    state = opt.init(ours)
    rparams = params
    for step in range(steps):
        g = _grads(step, params, 3.0)
        rparams, rstate, _ = jax.vmap(
            lambda gg, s, p: ropt.update(gg, s, p, jax.numpy.int32(step)))(
                g, rstate, rparams)
        ours, state, _ = opt.update(params_from_numpy(g, "cpu"), state,
                                    ours, step)
    close_trees(ours, to_np(rparams))
    for key in state:
        close_trees(state[key], to_np(rstate[key]))


def test_clip_is_per_client():
    grads = {"a": {"kernel": torch.ones(2, 3, 4) * torch.tensor(
        [1.0, 10.0])[:, None, None]}}
    opt = adam(1.0, max_grad_norm=1.0)
    params = {"a": {"kernel": torch.zeros(2, 3, 4)}}
    _, _, info = opt.update(grads, opt.init(params), params, 0)
    close(info["grad_norm"], [12 ** 0.5, 10 * 12 ** 0.5], rtol=1e-6)


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("mask", [None, (1.0, 1.0, 0.0, 1.0)])
def test_hidden_output_exchange(ref, differentiable, mask):
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(2)
    h = rng.standard_normal((4, 6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 6, 5)).astype(np.float32)
    cm = None if mask is None else np.asarray(mask, np.float32)

    def ref_loss(h):
        out = ref.exchange.hidden_output_exchange(
            h, differentiable=differentiable,
            client_mask=None if cm is None else jnp.asarray(cm))
        return (out * w).sum(), out
    (_, rout), rgrad = jax.value_and_grad(ref_loss, has_aux=True)(h)

    ht = torch.tensor(h, requires_grad=True)
    out = hidden_output_exchange(
        ht, differentiable=differentiable,
        client_mask=None if cm is None else torch.tensor(cm))
    (grad,) = torch.autograd.grad((out * torch.tensor(w)).sum(), ht)
    close(out.detach(), rout)
    close(grad, rgrad)


@pytest.mark.parametrize("mask", [None, (1.0, 0.0, 1.0), (1.0, 1.0, 1.0)])
def test_fedavg(ref, mask):
    _, params = _ref_params(ref, "paper-mlp-bank", 3)
    cm = None if mask is None else np.asarray(mask, np.float32)
    rout = to_np(ref.exchange.fedavg(
        params, client_mask=None if cm is None else ref.jnp.asarray(cm)))
    ours = fedavg(params_from_numpy(params, "cpu"),
                  client_mask=None if cm is None else torch.tensor(cm))
    close_trees(ours, rout)
    k = ours["layer_1"]["kernel"]
    assert torch.equal(k[0], k[1]) and torch.equal(k[0], k[2])
