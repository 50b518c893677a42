"""The De-VertiFL input block's exchange (``transformer.exchange_features``,
the multi-client ``embed_input``, ``Model(clients=...)``) against the
JAX package, on the CPU at reduced sizes.

The reference's ``exchange_features`` runs inside a ``shard_map`` over
the mesh's client axis, which this CPU cannot build
(``test_sharding_mesh.py`` fails on ``Explicit`` axes); the same
function runs here under ``jax.vmap`` with a named axis, each vmapped
row one client, and both modes must equal the port's bit for bit.  The
models are held as ``test_sharding_mesh.py::
test_exchange_modes_agree_with_centralized`` holds the reference's own
exchange: against the centralized ``forward_logits`` (within 1e-5 of
each output's largest |entry|), and their loss and gradients against
``jax.value_and_grad`` of the centralized loss at the tolerances of
``test_torch_train_grads.py`` (1e-6 and 5e-5 of the largest |entry|).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine
from test_torch_support import reference, to_np
from test_torch_train_grads import GRAD_RTOL, LOSS_RTOL, _leaves, \
    lm_batch, port_grads

MODES = ("zeropad_psum", "allgather")
LOGIT_RTOL = 1e-5
ARCHS = ("qwen1.5-0.5b", "llava-next-34b")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _with_mode(cfg, mode, enabled=True):
    return cfg.replace(vfl=dataclasses.replace(cfg.vfl, enabled=enabled,
                                               exchange=mode))


def _table_and_inputs(n, dtype, prefix, seed=0, V=40, d=8, B=2, S=5,
                      P=3):
    """A [V, n * d] table, ids [B, S] and a [B, P, n * d] prefix."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, n * d)).astype(np.float32)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    pre = rng.standard_normal((B, P, table.shape[1])).astype(np.float32) \
        if prefix else None
    # every value representable in the dtype, so both packages start
    # from the same numbers
    cast = lambda a: None if a is None else torch.from_numpy(a).to(  # noqa
        dtype).float().numpy()
    return cast(table), ids, cast(pre)


def _ref_exchange(ref, table, ids, prefix, n, mode, dtype):
    """The reference's ``exchange_features`` under ``jax.vmap`` over a
    named client axis: client i's local input is ``embed_input``'s
    ``local_fn`` on its column slice (``transformer.py:428-447``)."""
    jax, jnp = ref.jax, ref.jnp
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    d = table.shape[1] // n
    tables = jnp.asarray(table, jdt).reshape(-1, n, d).transpose(1, 0, 2)

    def local(table_local, prefix_local):
        emb = jnp.take(table_local, jnp.asarray(ids), axis=0)
        if prefix_local is not None:
            emb = jnp.concatenate([prefix_local.astype(emb.dtype), emb],
                                  axis=1)
        return ref.transformer.exchange_features(emb, "c", n, mode, None)

    if prefix is None:
        out = jax.vmap(lambda t: local(t, None), axis_name="c")(tables)
    else:
        pre = jnp.asarray(prefix, jdt)
        pres = pre.reshape(pre.shape[:2] + (n, d)).transpose(2, 0, 1, 3)
        out = jax.vmap(local, axis_name="c")(tables, pres)
    out = np.asarray(out.astype(jnp.float32))
    assert all(np.array_equal(out[0], o) for o in out)   # every client
    return out[0]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prefix", [False, True])
def test_exchange_features_bitwise_the_reference(ref, n, mode, dtype,
                                                 prefix):
    table, ids, pre = _table_and_inputs(n, dtype, prefix, seed=n)
    theirs = _ref_exchange(ref, table, ids, pre, n, mode, dtype)
    t = torch.from_numpy(table).to(dtype)
    p = None if pre is None else torch.from_numpy(pre).to(dtype)
    ours = T.exchange_features(
        T.client_inputs(t, torch.from_numpy(ids).long(), p, n), mode)
    assert ours.dtype == dtype
    np.testing.assert_array_equal(ours.float().numpy(), theirs)
    # both are the plain lookup, the prefix before it
    plain = t[torch.from_numpy(ids).long()]
    if p is not None:
        plain = torch.cat([p, plain], dim=1)
    assert torch.equal(ours, plain)


def test_exchange_features_refuses_an_unknown_mode(ref):
    """The port names the modes; the reference gathers under any name
    but 'zeropad_psum' (``transformer.py:396``)."""
    table, ids, _ = _table_and_inputs(2, torch.float32, False)
    gathered = _ref_exchange(ref, table, ids, None, 2, "ring", torch.float32)
    np.testing.assert_array_equal(gathered, table[ids])
    slices = T.client_inputs(torch.from_numpy(table),
                             torch.from_numpy(ids).long(), None, 2)
    with pytest.raises(ValueError, match="'ring'.*zeropad_psum, allgather"):
        T.exchange_features(slices, "ring")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_input_clients_bitwise_one_client(arch, mode, dtype):
    cfg = _with_mode(reduced_config(arch, dtype=dtype), mode)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg).items()}
    prefix = batch.get("prefix_emb")
    one = T.embed_input(params, batch["tokens"], cfg, prefix)
    four = T.embed_input(params, batch["tokens"], cfg, prefix, clients=4)
    assert four.dtype == one.dtype == getattr(torch, dtype)
    assert torch.equal(four, one)


def test_embed_input_refusals_and_the_block_off():
    cfg = reduced_config("qwen1.5-0.5b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 3), dtype=torch.long)
    # the reference's shard_map needs d_model to divide among the clients
    with pytest.raises(ValueError, match="d_model 256 does not divide "
                                         "among 3 clients"):
        T.embed_input(params, ids, cfg, clients=3)
    with pytest.raises(ValueError, match="unknown exchange mode"):
        T.embed_input(params, ids, _with_mode(cfg, "ring"), clients=4)
    # the input block off: the plain lookup of "embedding", whatever the
    # clients, as the reference's first branch (transformer.py:406)
    off = _with_mode(cfg, "ring", enabled=False)
    oparams = build_model(off).init(torch.Generator().manual_seed(0))
    assert "embedding" in oparams and "vfl_embedding" not in oparams
    assert torch.equal(T.embed_input(oparams, ids, off, clients=3),
                       oparams["embedding"]["table"][ids])
    assert build_model(off, clients=4).exchange_bytes((2, 8)) == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_logits_loss_and_grads_against_the_centralized_reference(ref, arch,
                                                                 mode):
    jax = ref.jax
    rcfg = ref.reduced.reduced_config(arch)
    rmodel = ref.lm.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = _with_mode(reduced_config(arch), mode)
    batch = lm_batch(cfg)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    rlogits, _ = jax.jit(rmodel.forward_logits)(rparams, jbatch)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(rparams, jbatch)

    model = build_model(cfg, clients=4)
    params = params_from_numpy(to_np(rparams), "cpu", dtype=None)
    with torch.no_grad():
        logits, _ = model.forward_logits(params, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    rlogits = np.asarray(rlogits)
    err = float(np.abs(logits.numpy() - rlogits).max())
    assert err <= LOGIT_RTOL * float(np.abs(rlogits).max()), err

    loss, met, grads = port_grads(model, params, batch)
    for ours, theirs in ((loss, rloss), (met["ce"], rmet["ce"])):
        theirs = float(theirs)
        assert abs(float(ours.detach()) - theirs) <= \
            LOSS_RTOL * max(abs(theirs), 1.0)
    theirs = _leaves(to_np(rgrads))
    assert len(grads) == len(theirs)
    for g, t in zip(grads, theirs):
        t = np.asarray(t, np.float32)
        err = float(np.abs(g.numpy() - t).max())
        assert err <= GRAD_RTOL * max(float(np.abs(t).max()), 1e-30), err
    # and bitwise one client's gradients
    _, _, one = port_grads(build_model(cfg), params, batch)
    assert all(torch.equal(a, b) for a, b in zip(grads, one))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_prefill_decode_and_engine_tokens_of_one_client(arch, mode):
    cfg = _with_mode(reduced_config(arch), mode)
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    one, four = build_model(cfg), build_model(cfg, clients=4)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg).items()
             if k != "labels"}
    (l1, s1), (l4, s4) = (m.prefill(params, batch, cache_len=32)
                          for m in (one, four))
    assert torch.equal(l1, l4)
    tok = l1[:, -1].argmax(-1)[:, None].to(torch.int32)
    (d1, _), (d4, _) = (m.decode_step(params, s, tok)
                        for m, s in ((one, s1), (four, s4)))
    assert torch.equal(d1, d4)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 7, 5)]
    outs = []
    for m in (one, four):
        engine = ServingEngine(m, params, max_batch=2, cache_len=64)
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        outs.append(engine.run())
    assert outs[0] == outs[1] and len(outs[0]) == len(prompts)


@pytest.mark.parametrize("mode,per_client", [("zeropad_psum", True),
                                             ("allgather", False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exchange_bytes(mode, per_client, dtype):
    """zeropad_psum: each of the n clients sends a full-width [B, S, D]
    tensor; allgather: each its [B, S, D/n] slice, one full width in
    all; image rows count as rows."""
    cfg = _with_mode(reduced_config("llava-next-34b", dtype=dtype), mode)
    item = getattr(torch, dtype).itemsize
    for n in (1, 2, 4, 8):
        model = build_model(cfg, clients=n)
        full = 3 * 11 * cfg.d_model * item
        want = 0 if n == 1 else full * (n if per_client else 1)
        assert model.exchange_bytes((3, 11)) == want
        assert model.exchange_bytes((3, 3), prefix_rows=8) == want
