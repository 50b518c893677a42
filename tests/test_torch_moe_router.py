"""The port's moe_router wrapper against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain version, so these tests
hold its softmax, pick order, renormalisation and per-tile stats to the
reference: the Pallas kernel in interpret mode and its oracle
``moe_router_ref``, as tests/test_kernels.py runs them.  Two documented
differences of the Pallas kernel from its own oracle are shown here:
it repeats index 0 once the rest of a row underflows to 0, and it asks
T to be a multiple of its tile; the port follows the oracle in both.
The kernel itself is held to the plain version on the card (the
``cuda`` test below, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_router, moe_router_ref
from test_torch_support import reference

# tests/test_kernels.py:210, plus a decode step's T = 8 at deepseek's E, k
SHAPES = [(256, 64, 6), (128, 8, 2), (384, 16, 4), (8, 64, 6)]


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _logits(seed, T, E):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32) * 2


def _top_k(ref, x, k):
    """``lax.top_k`` of the reference's softmax: (values, indices)."""
    jax = ref.jax
    p = jax.nn.softmax(ref.jnp.asarray(x), axis=-1)
    v, i = jax.lax.top_k(p, k)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("T,E,k", SHAPES)
def test_plain_version_matches_pallas_and_oracle(ref, T, E, k):
    x = _logits(1, T, E)
    w, i, s = moe_router(torch.tensor(x), k)
    assert (w.dtype, i.dtype, s.dtype) == \
        (torch.float32, torch.int32, torch.float32)
    assert (w.shape, i.shape, s.shape) == ((T, k), (T, k),
                                           (-(-T // min(128, T)), E))
    for theirs in (ref.router.moe_router(ref.jnp.asarray(x), k),
                   ref.router.moe_router_ref(ref.jnp.asarray(x), k)):
        wr, ir, sr = (np.asarray(a) for a in theirs)
        np.testing.assert_allclose(w.numpy(), wr, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(i.numpy(), ir)
        np.testing.assert_allclose(s.numpy(), sr, atol=1e-4, rtol=0)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)


def test_exact_ties_lowest_index_first(ref):
    """Equal probabilities are picked lowest index first, as
    ``lax.top_k`` picks them."""
    E, k = 16, 4
    x = np.zeros((4, E), np.float32)
    x[1, [3, 7, 9, 12]] = 1.0              # four equal maxima
    x[2, [2, 5]] = 2.0
    x[2, [1, 6, 8]] = 1.0                  # two then three equal values
    x[3] = np.repeat(np.arange(4, dtype=np.float32), 4)[::-1]
    w, i, _ = moe_router(torch.tensor(x), k)
    want = [[0, 1, 2, 3], [3, 7, 9, 12], [2, 5, 1, 6], [0, 1, 2, 3]]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(i.numpy(), _top_k(ref, x, k)[1])
    np.testing.assert_array_equal(w[0].numpy(), np.full(k, 0.25,
                                                        np.float32))


def test_tail_tile_sums_its_real_rows(ref):
    """T = 1326 (the first served prompt's length) is not a multiple of
    the 128-row tile: 11 tiles, the last of 46 rows."""
    T, E, k = 1326, 64, 6
    x = _logits(2, T, E)
    w, i, s = moe_router(torch.tensor(x), k)
    assert s.shape == (11, E)
    v, want_i = _top_k(ref, x, k)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(w.numpy(), v / v.sum(-1, keepdims=True),
                               atol=1e-6, rtol=0)
    p = np.exp(x.astype(np.float64) - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    sel = np.zeros((T, E))
    np.put_along_axis(sel, want_i.astype(np.int64), 1.0, axis=1)
    rows = sel + p
    np.testing.assert_allclose(s[-1].numpy(), rows[1280:].sum(0), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(
        s[:-1].numpy(), rows[:1280].reshape(10, 128, E).sum(1), atol=1e-4,
        rtol=0)


def test_any_token_count_where_pallas_asks_a_multiple_of_its_tile(ref):
    """A documented difference of the reference kernel: ``moe_router_p``
    asserts T % bt == 0, so T = 200 fails there; the port takes it."""
    x = _logits(3, 200, 64)
    with pytest.raises(AssertionError):
        ref.router.moe_router(ref.jnp.asarray(x), 6)
    w, i, s = moe_router(torch.tensor(x), 6)
    assert s.shape == (2, 64)
    np.testing.assert_array_equal(i.numpy(), _top_k(ref, x, 6)[1])
    sel = torch.zeros(200, 64).scatter_(1, i.long(), 1.0)
    rows = (sel + torch.softmax(torch.tensor(x), -1)).numpy()
    np.testing.assert_allclose(s.numpy(), [rows[:128].sum(0),
                                           rows[128:].sum(0)], atol=1e-4,
                               rtol=0)


def test_underflow_row_matches_oracle_not_pallas(ref):
    """Once the rest of a row is exactly 0 (logit 200 against 0), the
    Pallas kernel, which masks a pick by multiplying by 1 - onehot,
    picks index 0 again; the oracle (``lax.top_k``) and the port give
    distinct indices, lowest first.  A documented difference of the
    reference kernel, not a fault of the port."""
    x = np.zeros((8, 64), np.float32)
    x[:, 5] = 200.0
    _, i, s = moe_router(torch.tensor(x), 6)
    np.testing.assert_array_equal(i.numpy(), np.tile([5, 0, 1, 2, 3, 4],
                                                     (8, 1)))
    _, ir, sr = ref.router.moe_router_ref(ref.jnp.asarray(x), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=1e-4)
    _, ip, _ = ref.router.moe_router(ref.jnp.asarray(x), 6)
    np.testing.assert_array_equal(np.asarray(ip)[0], [5, 0, 0, 0, 0, 0])


def test_tile_size_argument():
    """``bt`` sets the stats' tiles (clipped to T); the picks do not
    depend on it."""
    x = torch.tensor(_logits(4, 100, 16))
    w, i, s = moe_router(x, 4, bt=32)
    assert s.shape == (4, 16)
    w2, i2, s2 = moe_router(x, 4, bt=1000)
    assert s2.shape == (1, 16)
    assert torch.equal(w, w2) and torch.equal(i, i2)
    torch.testing.assert_close(s.sum(0), s2[0], atol=1e-4, rtol=0)


def test_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 64)
    with pytest.raises(TypeError):
        moe_router(x.double(), 2)
    with pytest.raises(ValueError):
        moe_router(x[0], 2)
    with pytest.raises(ValueError):
        moe_router(torch.zeros(0, 64), 2)
    with pytest.raises(ValueError):
        moe_router(torch.zeros(4, 257), 2)
    with pytest.raises(ValueError):
        moe_router(x, 9)
    with pytest.raises(ValueError):
        moe_router(torch.zeros(4, 3), 4)
    with pytest.raises(ValueError):
        moe_router(x, 0)
    with pytest.raises(ValueError):
        moe_router(x, 2, bt=0)


def test_cpu_path_counts_no_launches():
    before = moe_router.launches
    moe_router(torch.tensor(_logits(5, 8, 64)), 6)
    assert moe_router.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (python3 chip_smoke.py covers the
    same ground at the serving path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = [(T, E, k, 1) for T, E, k in SHAPES] + [
        (1, 64, 6, 1), (1326, 64, 6, 1), (200, 256, 8, 1), (77, 5, 5, 1)]
    for T, E, k, seed in cases:
        x = torch.tensor(_logits(seed, T, E)).cuda()
        before = moe_router.launches
        w, i, s = moe_router(x, k)
        torch.cuda.synchronize()
        assert moe_router.launches == before + 1
        wr, ir, sr = moe_router_ref(x, k)
        assert torch.equal(i, ir)
        torch.testing.assert_close(w, wr, atol=1e-6, rtol=0)
        torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-5)
        w2, i2, s2 = moe_router(x, k)
        assert torch.equal(w, w2) and torch.equal(i, i2) and \
            torch.equal(s, s2)
