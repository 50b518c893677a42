"""The port's vfl_matmul wrapper against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain version inside the same
``autograd.Function`` the CUDA kernel uses, so these tests hold the
wrapper's shapes, offsets, gradient and gate to the reference: the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it, and
its zeropad oracle ``vfl_matmul_ref``.  The kernel itself is held to the
plain version on the card (the ``cuda`` test below, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.vfl_matmul import (
    ops, vfl_matmul, vfl_matmul_clients, vfl_matmul_clients_ref,
    vfl_matmul_ref)
from test_torch_support import reference


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def allclose(a, b):
    """float32, another summation order: tests/test_kernels.py's rule."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tol = 2e-5
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


def _inputs(seed, M, Kl, Kf, N=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, Kl), np.float32),
            rng.standard_normal((Kf, N), np.float32),
            rng.standard_normal((M, N), np.float32))


def _torch_grads(x, w, t, off, gate=None):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = vfl_matmul(xt, wt, off, gate=gate)
    gx, gw = torch.autograd.grad((y * torch.tensor(t)).sum(), (xt, wt))
    return y.detach().numpy(), gx.numpy(), gw.numpy()


def _jax_grads(ref, fn, x, w, t):
    jnp = ref.jnp

    def loss(x, w):
        return (fn(x, w) * t).sum()
    y = fn(jnp.asarray(x), jnp.asarray(w))
    gx, gw = ref.jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
    return np.asarray(y), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("M,Kl,Kf,off,bk", [
    (16, 128, 512, 128, 128),
    (8, 56, 140, 28, 28),
    (32, 128, 128, 0, 128),
    (6, 3, 9, 3, 3),
])
def test_matches_pallas_kernel_and_oracle(ref, M, Kl, Kf, off, bk):
    """Forward, dx and dW against the Pallas kernel (interpret mode)
    and the zeropad oracle, at tests/test_kernels.py's shapes."""
    x, w, t = _inputs(M + Kl, M, Kl, Kf)
    ours = _torch_grads(x, w, t, off)
    pallas = _jax_grads(ref, lambda a, b: ref.kernels.vfl_matmul(
        a, b, off, bk=bk, interpret=True), x, w, t)
    oracle = _jax_grads(ref, lambda a, b: ref.kernels.vfl_matmul_ref(
        a, b, off), x, w, t)
    for o, p, r in zip(ours, pallas, oracle):
        allclose(o, p)
        allclose(o, r)
    gw = ours[2]
    assert np.all(gw[:off] == 0) and np.all(gw[off + Kl:] == 0)


@pytest.mark.parametrize("M,Kl,Kf,off", [(5, 7, 20, 6), (4, 0, 9, 3)])
def test_unaligned_and_empty_slices_match_oracle(ref, M, Kl, Kf, off):
    """Offsets the Pallas kernel refuses (not a multiple of a block) and
    a client of size 0, against the zeropad oracle."""
    x, w, t = _inputs(Kl + off, M, Kl, Kf)
    ours = _torch_grads(x, w, t, off)
    oracle = _jax_grads(ref, lambda a, b: ref.kernels.vfl_matmul_ref(
        a, b, off), x, w, t)
    for o, r in zip(ours, oracle):
        allclose(o, r)
    allclose(vfl_matmul_ref(torch.tensor(x), torch.tensor(w), off), ours[0])


def test_gate_zero_and_one(ref):
    x, w, t = _inputs(11, 8, 56, 140)
    y1, gx1, gw1 = _torch_grads(x, w, t, 28, gate=torch.tensor(1.0))
    y, gx, gw = _torch_grads(x, w, t, 28)
    for a, b in ((y1, y), (gx1, gx), (gw1, gw)):
        np.testing.assert_array_equal(a, b)          # bitwise identity
    y0, gx0, gw0 = _torch_grads(x, w, t, 28, gate=0.0)
    assert not y0.any() and not gx0.any() and not gw0.any()
    # the reference's gate agrees
    ry, rgx, rgw = _jax_grads(ref, lambda a, b: ref.kernels.vfl_matmul(
        a, b, 28, bk=28, gate=0.0), x, w, t)
    assert not ry.any() and not rgx.any() and not rgw.any()


CLIENT_CASES = [
    # M, per-client sizes, N, extra columns, x offsets differ from W's
    (64, (168, 168, 168, 140, 140), 10, 0, False),
    (178, (3, 3, 3), 10, 0, False),
    (37, (5, 3, 1), 10, 0, False),
    (65, (7, 0, 4, 0), 33, 3, False),
    (9, (4, 6, 2), 5, 2, True),
]


def _client_inputs(M, sizes, N, extra, shifted, seed=0):
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    kx = int(sum(sizes)) + extra
    x_off = offs + extra if shifted else offs
    x = torch.tensor(rng.standard_normal((M, kx), np.float32))
    w = torch.tensor(rng.standard_normal((len(sizes), kx, N), np.float32))
    ints = [torch.tensor(v, dtype=torch.int32)
            for v in (x_off, offs, sizes)]
    return x, w, ints


@pytest.mark.parametrize("M,sizes,N,extra,shifted", CLIENT_CASES)
def test_all_clients_form_matches_per_client_calls(M, sizes, N, extra,
                                                   shifted):
    """One all-clients call == one single-client call per client,
    forward and both gradients."""
    x, w, (xo, wo, sz) = _client_inputs(M, sizes, N, extra, shifted)
    t = torch.randn(len(sizes), M, N, generator=torch.Generator()
                    .manual_seed(1))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = vfl_matmul_clients(xa, wa, xo, wo, sz)
    gx, gw = torch.autograd.grad((y * t).sum(), (xa, wa))

    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    per = [vfl_matmul(xb[:, o:o + s], wb[c], int(q))
           for c, (o, q, s) in enumerate(zip(xo.tolist(), wo.tolist(),
                                             sz.tolist()))]
    y_per = torch.stack(per)
    gx_r, gw_r = torch.autograd.grad((y_per * t).sum(), (xb, wb))
    allclose(y.detach(), y_per.detach())
    allclose(gx, gx_r)
    allclose(gw, gw_r)
    dead = [c for c, s in enumerate(sizes) if s == 0]
    assert not y[dead].any() and not gw[dead].any()


def test_plain_versions_agree():
    x, w, (xo, wo, sz) = _client_inputs(12, (4, 6, 2), 5, 0, False)
    y = vfl_matmul_clients_ref(x, w, xo, wo, sz)
    for c, (o, s) in enumerate(zip(xo.tolist(), sz.tolist())):
        allclose(y[c], vfl_matmul_ref(x[:, o:o + s], w[c], o))
    assert torch.equal(y, vfl_matmul_clients_ref(
        x, w, xo.tolist(), wo.tolist(), sz.tolist()))


def test_refuses_what_the_kernel_does_not_take():
    x, w, (xo, wo, sz) = _client_inputs(4, (2, 2), 3, 0, False)
    with pytest.raises(TypeError, match="float32"):
        vfl_matmul_clients(x.double(), w, xo, wo, sz)
    with pytest.raises(ValueError, match="int32"):
        vfl_matmul_clients(x, w, xo.long(), wo, sz)
    with pytest.raises(ValueError, match="outside"):
        vfl_matmul(x, w[0], 3)


def test_cpu_path_counts_no_launches():
    before = vfl_matmul_clients.launches
    x, w, ints = _client_inputs(4, (2, 2), 3, 0, False)
    vfl_matmul_clients(x, w, *ints)
    assert vfl_matmul_clients.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (python3 chip_smoke.py covers the
    same ground at the training path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for M, sizes, N, extra, shifted in CLIENT_CASES:
        x, w, ints = _client_inputs(M, sizes, N, extra, shifted)
        x, w = x.cuda(), w.cuda()
        ints = [v.cuda() for v in ints]
        before = vfl_matmul_clients.launches
        y = vfl_matmul_clients(x, w, *ints)
        torch.cuda.synchronize()
        assert vfl_matmul_clients.launches == before + 1
        allclose(y.cpu(), vfl_matmul_clients_ref(x, w, *ints).cpu())


# ---------------------------------------------------------------------------
# the launch plan (a function of the shapes, run on the host)
# ---------------------------------------------------------------------------
MNIST_K, MNIST_N = 784, 10
PLAN_SHAPES = [(M, MNIST_K, MNIST_K, MNIST_N, n)
               for n in range(1, 11) for M in (64, 14000)] + [
    (1001, 56, 56, 33, 3), (178, 9, 9, 10, 3), (5, 7, 20, 33, 1),
    (96, 9, 9, 10, 3), (1, 1, 1, 1, 1), (300, 4000, 4000, 10, 2)]


def _coverage(p, M, N):
    """How many threads write each (client, row, column) under plan
    ``p``: a wave thread writes one row of the column ``thread % bn`` of
    its block's N-tile, a ring thread RING_TM neighbouring rows of it."""
    rows_a_thread = 1 if p.kernel == "wave" else ops.RING_TM
    count = np.zeros((p.grid[2], M, N), np.int64)
    for t in range(p.threads):
        r0 = t // p.bn * rows_a_thread
        rows, cols = range(r0, r0 + rows_a_thread), [t % p.bn]
        for by in range(p.grid[1]):
            for bx in range(p.grid[0]):
                for r in rows:
                    m = by * p.bm + r
                    for col in cols:
                        if m < M and bx * p.bn + col < N:
                            count[:, m, bx * p.bn + col] += 1
    return count


@pytest.mark.parametrize("M,Kx,Kw,N,n", PLAN_SHAPES)
def test_plan_covers_every_output_once(M, Kx, Kw, N, n):
    p = ops.plan(M, Kx, Kw, N, n)
    assert (_coverage(p, M, N) == 1).all()
    assert p.threads <= ops.BN_MAX * ops.WAVE_BM
    assert 1 <= p.bn <= min(N, ops.BN_MAX)


@pytest.mark.parametrize("M,Kx,Kw,N,n", PLAN_SHAPES)
def test_plan_shared_memory_fits_a_block(M, Kx, Kw, N, n):
    """Under 227 KB at 1 to 10 mnist clients, at the M and N tails case
    and at a slice too wide for the wave kernel; the wave kernel's x rows
    stay 16-byte aligned and start 8 banks apart."""
    p = ops.plan(M, Kx, Kw, N, n)
    assert 0 < p.smem <= ops.SMEM_MAX == 227 * 1024
    if p.kernel == "wave":
        assert p.ldx >= min(Kx, Kw) and p.ldx % 32 == 8
        assert p.smem >= 4 * (ops.WAVE_BM * p.ldx + min(Kx, Kw) * N)


def test_plan_picks_the_kernel_by_shape():
    """A training step's batch loads its slice in one wave; the test set,
    and any slice too wide for shared memory, take the ring."""
    assert ops.plan(64, MNIST_K, MNIST_K, MNIST_N, 5).kernel == "wave"
    assert ops.plan(64, MNIST_K, MNIST_K, MNIST_N, 5).grid == (1, 4, 5)
    assert ops.plan(ops.WAVE_MAX_M, MNIST_K, MNIST_K, MNIST_N,
                    5).kernel == "wave"
    assert ops.plan(ops.WAVE_MAX_M + 1, MNIST_K, MNIST_K, MNIST_N,
                    5).kernel == "ring"
    assert ops.plan(14000, MNIST_K, MNIST_K, MNIST_N, 5).kernel == "ring"
    wide = ops.plan(64, 4000, 4000, MNIST_N, 2)
    assert wide.kernel == "ring" and wide.smem <= ops.SMEM_MAX


@pytest.mark.parametrize("M,sizes,N,extra,shifted", CLIENT_CASES)
def test_trailing_zero_columns_add_nothing(M, sizes, N, extra, shifted):
    """The +-0.0 contract: a slice widened by columns of x that are zero
    gives the same bits in the plain version, so a zero-padded slice (the
    layout's padding, the ring's zero-filled last K-tile) changes no
    sum."""
    pad = 3
    x, w, (xo, wo, sz) = _client_inputs(M, sizes, N, extra, shifted)
    n = len(sizes)
    # each slice followed by `pad` zero columns of x (and rows of W)
    xw = torch.zeros(M, x.shape[1] + pad * n)
    ww = torch.randn(n, w.shape[1] + pad * n, N,
                     generator=torch.Generator().manual_seed(2))
    xo2, wo2 = xo + pad * torch.arange(n, dtype=torch.int32), \
        wo + pad * torch.arange(n, dtype=torch.int32)
    for c in range(n):
        s = int(sz[c])
        xw[:, int(xo2[c]):int(xo2[c]) + s] = x[:, int(xo[c]):int(xo[c]) + s]
        ww[c, int(wo2[c]):int(wo2[c]) + s] = w[c, int(wo[c]):int(wo[c]) + s]
    y = vfl_matmul_clients_ref(xw, ww, xo2, wo2, sz)
    y_pad = vfl_matmul_clients_ref(xw, ww, xo2, wo2, sz + pad)
    assert torch.equal(y, y_pad)


@pytest.mark.cuda
def test_wave_and_ring_kernels_agree_bitwise_on_the_card():
    """Both kernels sum every output in the same order: each case run
    through each gives the same bits (chip_smoke.py does the same at the
    training path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for M, sizes, N, extra, shifted in CLIENT_CASES:
        x, w, ints = _client_inputs(M, sizes, N, extra, shifted)
        x, w = x.cuda(), w.cuda()
        ints = [v.cuda() for v in ints]
        n, kw, _ = w.shape
        wave = ops.plan(min(M, ops.WAVE_MAX_M), x.shape[1], kw, N, n)
        ring = ops.plan(ops.WAVE_MAX_M + 1, x.shape[1], kw, N, n)
        assert (wave.kernel, ring.kernel) == ("wave", "ring")
        outs = [ops._launch(x, w, *ints, launch=p) for p in (wave, ring)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        allclose(outs[0].cpu(), vfl_matmul_clients_ref(x, w, *ints).cpu())
