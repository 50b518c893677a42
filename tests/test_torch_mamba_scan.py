"""The port's mamba_scan wrapper against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain version, so these tests
hold its selective scan to the reference: the Pallas kernel in
interpret mode and its oracle ``mamba_scan_ref``, as
tests/test_kernels.py runs them (its shapes, inputs and tolerances:
2e-5 in float32, 2e-2 in bfloat16, of max(1, |ref|max)).  The port adds
what serving needs and the Pallas kernel does not have: the state in
and out (a scan of T equals a scan of T1 followed by one of T2 from its
state, the port's form of the reference's chunk-invariance test), any T
(T = 1 is every decode step), any D, and the state written in place.
The kernel itself is held to the plain version on the card (the
``cuda`` test below, and chip_smoke.py).

``mamba_scan_fused`` (the scan the Mamba mixer calls: dt, x, B, C and A
in, a and bx formed inside) is held the same way: its plain version to
the model's discretisation followed by the plain scan (bitwise), and to
the reference's own expressions followed by the Pallas kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    mamba_scan, mamba_scan_fused, mamba_scan_fused_ref, mamba_scan_ref)
from repro_torch.models import ssm as S
from test_torch_support import reference

# tests/test_kernels.py:184: B, T, D, N and the Pallas kernel's bd, chunk
SHAPES = [(1, 64, 128, 16, 64, 32), (2, 128, 256, 8, 128, 64),
          (1, 96, 128, 16, 128, 32)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _inputs(seed, B, T, D, N):
    """a, bx [B, T, D, N] and c [B, T, N] as tests/test_kernels.py draws
    them (numpy here): a in (0.45, 0.95)."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, T, D, N), np.float32)))
    a = (a * 0.5 + 0.45).astype(np.float32)
    bx = rng.standard_normal((B, T, D, N), np.float32) * 0.2
    c = rng.standard_normal((B, T, N), np.float32)
    return a, bx, c


def _h(seed, B, D, N):
    return np.random.default_rng(seed).standard_normal((B, D, N), np.float32)


def _close(ours, theirs, dtype):
    a = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    b = np.asarray(theirs, np.float32)
    tol = TOL[dtype]
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,N,bd,chunk", SHAPES)
def test_plain_version_matches_pallas_and_oracle(ref, B, T, D, N, bd, chunk,
                                                 dtype):
    jnp = ref.jnp
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    a, bx, c = _inputs(0, B, T, D, N)
    y, h = mamba_scan(*(torch.tensor(x).to(dtype) for x in (a, bx, c)))
    assert y.dtype == dtype and y.shape == (B, T, D)
    assert h.dtype == torch.float32 and h.shape == (B, D, N)
    args = [jnp.asarray(x).astype(jdt) for x in (a, bx, c)]
    _close(y, ref.mamba.mamba_scan(*args, bd=bd, chunk=chunk), dtype)
    _close(y, ref.mamba.mamba_scan_ref(*args), dtype)


@pytest.mark.parametrize("split", [1, 37, 64, 127])
def test_a_split_scan_equals_one_scan(split):
    """T = 128 at once, or ``split`` steps then the rest from the state
    they leave (from a random state): bitwise equal, y and h."""
    a, bx, c = (torch.tensor(x) for x in _inputs(1, 2, 128, 64, 8))
    h0 = torch.tensor(_h(2, 2, 64, 8))
    y, h = mamba_scan(a, bx, c, h0)
    y1, h1 = mamba_scan(a[:, :split], bx[:, :split], c[:, :split], h0)
    y2, h2 = mamba_scan(a[:, split:], bx[:, split:], c[:, split:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(h2, h)


@pytest.mark.parametrize("T1,T2", [(64, 64), (37, 27), (63, 1)])
def test_state_carries_what_the_reference_scans(ref, T1, T2):
    """The reference scans T1 + T2 steps from zero; the port scans T1,
    then T2 from the state it left: the last T2 outputs agree."""
    jnp = ref.jnp
    a, bx, c = _inputs(3, 2, T1 + T2, 96, 16)
    theirs = ref.mamba.mamba_scan_ref(*(jnp.asarray(x) for x in (a, bx, c)))
    at, bt, ct = (torch.tensor(x) for x in (a, bx, c))
    _, h1 = mamba_scan(at[:, :T1], bt[:, :T1], ct[:, :T1])
    y2, _ = mamba_scan(at[:, T1:], bt[:, T1:], ct[:, T1:], h1)
    _close(y2, np.asarray(theirs)[:, T1:], torch.float32)


@pytest.mark.parametrize("T", [1, 5, 200])
def test_any_step_count_from_a_state(ref, T):
    """T = 1 (decode), 5 and 200 (no multiple of a chunk), D = 100 (no
    multiple of a tile), from a random state, against the reference's
    ``mamba_decode`` step written out."""
    jnp = ref.jnp
    a, bx, c = _inputs(4, 3, T, 100, 16)
    h0 = _h(5, 3, 100, 16)
    y, h = mamba_scan(*(torch.tensor(x) for x in (a, bx, c)),
                      torch.tensor(h0))
    hj, ys = jnp.asarray(h0), []
    for t in range(T):
        hj = jnp.asarray(a[:, t]) * hj + jnp.asarray(bx[:, t])
        ys.append(jnp.einsum("bdn,bn->bd", hj, jnp.asarray(c[:, t])))
    _close(y, np.stack([np.asarray(x) for x in ys], 1), torch.float32)
    _close(h, hj, torch.float32)


def test_state_written_in_place():
    a, bx, c = (torch.tensor(x) for x in _inputs(6, 2, 1, 64, 16))
    h0 = torch.tensor(_h(7, 2, 64, 16))
    want_y, want_h = mamba_scan(a, bx, c, h0.clone())
    y, h = mamba_scan(a, bx, c, h0, h_out=h0)
    assert h is h0 and torch.equal(h0, want_h) and torch.equal(y, want_y)


def test_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(1, 4, 8, 16)
    c = torch.zeros(1, 4, 16)
    with pytest.raises(TypeError):
        mamba_scan(a.double(), a.double(), c.double())
    with pytest.raises(TypeError):
        mamba_scan(a, a, c.bfloat16())
    with pytest.raises(ValueError):
        mamba_scan(a, a[:, :3], c)
    with pytest.raises(ValueError):
        mamba_scan(a, a, c[:, :, :8])
    with pytest.raises(ValueError):
        mamba_scan(a, a, c, torch.zeros(1, 8, 8))
    with pytest.raises(ValueError):
        mamba_scan(a[:, :0], a[:, :0], c[:, :0])
    with pytest.raises(ValueError):
        mamba_scan(a, a, c, h_out=torch.zeros(1, 16, 8).transpose(1, 2))


def test_cpu_path_counts_no_launches():
    before = mamba_scan.launches
    mamba_scan(*(torch.tensor(x) for x in _inputs(8, 1, 4, 32, 16)))
    assert mamba_scan.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (python3 chip_smoke.py covers the
    same ground at the serving path's shapes).  Held element by element
    to the plain version's float32 result on the same (upcast) inputs:
    the kernel sums in float32 in another order, within 2e-6 max(1,
    |plain|max) + 1e-5 |plain|; a bf16 output is that result rounded
    once, 2^-8 |plain| more (chip_smoke.py's rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = [(*s[:4], dt) for s in SHAPES
             for dt in (torch.float32, torch.bfloat16)] + [
        (8, 1, 8192, 16, torch.float32), (2, 333, 1000, 8, torch.float32),
        (1, 40, 77, 16, torch.float32), (3, 9, 50, 8, torch.float32)]
    for B, T, D, N, dtype in cases:
        a, bx, c = (torch.tensor(x).cuda().to(dtype)
                    for x in _inputs(9, B, T, D, N))
        h0 = torch.tensor(_h(10, B, D, N)).cuda()
        before = mamba_scan.launches
        y, h = mamba_scan(a, bx, c, h0)
        torch.cuda.synchronize()
        assert mamba_scan.launches == before + 1
        y_ref, h_ref = mamba_scan_ref(a.float(), bx.float(), c.float(), h0)
        rtol = 1e-5 + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0)
        for got, want, tol in ((y.float(), y_ref, rtol),
                               (h, h_ref, 1e-5)):
            atol = 2e-6 * max(1.0, float(want.abs().max()))
            assert bool(((got - want).abs() <=
                         atol + tol * want.abs()).all())
        y2, h2 = mamba_scan(a, bx, c, h0)
        assert torch.equal(y, y2) and torch.equal(h, h2)
        if T > 1:
            y1, h1 = mamba_scan(a[:, :T // 2], bx[:, :T // 2], c[:, :T // 2],
                                h0)
            y3, h3 = mamba_scan(a[:, T // 2:], bx[:, T // 2:], c[:, T // 2:],
                                h1)
            assert torch.equal(torch.cat([y1, y3], 1), y) and \
                torch.equal(h3, h)
        h_in = h0.clone()
        mamba_scan(a, bx, c, h_in, h_out=h_in)
        assert torch.equal(h_in, h)


# ---------------------------------------------------------------------------
# mamba_scan_fused: the discretisation inside the scan
# ---------------------------------------------------------------------------
def _fused_inputs(seed, B, T, D, N, dtype=torch.float32, with_state=True):
    """dt = softplus(N(0, 1)) [B, T, D] float32, x, B, C [B, T, D|N] in the
    model's dtype, A = -(1 .. N) + noise [D, N] float32, a state; numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D)))).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    A = -(np.arange(1, N + 1, dtype=np.float32)
          + 0.1 * rng.standard_normal((D, N)).astype(np.float32))
    h0 = rng.standard_normal((B, D, N)).astype(np.float32) \
        if with_state else None
    out = [torch.tensor(dt), *(torch.tensor(v).to(dtype) for v in
                               (x, Bm, Cm)), torch.tensor(A)]
    return out + [None if h0 is None else torch.tensor(h0)]


def _mixer(seed, d_in, dt_rank, N, dtype):
    """The Mamba mixer's discretisation weights at a small size, drawn
    with numpy: x_proj, dt_proj and dt_bias as models/ssm.py holds them
    (A_log at its init)."""
    rng = np.random.default_rng(seed)

    def mat(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            * shape[0] ** -0.5).to(dtype)
    return {"x_proj": mat(d_in, dt_rank + 2 * N),
            "dt_proj": mat(dt_rank, d_in),
            "dt_bias": torch.tensor(0.1 * rng.standard_normal(d_in),
                                    dtype=torch.float32),
            "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32))
            .expand(d_in, N).contiguous()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [8, 16])
def test_fused_plain_version_is_discretise_then_scan_bitwise(dtype, N):
    """The mixer's old path, ``_discretise`` (a and bx materialised)
    then ``mamba_scan_ref``, and the fused plain version on the mixer's
    scan inputs give the same bits, y and h; so does the wrapper."""
    d_in, dt_rank, B, T = 48, 4, 2, 23
    m = _mixer(11, d_in, dt_rank, N, dtype)
    x_conv = torch.tensor(np.random.default_rng(12).standard_normal(
        (B, T, d_in)).astype(np.float32)).to(dtype)
    h0 = torch.tensor(_h(13, B, d_in, N))
    a, bx, c = S._discretise(m, x_conv, dt_rank, N)
    want = mamba_scan_ref(a, bx, c, h0)
    dt, Bm, Cm, A = S._scan_inputs(m, x_conv, dt_rank, N)
    assert dt.dtype == torch.float32 and Bm.dtype == dtype
    for fn in (mamba_scan_fused_ref, mamba_scan_fused):
        y, h = fn(dt, x_conv, Bm, Cm, A, h0)
        assert y.dtype == torch.float32
        assert torch.equal(y, want[0]) and torch.equal(h, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,N,bd,chunk", SHAPES[:2])
def test_fused_matches_reference_expressions_and_pallas(ref, B, T, D, N, bd,
                                                        chunk, dtype):
    """The reference's discretisation (src/repro/models/ssm.py:94-97)
    written in jnp, then its Pallas kernel in interpret mode and its
    oracle: the port's fused scan agrees within the file's float32
    tolerance (every input of the scan is float32 after the
    discretisation, in a bf16 model too)."""
    jnp = ref.jnp
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    dt, x, Bm, Cm, A, _ = _fused_inputs(14, B, T, D, N, dtype, False)
    y, _ = mamba_scan_fused(dt, x, Bm, Cm, A)
    dt_j, A_j = jnp.asarray(dt.numpy()), jnp.asarray(A.numpy())
    x_j, B_j, C_j = (jnp.asarray(t.float().numpy()).astype(jdt)
                     for t in (x, Bm, Cm))
    a = jnp.exp(dt_j[..., None] * A_j)
    bx = (dt_j * x_j)[..., None] * B_j[:, :, None, :].astype(dt_j.dtype)
    assert a.dtype == bx.dtype == jnp.float32
    c = C_j.astype(jnp.float32)
    _close(y, ref.mamba.mamba_scan(a, bx, c, bd=bd, chunk=chunk),
           torch.float32)
    _close(y, ref.mamba.mamba_scan_ref(a, bx, c), torch.float32)


@pytest.mark.parametrize("split", [1, 37, 127])
def test_fused_split_scan_equals_one_scan(split):
    """T = 128 at once, or ``split`` steps then the rest from the state
    they leave: bitwise equal, y and h."""
    dt, x, Bm, Cm, A, h0 = _fused_inputs(15, 2, 128, 40, 16)
    y, h = mamba_scan_fused(dt, x, Bm, Cm, A, h0)
    y1, h1 = mamba_scan_fused(dt[:, :split], x[:, :split], Bm[:, :split],
                              Cm[:, :split], A, h0)
    y2, h2 = mamba_scan_fused(dt[:, split:], x[:, split:], Bm[:, split:],
                              Cm[:, split:], A, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_fused_decode_writes_the_state_in_place():
    dt, x, Bm, Cm, A, h0 = _fused_inputs(16, 3, 1, 40, 8, torch.bfloat16)
    want_y, want_h = mamba_scan_fused(dt, x, Bm, Cm, A, h0.clone())
    y, h = mamba_scan_fused(dt, x, Bm, Cm, A, h0, h_out=h0)
    assert h is h0 and torch.equal(h0, want_h) and torch.equal(y, want_y)


def test_fused_refuses_what_the_kernel_does_not_take():
    dt, x, Bm, Cm, A, h0 = _fused_inputs(17, 1, 4, 8, 16)
    with pytest.raises(ValueError, match="state dims"):
        mamba_scan_fused(dt, x, Bm[..., :4], Cm[..., :4], A[:, :4])
    with pytest.raises(ValueError):
        mamba_scan_fused(dt, x[:, :3], Bm, Cm, A)
    with pytest.raises(ValueError):
        mamba_scan_fused(dt, x, Bm[:, :, :8], Cm, A)
    with pytest.raises(ValueError):
        mamba_scan_fused(dt, x, Bm, Cm, A[:7])
    with pytest.raises(TypeError):
        mamba_scan_fused(dt.bfloat16(), x, Bm, Cm, A)
    with pytest.raises(TypeError):
        mamba_scan_fused(dt, x, Bm.bfloat16(), Cm, A)
    with pytest.raises(TypeError):
        mamba_scan_fused(dt, x.double(), Bm.double(), Cm.double(), A)
    with pytest.raises(ValueError):
        mamba_scan_fused(dt, x, Bm, Cm, A.bfloat16())
    with pytest.raises(ValueError):
        mamba_scan_fused(dt, x, Bm, Cm, A, h0[:, :4])
    with pytest.raises(ValueError):
        mamba_scan_fused(dt, x, Bm, Cm, A, h_out=torch.zeros(
            1, 16, 8).transpose(1, 2))


def test_fused_cpu_path_counts_no_launches():
    before = (mamba_scan.launches, mamba_scan_fused.launches)
    mamba_scan_fused(*_fused_inputs(18, 1, 4, 32, 16))
    assert (mamba_scan.launches, mamba_scan_fused.launches) == before


@pytest.mark.cuda
def test_fused_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (python3 chip_smoke.py covers the
    same ground at the serving path's shapes).  Held element by element
    to the plain version's result on the same inputs, within
    chip_smoke.py's scan limit (2e-6 max(1, |plain|max) + 1e-5 |plain|);
    the prefill and decode kernels, float32 and bf16 inputs, tails of D
    (staged by plain loads where D % 8 != 0), row-strided B and C."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = [(1, 200, 256, 16, torch.bfloat16), (2, 77, 1000, 8,
                                                 torch.float32),
             (8, 1, 8192, 16, torch.bfloat16), (3, 1, 50, 8, torch.float32),
             (1, 40, 77, 16, torch.bfloat16), (2, 33, 96, 16, torch.float32)]
    for B, T, D, N, dtype in cases:
        dt, x, Bm, Cm, A, h0 = (None if t is None else t.cuda() for t in
                                _fused_inputs(19, B, T, D, N, dtype))
        # B and C as the model passes them: views of one projection
        proj = torch.cat([Bm, Cm, torch.zeros_like(Bm)], -1)
        Bv, Cv = proj[..., :N], proj[..., N:2 * N]
        before = mamba_scan_fused.launches
        y, h = mamba_scan_fused(dt, x, Bv, Cv, A, h0)
        torch.cuda.synchronize()
        assert mamba_scan_fused.launches == before + 1
        y_ref, h_ref = mamba_scan_fused_ref(dt, x, Bm, Cm, A, h0)
        for got, want in ((y, y_ref), (h, h_ref)):
            atol = 2e-6 * max(1.0, float(want.abs().max()))
            assert bool(((got - want).abs() <=
                         atol + 1e-5 * want.abs()).all())
        y2, h2 = mamba_scan_fused(dt, x, Bm, Cm, A, h0)
        assert torch.equal(y, y2) and torch.equal(h, h2)
        if T > 1:
            k = T * 41 // 100
            y1, h1 = mamba_scan_fused(dt[:, :k], x[:, :k], Bm[:, :k],
                                      Cm[:, :k], A, h0)
            y3, h3 = mamba_scan_fused(dt[:, k:], x[:, k:], Bm[:, k:],
                                      Cm[:, k:], A, h1)
            assert torch.equal(torch.cat([y1, y3], 1), y) and \
                torch.equal(h3, h)
        h_in = h0.clone()
        mamba_scan_fused(dt, x, Bm, Cm, A, h_in, h_out=h_in)
        assert torch.equal(h_in, h)
