"""The port's rwkv6_scan wrapper against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain version, so these tests
hold its recurrence to the reference: the Pallas kernel in interpret
mode and its oracle ``rwkv6_scan_ref``, as tests/test_kernels.py runs
them (its shapes, inputs and tolerances: 2e-5 in float32, 2e-2 in
bfloat16, of max(1, |ref|max)).  The port adds what serving needs and
the Pallas kernel does not have: the state in and out (a scan of T
equals a scan of T1 followed by one of T2 from its state, the port's
form of the reference's chunk-invariance test), any T (T = 1 is a
decode step), and the state written in place.  The kernel itself is
held to the plain version on the card (the ``cuda`` test below, and
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6_scan, rwkv6_scan_ref
from test_torch_support import reference

# tests/test_kernels.py:148: B, T, H, hd, the Pallas kernel's chunk
SHAPES = [(2, 128, 2, 64, 32), (1, 256, 4, 64, 64), (2, 64, 2, 128, 64)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _inputs(seed, B, T, H, hd):
    """r, k, v, w [B, T, H, hd] and u [H, hd] as tests/test_kernels.py
    draws them (numpy here): w in (0.45, 0.95)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, hd), np.float32)
    k = rng.standard_normal((B, T, H, hd), np.float32) * 0.3
    v = rng.standard_normal((B, T, H, hd), np.float32)
    w = 1 / (1 + np.exp(-rng.standard_normal((B, T, H, hd), np.float32)))
    w = (w * 0.5 + 0.45).astype(np.float32)
    u = rng.standard_normal((H, hd), np.float32) * 0.2
    return r, k, v, w, u


def _state(seed, B, H, hd):
    return np.random.default_rng(seed).standard_normal(
        (B, H, hd, hd), np.float32)


def _close(ours, theirs, dtype):
    a = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    b = np.asarray(theirs, np.float32)
    tol = TOL[dtype]
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,chunk", SHAPES)
def test_plain_version_matches_pallas_and_oracle(ref, B, T, H, hd, chunk,
                                                 dtype):
    jnp = ref.jnp
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    r, k, v, w, u = _inputs(0, B, T, H, hd)
    ours, state = rwkv6_scan(*(torch.tensor(x).to(dtype)
                               for x in (r, k, v, w)), torch.tensor(u))
    assert ours.dtype == dtype and ours.shape == (B, T, H, hd)
    assert state.dtype == torch.float32 and state.shape == (B, H, hd, hd)
    args = [jnp.asarray(x).astype(jdt) for x in (r, k, v, w)] + \
        [jnp.asarray(u)]
    pallas = ref.rwkv6.rwkv6_scan(*args, chunk=chunk)
    oracle = ref.rwkv6.rwkv6_scan_ref(*args)
    _close(ours, pallas, dtype)
    _close(ours, oracle, dtype)


@pytest.mark.parametrize("split", [1, 37, 64, 127])
def test_a_split_scan_equals_one_scan(split):
    """T = 128 at once, or ``split`` steps then the rest from the state
    they leave (from a random state): bitwise equal, o and state."""
    r, k, v, w, u = (torch.tensor(x) for x in _inputs(1, 2, 128, 2, 64))
    s0 = torch.tensor(_state(2, 2, 2, 64))
    o, s = rwkv6_scan(r, k, v, w, u, s0)
    o1, s1 = rwkv6_scan(*(x[:, :split] for x in (r, k, v, w)), u, s0)
    o2, s2 = rwkv6_scan(*(x[:, split:] for x in (r, k, v, w)), u, s1)
    assert torch.equal(torch.cat([o1, o2], 1), o)
    assert torch.equal(s2, s)


@pytest.mark.parametrize("T1,T2", [(64, 64), (37, 27), (63, 1)])
def test_state_carries_what_the_reference_scans(ref, T1, T2):
    """The reference scans T1 + T2 steps from zero; the port scans T1,
    then T2 from the state it left: the last T2 outputs agree (T1 and
    T2 multiples of no chunk; T2 = 1 is a decode step)."""
    jnp = ref.jnp
    r, k, v, w, u = _inputs(3, 2, T1 + T2, 2, 64)
    theirs = ref.rwkv6.rwkv6_scan_ref(*(jnp.asarray(x)
                                        for x in (r, k, v, w, u)))
    rt, kt, vt, wt, ut = (torch.tensor(x) for x in (r, k, v, w, u))
    _, s1 = rwkv6_scan(rt[:, :T1], kt[:, :T1], vt[:, :T1], wt[:, :T1], ut)
    o2, _ = rwkv6_scan(rt[:, T1:], kt[:, T1:], vt[:, T1:], wt[:, T1:], ut,
                       s1)
    _close(o2, np.asarray(theirs)[:, T1:], torch.float32)


@pytest.mark.parametrize("T", [1, 5, 200])
def test_any_step_count_from_a_state(ref, T):
    """T = 1 (decode), 5 and 200 (no multiple of a chunk) from a random
    state, against the reference scan of the same steps written out."""
    jnp = ref.jnp
    r, k, v, w, u = _inputs(4, 3, T, 2, 64)
    s0 = _state(5, 3, 2, 64) * 0.1
    ours, state = rwkv6_scan(*(torch.tensor(x) for x in (r, k, v, w, u)),
                             torch.tensor(s0))
    S, outs = jnp.asarray(s0), []
    for t in range(T):
        kv = jnp.asarray(k[:, t, :, :, None] * v[:, t, :, None, :])
        outs.append(jnp.einsum("bhk,bhkv->bhv", jnp.asarray(r[:, t]),
                               S + jnp.asarray(u)[..., None] * kv))
        S = jnp.asarray(w[:, t, :, :, None]) * S + kv
    _close(ours, np.stack([np.asarray(o) for o in outs], 1), torch.float32)
    _close(state, S, torch.float32)


def test_state_written_in_place():
    r, k, v, w, u = (torch.tensor(x) for x in _inputs(6, 2, 3, 2, 64))
    s0 = torch.tensor(_state(7, 2, 2, 64))
    want_o, want_s = rwkv6_scan(r, k, v, w, u, s0.clone())
    o, s = rwkv6_scan(r, k, v, w, u, s0, state_out=s0)
    assert s is s0 and torch.equal(s0, want_s) and torch.equal(o, want_o)


def test_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 2, 64)
    u = torch.zeros(2, 64)
    with pytest.raises(TypeError):
        rwkv6_scan(x.double(), x.double(), x.double(), x.double(), u)
    with pytest.raises(TypeError):
        rwkv6_scan(x, x, x.bfloat16(), x, u)
    with pytest.raises(ValueError):
        rwkv6_scan(x, x, x, x[:, :3], u)
    with pytest.raises(ValueError):
        rwkv6_scan(x, x, x, x, torch.zeros(2, 32))
    with pytest.raises(ValueError):
        rwkv6_scan(x, x, x, x, u, torch.zeros(1, 2, 64, 64).double())
    with pytest.raises(ValueError):
        rwkv6_scan(x[:, :0], x[:, :0], x[:, :0], x[:, :0], u)
    with pytest.raises(ValueError):
        rwkv6_scan(x, x, x, x, u, state_out=torch.zeros(
            1, 2, 64, 64).transpose(2, 3))


def test_cpu_path_counts_no_launches():
    before = rwkv6_scan.launches
    rwkv6_scan(*(torch.tensor(x) for x in _inputs(8, 1, 4, 2, 64)))
    assert rwkv6_scan.launches == before


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
        (8, 1, 32, 64, torch.float32), (1, 333, 3, 64, torch.float32)]
    for B, T, H, hd, dtype in cases:
        r, k, v, w, u = (torch.tensor(x).cuda()
                         for x in _inputs(9, B, T, H, hd))
        r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
        s0 = torch.tensor(_state(10, B, H, hd)).cuda()
        before = rwkv6_scan.launches
        o, s = rwkv6_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        assert rwkv6_scan.launches == before + 1
        o_ref, s_ref = rwkv6_scan_ref(*(x.float() for x in (r, k, v, w)),
                                      u, s0)
        rtol = 1e-5 + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0)
        for got, want, tol in ((o.float(), o_ref, rtol),
                               (s, s_ref, 1e-5)):
            atol = 2e-6 * max(1.0, float(want.abs().max()))
            assert bool(((got - want).abs() <=
                         atol + tol * want.abs()).all())
        o2, s2 = rwkv6_scan(r, k, v, w, u, s0)
        assert torch.equal(o, o2) and torch.equal(s, s2)
        if T > 1:
            o1, s1 = rwkv6_scan(r[:, :T // 2], k[:, :T // 2], v[:, :T // 2],
                                w[:, :T // 2], u, s0)
            o3, s3 = rwkv6_scan(r[:, T // 2:], k[:, T // 2:], v[:, T // 2:],
                                w[:, T // 2:], u, s1)
            assert torch.equal(torch.cat([o1, o3], 1), o) and \
                torch.equal(s3, s)
        s_in = s0.clone()
        rwkv6_scan(r, k, v, w, u, s_in, state_out=s_in)
        assert torch.equal(s_in, s)
