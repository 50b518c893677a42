"""The port's rwkv6_scan wrapper against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain version, so these tests
hold its recurrence to the reference: the Pallas kernel in interpret
mode and its oracle ``rwkv6_scan_ref``, as tests/test_kernels.py runs
them (its shapes, inputs and tolerances: 2e-5 in float32, 2e-2 in
bfloat16, of max(1, |ref|max)).  The port adds what serving needs and
the Pallas kernel does not have: the state in and out (a scan of T
equals a scan of T1 followed by one of T2 from its state, the port's
form of the reference's chunk-invariance test), any T (T = 1 is a
decode step), and the state written in place.  The chunked route's
algorithm, ``rwkv6_scan_chunked_ref`` (chunk summaries from running
products of w, a scan over chunks, every chunk replayed from its start
state), is held to the same reference on the decays that stress it
(strong decay, exact zeros, w = 1 - 2^-24), on short and ragged T, hd
128, B > 1 and from a state; a run split on its chunk grid is bitwise
one run.  The kernels themselves are held to the plain version on the
card (the ``cuda`` test below, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6_scan, rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_chunked_ref
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


def _decay(rng, kind, shape):
    """rwkv6's init decay exp(-exp(-4 + 0.5 N)) (w near 0.98), a strong
    one exp(-exp(1.5 + 0.5 N)) (w near 0.01, products that underflow),
    or the init decay with exact zeros (10%) and w = 1 - 2^-24 (30%)."""
    n = rng.standard_normal(shape)
    if kind == "strong":
        return np.exp(-np.exp(1.5 + 0.5 * n)).astype(np.float32)
    w = np.exp(-np.exp(-4 + 0.5 * n)).astype(np.float32)
    if kind == "edge":
        pick = rng.random(shape)
        w[pick < 0.1] = 0.0
        w[pick > 0.7] = np.float32(1 - 2.0 ** -24)
    return w


# name: B, T0 (steps before, which make the state; 0: from zeros), T,
# H, hd, decay
CHUNKED_CASES = {
    "rwkv6 init decay": (1, 0, 256, 2, 64, "init"),
    "strong decay": (1, 0, 256, 2, 64, "strong"),
    "exact zeros and 1 - 2^-24": (1, 0, 256, 2, 64, "edge"),
    "T < L": (2, 0, 46, 2, 64, "init"),
    "T % L != 0": (1, 0, 300, 2, 64, "init"),
    "hd 128": (1, 0, 128, 2, 128, "init"),
    "B > 1": (3, 0, 200, 2, 64, "init"),
    "from a state": (2, 100, 200, 2, 64, "init"),
}


def _pallas_chunk(T):
    """The largest chunk of at most 64 that divides T (the Pallas
    kernel asks T % chunk == 0)."""
    return max(c for c in range(1, 65) if T % c == 0)


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_plain_version_matches_plain_and_pallas(ref, case):
    """The chunked route's algorithm against ``rwkv6_scan_ref`` (o and
    the final state) and the Pallas kernel in interpret mode (o; the
    Pallas kernel starts from zeros, so a case from a state runs it over
    the T0 steps that made the state and compares the last T)."""
    B, T0, T, H, hd, kind = CHUNKED_CASES[case]
    rng = np.random.default_rng(12)
    r, k, v = (rng.standard_normal((B, T0 + T, H, hd), np.float32)
               for _ in range(3))
    w = _decay(rng, kind, (B, T0 + T, H, hd))
    u = (0.5 + 0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    rt, kt, vt, wt = (torch.tensor(x) for x in (r, k, v, w))
    ut = torch.tensor(u)
    s0 = None
    if T0:
        _, s0 = rwkv6_scan_ref(rt[:, :T0], kt[:, :T0], vt[:, :T0],
                               wt[:, :T0], ut)
    rest = [x[:, T0:] for x in (rt, kt, vt, wt)]
    ours, state = rwkv6_scan_chunked_ref(*rest, ut, s0, chunk=ops.CHUNK)
    assert ours.shape == (B, T, H, hd) and state.shape == (B, H, hd, hd)
    assert bool(torch.isfinite(ours).all() and torch.isfinite(state).all())
    want, want_state = rwkv6_scan_ref(*rest, ut, s0)
    _close(ours, want, torch.float32)
    _close(state, want_state, torch.float32)
    jnp = ref.jnp
    pallas = ref.rwkv6.rwkv6_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                                  chunk=_pallas_chunk(T0 + T))
    _close(ours, np.asarray(pallas)[:, T0:], torch.float32)


def _chunked_run(seed, T):
    r, k, v, w, u = (torch.tensor(x) for x in _inputs(seed, 2, T, 2, 64))
    return r, k, v, w, u, torch.tensor(_state(seed + 1, 2, 2, 64))


@pytest.mark.parametrize("T1", [64, 128, 192])
def test_chunked_split_on_the_chunk_grid_is_bitwise(T1):
    """A split at a multiple of the chunk gives the chunks of one run:
    T1 steps, then the rest from their state, bitwise one run of T."""
    r, k, v, w, u, s0 = _chunked_run(13, 300)
    o, s = rwkv6_scan_chunked_ref(r, k, v, w, u, s0, chunk=ops.CHUNK)
    o1, s1 = rwkv6_scan_chunked_ref(*(x[:, :T1] for x in (r, k, v, w)), u,
                                    s0, chunk=ops.CHUNK)
    o2, s2 = rwkv6_scan_chunked_ref(*(x[:, T1:] for x in (r, k, v, w)), u,
                                    s1, chunk=ops.CHUNK)
    assert torch.equal(torch.cat([o1, o2], 1), o) and torch.equal(s2, s)


@pytest.mark.parametrize("T1", [37, 100, 299])
def test_chunked_unaligned_split_within_the_limit(T1):
    """Off the chunk grid the chunks differ, so the split run sums in
    another order: within the float32 tolerance of one run."""
    r, k, v, w, u, s0 = _chunked_run(15, 300)
    o, s = rwkv6_scan_chunked_ref(r, k, v, w, u, s0, chunk=ops.CHUNK)
    o1, s1 = rwkv6_scan_chunked_ref(*(x[:, :T1] for x in (r, k, v, w)), u,
                                    s0, chunk=ops.CHUNK)
    o2, s2 = rwkv6_scan_chunked_ref(*(x[:, T1:] for x in (r, k, v, w)), u,
                                    s1, chunk=ops.CHUNK)
    _close(torch.cat([o1, o2], 1), o.numpy(), torch.float32)
    _close(s2, s.numpy(), torch.float32)


def test_route_by_shape():
    """Prefills take the chunked kernels, a decode step and short T the
    sequential one; the route depends on the shape alone."""
    for shape in [(1, 1326, 32, 64), (1, 1536, 32, 64), (4, 700, 32, 64),
                  (2, 300, 4, 128), (1, 64, 32, 64), (1, 46, 32, 64),
                  (1, ops.CHUNKED_MIN_T, 32, 64)]:
        assert ops.route(*shape) == "chunked", shape
    for shape in [(8, 1, 32, 64), (1, 16, 32, 64),
                  (1, ops.CHUNKED_MIN_T - 1, 32, 64)]:
        assert ops.route(*shape) == "sequential", shape


def test_cpu_path_runs_the_plain_scan_on_either_route():
    """On CPU tensors the wrapper runs ``rwkv6_scan_ref`` whatever the
    shape's route on the card."""
    r, k, v, w, u, s0 = _chunked_run(17, 200)
    assert ops.route(*r.shape) == "chunked"
    o, s = rwkv6_scan(r, k, v, w, u, s0)
    want_o, want_s = rwkv6_scan_ref(r, k, v, w, u, s0)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (python3 chip_smoke.py covers the
    same ground at the serving path's shapes).  Both routes' launchers at
    every case, held element by element to the plain version's float32
    result on the same (upcast) inputs: the kernels sum in float32 in
    another order, within 2e-6 max(1, |plain|max) + 1e-5 |plain|; a bf16
    output is that result rounded once, 2^-8 |plain| more (chip_smoke.py's
    rule).  The wrapper runs ``ops.route``'s kernels, one launch a call;
    a split run is bitwise one run where both halves take the run's
    route and, chunked, split on the chunk grid, and within the limit
    elsewhere; the state may be written in place, prefill included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = [(*s[:4], dt) for s in SHAPES
             for dt in (torch.float32, torch.bfloat16)] + [
        (8, 1, 32, 64, torch.float32), (1, 333, 3, 64, torch.float32),
        (1, 46, 2, 64, torch.float32), (4, 700, 4, 64, torch.float32)]

    def within(got, want, dtype, state=False):
        rtol = 1e-5 + (2.0 ** -8 if dtype == torch.bfloat16 and not state
                       else 0.0)
        atol = 2e-6 * max(1.0, float(want.abs().max()))
        return bool(((got.float() - want).abs() <=
                     atol + rtol * want.abs()).all())

    for B, T, H, hd, dtype in cases:
        r, k, v, w, u = (torch.tensor(x).cuda()
                         for x in _inputs(9, B, T, H, hd))
        r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
        s0 = torch.tensor(_state(10, B, H, hd)).cuda()
        o_ref, s_ref = rwkv6_scan_ref(*(x.float() for x in (r, k, v, w)),
                                      u, s0)
        by_route = {}
        for name in ("sequential", "chunked"):
            o, s = ops._launch(name, r, k, v, w, u, s0, None)
            torch.cuda.synchronize()
            assert within(o, o_ref, dtype) and within(s, s_ref, dtype, True)
            o2, s2 = ops._launch(name, r, k, v, w, u, s0, None)
            assert torch.equal(o, o2) and torch.equal(s, s2)
            by_route[name] = (o, s)
        route = ops.route(B, T, H, hd)
        before = rwkv6_scan.launches
        o, s = rwkv6_scan(r, k, v, w, u, s0)
        assert rwkv6_scan.launches == before + 1
        assert torch.equal(o, by_route[route][0]) and \
            torch.equal(s, by_route[route][1])
        T1s = {T // 2, ops.CHUNK * (T // 2 // ops.CHUNK)} - {0}
        for T1 in (T1s if T > 1 else ()):
            o1, s1 = rwkv6_scan(r[:, :T1], k[:, :T1], v[:, :T1], w[:, :T1],
                                u, s0)
            o3, s3 = rwkv6_scan(r[:, T1:], k[:, T1:], v[:, T1:], w[:, T1:],
                                u, s1)
            halves = {ops.route(B, T1, H, hd), ops.route(B, T - T1, H, hd)}
            if halves == {route} and (route == "sequential"
                                      or T1 % ops.CHUNK == 0):
                assert torch.equal(torch.cat([o1, o3], 1), o) and \
                    torch.equal(s3, s)
            else:
                assert within(torch.cat([o1, o3], 1), o_ref, dtype) and \
                    within(s3, s_ref, dtype, True)
        s_in = s0.clone()
        o_in, _ = rwkv6_scan(r, k, v, w, u, s_in, state_out=s_in)
        assert torch.equal(s_in, s) and torch.equal(o_in, o)
