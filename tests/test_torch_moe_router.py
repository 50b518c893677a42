"""The port's moe_router wrapper against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain version, so these tests
hold its softmax, pick order, renormalisation and per-tile stats to the
reference: the Pallas kernel in interpret mode and its oracle
``moe_router_ref``, as tests/test_kernels.py runs them.  Two documented
differences of the Pallas kernel from its own oracle are shown here:
it repeats index 0 once the rest of a row underflows to 0, and it asks
T to be a multiple of its tile; the port follows the oracle in both.
The kernel itself is held to the plain version on the card (the
``cuda`` test below, and chip_smoke.py).  What of the kernel can be
checked here is: ``ops.plan``'s launch (every row in exactly one block,
no cluster across two tiles), and a numpy emulation of the kernel's
selection on packed (value, index) keys and of its stats' summation
order (groups, then the blocks of a cluster in order) against
``lax.top_k`` and the oracle.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_router, moe_router_ref
from repro_torch.kernels.moe_router import ops
from test_torch_support import chip_smoke, reference

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


# ---------------------------------------------------------------------------
# ops.plan: the launch, a function of the shapes alone

PLAN_T = (1, 8, 77, 200, 1326, 1536)
PLAN_E = (5, 8, 16, 64, 256)


def _check_plan(p, T, E, k, bt):
    tile = min(bt, T)
    assert (p.T, p.bt) == (T, tile)
    assert 1 <= p.cluster <= ops.MAX_CLUSTER
    assert p.grid % p.cluster == 0 and p.grid == -(-T // tile) * p.cluster
    assert p.threads % 32 == 0 and 32 <= p.threads <= 32 * ops.MAX_WARPS
    assert p.lanes in (4, 8, 16, 32) and p.per_lane in (1, 2, 4, 8)
    assert p.lanes * p.per_lane >= E and k <= p.lanes
    assert p.smem <= 232448            # a block's shared memory on sm_90
    seen = np.zeros(T, np.int64)
    for cl in range(p.grid // p.cluster):
        tiles = set()
        for block in range(cl * p.cluster, (cl + 1) * p.cluster):
            rows = ops.block_rows(p, block)
            assert len(rows) <= p.rows_per_block
            seen[rows.start:rows.stop] += 1
            tiles.update(r // tile for r in rows)
        assert tiles == {cl}, "a cluster is exactly one tile's rows"
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("bt", [1, 7, 128, 1000, "above T"])
@pytest.mark.parametrize("T", PLAN_T)
def test_plan_puts_every_row_in_one_block(T, bt):
    """Every row belongs to exactly one block, no cluster spans two
    tiles, the grid is a multiple of a cluster of at most 8 blocks, and
    a block's shared memory fits; for every E and k <= min(8, E), on the
    default plan and on both ends of the crossover."""
    bt = T + 5 if bt == "above T" else bt
    for E in PLAN_E:
        for k in sorted({1, min(8, E) // 2 or 1, min(8, E)}):
            for cluster in (None, 1, ops.MAX_CLUSTER):
                _check_plan(ops.plan(T, E, k, bt, cluster=cluster), T, E,
                            k, bt)


def test_plan_at_the_serving_shapes():
    """A deepseek prefill's 128-row tile (E = 64, a row a group of 16
    lanes) is a cluster of 8 blocks of 16 rows; a jamba tile (E = 16, 4
    lanes a row) is one block of 16 warps, every row in flight; a decode
    step's 8 rows are one block."""
    p = ops.plan(1326, 64, 6)
    assert (p.lanes, p.per_lane, p.cluster, p.rows_per_block, p.threads,
            p.grid) == (16, 4, 8, 16, 256, 88)
    assert ops.plan(1536, 64, 6).grid == 96
    p = ops.plan(1326, 16, 2)
    assert (p.lanes, p.per_lane, p.cluster, p.rows_per_block, p.threads,
            p.grid) == (4, 4, 1, 128, 512, 11)
    assert ops.plan(32, 64, 6).cluster == 1 and ops.plan(64, 64, 6).cluster \
        == 8
    p = ops.plan(8, 64, 6)
    assert (p.cluster, p.rows_per_block, p.threads, p.grid) == (1, 8, 128, 1)
    p = ops.plan(8, 16, 2)
    assert (p.cluster, p.rows_per_block, p.threads, p.grid) == (1, 8, 32, 1)
    # lanes enough for k picks, and 8 values a lane at most
    assert ops.plan(77, 5, 5).lanes == 8 and ops.plan(77, 5, 2).lanes == 4
    assert ops.plan(9, 256, 8)[:2] == (32, 8)
    assert ops.plan(9, 100, 8)[:2] == (32, 4)
    # the other end of the crossover: one block walks the whole tile
    p = ops.plan(1536, 64, 6, cluster=1)
    assert (p.cluster, p.rows_per_block, p.threads, p.grid) == \
        (1, 128, 512, 12)
    with pytest.raises(ValueError):
        ops.plan(8, 64, 6, cluster=ops.MAX_CLUSTER + 1)


def test_every_plan_has_a_kernel():
    """Every (lanes, values a lane) ops.plan makes, over E <= 256 and
    k <= min(8, E), is one the CUDA launcher instantiates."""
    import re
    src = (Path(ops.__file__).parent / "csrc" / "moe_router.cu").read_text()
    built = {(int(a), int(b)) for a, b in re.findall(
        r"case (\d+) \* 16 \+ (\d+): MOE_ROUTER_LAUNCH", src)}
    made = {ops.plan(100, E, k)[:2] for E in range(1, ops.MAX_E + 1)
            for k in range(1, min(ops.MAX_K, E) + 1)}
    assert made <= built, made - built


def test_launch_refuses_a_plan_for_another_shape():
    """A plan is made for one (T, bt); the launcher refuses another
    before anything is built."""
    x = torch.zeros(100, 64)
    with pytest.raises(ValueError):
        ops._launch(x, 6, 100, launch=ops.plan(200, 64, 6))


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated in numpy float32

def _keys(p):
    """The kernel's packed keys: the float bits of p above, E - e below
    (uint64)."""
    E = p.shape[-1]
    bits = p.astype(np.float32).view(np.uint32).astype(np.uint64)
    return bits << np.uint64(32) | (E - np.arange(E)).astype(np.uint64)


def _emulated_picks(p, k, plan):
    """The kernel's picks: lane l of a row's group sorts the keys of
    experts l, l + lanes, ... (0 for a missing expert); a pick is the
    largest first key over the group, and the lane that owned it shifts
    its keys up by one.  Returns the picked experts [T, k] and pick
    k - 1's key of each row."""
    T, E = p.shape
    L, V = plan.lanes, plan.per_lane
    keys = np.zeros((T, L * V), np.uint64)
    keys[:, :E] = _keys(p)
    lists = np.sort(keys.reshape(T, V, L).transpose(0, 2, 1), axis=-1)[
        ..., ::-1]                                           # [T, L, V]
    head = np.zeros((T, L), np.int64)
    picks = np.zeros((T, k), np.int64)
    last = np.zeros(T, np.uint64)
    rows = np.arange(T)
    for j in range(k):
        first = np.where(head < V, np.take_along_axis(
            lists, np.minimum(head, V - 1)[..., None], -1)[..., 0],
            np.uint64(0))
        owner = first.argmax(1)
        last = first[rows, owner]
        picks[:, j] = E - (last & np.uint64(0xffffffff)).astype(np.int64)
        head[rows, owner] += 1
    return picks, last


def _emulated_router(p, k, plan):
    """(weights, indices, stats) as the kernel forms them from float32
    probabilities ``p``: the picks on packed keys, the weights summed in
    pick order, an expert picked where its key is at or above pick k - 1;
    the stats of each group over its rows (rows g, g + groups, ... of its
    block), a butterfly over the groups of a warp, the warps in order,
    then the blocks of a cluster in order."""
    T, E = p.shape
    idx, last = _emulated_picks(p, k, plan)
    top = np.take_along_axis(p, idx, 1)
    total = top[:, 0].copy()
    for j in range(1, k):
        total += top[:, j]
    w = top / total[:, None]
    taken = _keys(p) >= last[:, None]      # the keys at or above the last
    assert (taken.sum(1) == k).all()
    contrib = taken.astype(np.float32) + p
    groups = plan.threads // plan.lanes
    per_warp = 32 // plan.lanes
    stats = np.zeros((plan.grid // plan.cluster, E), np.float32)
    for tile in range(len(stats)):
        parts = []
        for block in range(tile * plan.cluster, (tile + 1) * plan.cluster):
            rows = ops.block_rows(plan, block)
            acc = np.zeros((groups, E), np.float32)
            for n, r in enumerate(rows):
                acc[n % groups] += contrib[r]
            # a butterfly over the groups of a warp, then warps in order
            acc = acc.reshape(-1, per_warp, E)
            off = 1
            while off < per_warp:
                acc = acc + acc[:, np.arange(per_warp) ^ off]
                off *= 2
            part = acc[0, 0].copy()
            for warp in acc[1:, 0]:
                part += warp
            parts.append(part)
        stats[tile] = parts[0]
        for part in parts[1:]:
            stats[tile] += part
    return w, idx.astype(np.int32), stats


def _selection_cases():
    rng = np.random.default_rng(7)
    ties = rng.integers(0, 3, (64, 64)).astype(np.float32)
    under = np.zeros((16, 64), np.float32)
    under[np.arange(16), np.arange(16) * 5 % 64] = 200.0
    under8 = np.zeros((4, 8), np.float32)
    under8[:, 6] = 200.0
    return {"deepseek T=1326 E=64 k=6": (_logits(11, 1326, 64), 6),
            "jamba T=1326 E=16 k=2": (_logits(12, 1326, 16), 2),
            "exact ties E=64": (ties, 6),
            "exact ties E=16, three values": (ties[:, :16], 4),
            "rows that underflow after the first pick": (under, 6),
            "underflow, k = E = 8": (under8, 8),
            "k = E = 5": (_logits(13, 77, 5), 5),
            "E = 256, k = 8": (_logits(14, 300, 256), 8),
            "E = 100 (a lane past the last expert)": (_logits(15, 40, 100), 8)}


SELECTION = _selection_cases()


@pytest.mark.parametrize("case", list(SELECTION))
def test_packed_key_selection_matches_lax_top_k(ref, case):
    """The kernel's selection (packed keys sorted in each lane, a pick the
    largest first key of the group, its lane's keys then shifted up),
    emulated on the reference's own softmax, picks what ``lax.top_k``
    picks: larger first, the lower
    index first on a tie, k distinct indices where the row underflows;
    the weights are the picks over their sum in pick order."""
    x, k = SELECTION[case]
    T, E = x.shape
    p = np.asarray(ref.jax.nn.softmax(ref.jnp.asarray(x), axis=-1))
    v, want = _top_k(ref, x, k)
    w, idx, _ = _emulated_router(p, k, ops.plan(T, E, k))
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(w, v / v.sum(-1, keepdims=True), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("T,E,k,bt", [(1326, 64, 6, 128), (1536, 64, 6, 128),
                                      (1326, 16, 2, 128), (1536, 64, 6, 1000),
                                      (200, 64, 6, 7), (77, 5, 5, 1),
                                      (8, 64, 6, 128)])
def test_stats_order_within_the_chip_limit(ref, T, E, k, bt):
    """The kernel's stats order (groups, then a cluster's blocks in rank
    order) against the JAX oracle ``moe_router_ref``: within
    chip_smoke.py's stats limit, on the probabilities the oracle uses."""
    cs = chip_smoke()
    x = _logits(T + E + k + bt, T, E)
    p = np.asarray(ref.jax.nn.softmax(ref.jnp.asarray(x), axis=-1))
    plan = ops.plan(T, E, k, bt)
    w, idx, stats = _emulated_router(p, k, plan)
    # the oracle asks T % bt == 0: its full tiles, then the tail as a
    # tile of its own
    tile = min(bt, T)
    head = T // tile * tile
    oracle = ref.router.moe_router_ref
    want_i = np.asarray(oracle(ref.jnp.asarray(x), k, bt=T)[1])
    want = np.concatenate(
        [np.asarray(oracle(ref.jnp.asarray(part), k, bt=tile)[2])
         for part in (x[:head], x[head:]) if len(part)])
    np.testing.assert_array_equal(idx, want_i)
    assert stats.shape == want.shape
    limit = cs.ROUTER_STATS_ATOL + cs.ROUTER_STATS_RTOL * np.abs(want)
    assert (np.abs(stats - want) / limit).max() <= 1.0
    # and the chip's own reading of it against the port's plain version
    xt = torch.tensor(x)
    if min(bt, T) == min(128, T):
        r = cs.route_reading(tuple(map(torch.tensor, (w, idx, stats))),
                             moe_router_ref(xt, k), xt)
        assert cs.route_ok(r), r


def test_dropped_block_partial_fails_the_chip_check():
    """The planted fault chip_smoke.py adds for the cluster's sum: one
    block's partial stats left out of its tile must fail ``route_ok``."""
    cs = chip_smoke()
    x = torch.tensor(_logits(16, 1326, 64))
    w, i, s = moe_router(x, 6)
    plan = ops.plan(1326, 64, 6)
    assert cs.route_ok(cs.route_reading((w, i, s), moe_router_ref(x, 6), x))
    r = cs.route_reading(cs._block_partial_dropped((w, i, s), x, plan, 29),
                         moe_router_ref(x, 6), x)
    assert not cs.route_ok(r) and r["stats_excess"] > 1.0, r


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Runs only where there is a card (python3 chip_smoke.py covers the
    same ground at the serving path's shapes): deepseek's and jamba's
    shapes, the limits, tiles of 1, 7 and 1000 rows; one launch a call,
    reruns bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = [(T, E, k, 128) for T, E, k in SHAPES] + [
        (1, 64, 6, 128), (1326, 64, 6, 128), (1536, 64, 6, 128),
        (8, 16, 2, 128), (1326, 16, 2, 128), (200, 256, 8, 128),
        (77, 5, 5, 128), (200, 64, 6, 1), (200, 64, 6, 7),
        (1326, 64, 6, 1000), (1326, 16, 2, 1000)]
    for T, E, k, bt in cases:
        x = torch.tensor(_logits(T + bt, T, E)).cuda()
        before = moe_router.launches
        w, i, s = moe_router(x, k, bt=bt)
        torch.cuda.synchronize()
        assert moe_router.launches == before + 1
        wr, ir, sr = moe_router_ref(x, k, bt=bt)
        assert torch.equal(i, ir), (T, E, k, bt)
        torch.testing.assert_close(w, wr, atol=1e-6, rtol=0)
        torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-5)
        w2, i2, s2 = moe_router(x, k, bt=bt)
        assert moe_router.launches == before + 2
        assert torch.equal(w, w2) and torch.equal(i, i2) and \
            torch.equal(s, s2)
