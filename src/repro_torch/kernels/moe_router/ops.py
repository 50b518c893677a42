"""Public wrapper for the MoE router.

``moe_router(logits, k, *, bt=128)`` keeps the JAX package's signature
(``repro.kernels.moe_router.moe_router``): logits float32 [T, E] ->
(weights [T, k] float32, indices [T, k] int32, stats [ceil(T / bt), E]
float32), the semantics of ``moe_router_ref`` (``ref.py``): a softmax
over E, the k largest probabilities with ``lax.top_k``'s order, weights
renormalised over the picks, and per-tile (routed count + probability
mass) stats.  It takes any T >= 1 (the Pallas kernel asks T % bt == 0),
E <= 256 and k <= 8.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/moe_router.cu``, built at first use) or raises; on a CPU tensor
it runs the plain version in ``ref.py``.  There is no other path.

``plan(T, E, k, bt)``, a function of the shapes alone, says how a call
launches: a row is one group of ``lanes`` lanes (E / 4 rounded up to a
power of two, at least 4 and k, at most 32), each holding ``per_lane``
of its experts (4, or 8 above E = 128); a tile of ``bt`` rows is a
thread-block cluster of ``cluster`` blocks, ``rows_per_block`` rows a
block, one row a group at a time.  A tile whose warps times values a
lane are at most ``ONE_BLOCK_WORK`` runs as one block (a decode step;
jamba's E = 16 tiles), a larger one over ``MAX_CLUSTER`` blocks.
``block_rows(plan, block)`` gives the rows a block takes.

Gradient: where the logits require grad, a CUDA call runs through
``MoeRouterFunction`` (a ``torch.autograd.Function``): its forward is
the kernel, launched and counted as above; its backward is the closed
form of the weights' gradient, in PyTorch ops.  The renormalised top-k
weights are a softmax over the picked logits, so with g the weights'
gradient, dl_j = w_j (g_j - sum_i w_i g_i) at a picked j and 0
elsewhere.  The indices and the stats are not differentiable (marked
so).  The JAX package's training autodiffs the plain router and has no
backward kernel either.  On the CPU autograd differentiates the plain
version directly.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.moe_router.ref import moe_router_ref

MAX_E = 256
MAX_K = 8
# the kernel's limits (csrc/moe_router.cu's constants; its launcher
# refuses a plan that disagrees)
MAX_CLUSTER = 8          # blocks a cluster: the portable limit
MAX_WARPS = 16           # warps a block
# the most warps x values a lane of a tile that runs as one block, a
# measure of the instructions one SM runs: at E = 64 (4 values a lane, 2 rows a
# warp) one block led a cluster of 8 up to T = 32 (16 warps) and trailed
# it from T = 64 (32 warps); jamba's 128-row tiles (E = 16: 16 warps of 8
# rows, 4 values a lane) led as one block (chip_smoke.py's ``crossover``
# times both)
ONE_BLOCK_WORK = 64


class Plan(NamedTuple):
    """How one call launches (module doc): lanes a row, values a lane,
    blocks a tile (the cluster), rows a block, threads a block, dynamic
    shared-memory bytes a block, the grid (blocks), and the shape it was
    made for (``T`` rows, tiles of ``bt``)."""
    lanes: int
    per_lane: int
    cluster: int
    rows_per_block: int
    threads: int
    smem: int
    grid: int
    T: int
    bt: int


def _pow2_at_least(n):
    return 1 << max(0, n - 1).bit_length()


def plan(T, E, k, bt=128, cluster=None) -> Plan:
    """The launch of logits [T, E] at top-k with tiles of ``bt`` rows
    (clipped to T).  ``cluster`` forces the blocks a tile (a crossover
    measurement); by default one block where the tile's warps times
    values a lane are at most ``ONE_BLOCK_WORK``, else ``MAX_CLUSTER``."""
    bt = min(bt, T)
    lanes = min(32, max(4, _pow2_at_least(-(-E // 4)), _pow2_at_least(k)))
    per_lane = _pow2_at_least(-(-E // lanes))
    rows_per_warp = 32 // lanes
    warps = -(-bt // rows_per_warp)          # one row a group
    if cluster is None:
        cluster = 1 if warps * per_lane <= ONE_BLOCK_WORK else MAX_CLUSTER
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"a cluster of 1 to {MAX_CLUSTER} blocks, got "
                         f"{cluster}")
    rows_per_block = -(-bt // cluster)
    cluster = -(-bt // rows_per_block)       # no block without rows
    threads = 32 * min(MAX_WARPS, -(-rows_per_block // rows_per_warp))
    ep = lanes * per_lane
    smem = 4 * (threads // 32 * ep + (cluster * ep if cluster > 1 else 0))
    return Plan(lanes, per_lane, cluster, rows_per_block, threads, smem,
                -(-T // bt) * cluster, T, bt)


def block_rows(p: Plan, block: int) -> range:
    """The rows block ``block`` of plan ``p`` routes: tile block //
    cluster, the rank's share of it (the kernel's own arithmetic)."""
    tile, rank = divmod(block, p.cluster)
    start = tile * p.bt + rank * p.rows_per_block
    return range(min(start, p.T), min(start + p.rows_per_block,
                                      (tile + 1) * p.bt, p.T))


def _check(logits, k, bt):
    if logits.dim() != 2 or logits.shape[0] < 1:
        raise ValueError(f"expected logits [T, E] with T >= 1, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"moe_router takes float32 logits, got "
                        f"{logits.dtype}")
    E = logits.shape[1]
    if not 1 <= E <= MAX_E:
        raise ValueError(f"moe_router takes 1 to {MAX_E} experts, got {E}")
    if not 1 <= k <= min(MAX_K, E):
        raise ValueError(f"moe_router takes 1 <= k <= min({MAX_K}, E={E}), "
                         f"got k={k}")
    if bt < 1:
        raise ValueError(f"bt must be positive, got {bt}")


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("moe_router").moe_router_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(logits, k, bt, launch=None):
    """Run the CUDA kernel on PyTorch's current stream, as ``launch``
    (default ``plan(...)`` of the shapes) says."""
    T, E = logits.shape
    if T > 2 ** 31 - 1 - bt:
        raise ValueError(f"T={T} exceeds the kernel's int32 row count")
    p = launch or plan(T, E, k, bt)
    if (p.T, p.bt) != (T, bt):
        raise ValueError(f"a plan for T={p.T}, bt={p.bt} given T={T}, "
                         f"bt={bt}")
    logits = logits.contiguous()
    dev = logits.device
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    stats = torch.empty((-(-T // bt), E), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                 stats.data_ptr(), T, E, k, bt, p.lanes, p.per_lane,
                 p.cluster, p.rows_per_block, p.threads, p.smem, stream)
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{err}")
    moe_router.launches += 1
    return w, idx, stats


def weights_grad(w, idx, g, E):
    """The logits' gradient [T, E] from the weights' gradient ``g`` [T,
    k], given the weights ``w`` and picks ``idx`` (module doc)."""
    dl = w * (g - (w * g).sum(-1, keepdim=True))
    return torch.zeros((w.shape[0], E), dtype=w.dtype,
                       device=w.device).scatter_(1, idx.long(), dl)


class MoeRouterFunction(torch.autograd.Function):
    """The kernel forward, the closed-form backward (module doc)."""

    @staticmethod
    def forward(ctx, logits, k, bt):
        w, idx, stats = _launch(logits, k, bt)
        ctx.mark_non_differentiable(idx, stats)
        ctx.save_for_backward(w, idx)
        ctx.E = logits.shape[1]
        return w, idx, stats

    @staticmethod
    def backward(ctx, g, _idx, _stats):
        w, idx = ctx.saved_tensors
        return weights_grad(w, idx, g, ctx.E), None, None


def moe_router(logits, k, *, bt=128):
    """Softmax + top-k + renormalise + per-tile stats (module doc)."""
    _check(logits, k, bt)
    bt = min(bt, logits.shape[0])
    if logits.device.type == "cuda":
        if needs_grad(logits):
            return MoeRouterFunction.apply(logits, k, bt)
        return _launch(logits, k, bt)
    if logits.device.type == "cpu":
        return moe_router_ref(logits, k, bt=bt)
    raise ValueError(f"moe_router runs on cuda or cpu, not {logits.device}")


# kernel launches since import or since the caller last set it to 0;
# the CPU path adds nothing
moe_router.launches = 0
