"""Public wrappers and gradient for the VFL first-layer matmul.

``vfl_matmul_clients(x, w, x_off, w_off, sizes)`` is the whole first
layer of every client:

  y[c] = x[:, x_off[c] : x_off[c]+sizes[c]] @ w[c, w_off[c] : w_off[c]+sizes[c]]

with x [M, Kx], w [n, Kw, N] and y [n, M, N] in float32, and the
offsets and sizes int32 [n] tensors on x's device.  On a CUDA tensor it
launches one of the hand-written Hopper kernels in ``csrc/vfl_matmul.cu``
(built at first use) or raises; on a CPU tensor it runs the plain
version in ``ref.py``.  There is no other path.  ``plan(M, Kx, Kw, N,
n)``, a function of the shapes alone, picks the kernel and its launch:

- ``wave``: at most ``WAVE_MAX_M`` rows and the widest slice fits in a
  block's shared memory: a block of ``WAVE_BM`` rows loads all of its
  client's slice at once, then multiplies (a training step's batch).
- ``ring``: otherwise: a block of ``RING_BM`` rows walks K through a
  ring of ``cp.async`` stages (the evaluation's test set, and any slice
  too wide for shared memory).

Both sum every output in the same order, so they give the same bits.

``vfl_matmul(x_local, w_full, offset, gate=None)`` keeps the JAX
package's signature (``repro.kernels.vfl_matmul.vfl_matmul``): one
client, ``x_off = 0``, ``w_off = offset``.

Gradient (``torch.autograd.Function``), the port of the reference's
custom VJP (``ops.py:_vfl_matmul_bwd``), in PyTorch ops:

  dW[c, w_off[c]+k] = x[:, x_off[c]+k]^T @ g[c]  for k < sizes[c],
                      exact +0.0 in every other row
  dx[:, x_off[c]+k] += g[c] @ W[c, w_off[c]+k]^T  (only when x needs it)

Both are written as gathers over the runtime offsets, so the backward
never reads an offset on the host.  The optional ``gate`` multiplies y
outside the Function, so gate 0 zeroes y, dx and dW, and gate 1 is a
bitwise identity.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.vfl_matmul.ref import vfl_matmul_clients_ref

# the kernels' tiles (csrc/vfl_matmul.cu's constants; its launcher
# refuses a plan that disagrees)
WAVE_BM = 16            # rows a wave block, one a thread
RING_BM, RING_TM = 64, 4  # rows a ring block, rows a ring thread
RING_BK, RING_STAGES = 32, 4
BN_MAX = 16             # columns of an N-tile
SMEM_MAX = 232448       # a block's shared memory on sm_90 (227 KB)
# the most rows the wave kernel takes: it led the ring up to 1,024 rows
# and trailed it at 4,096 (chip_smoke.py's ``crossover`` times both at
# mnist's layout)
WAVE_MAX_M = 1024


class Plan(NamedTuple):
    """How one call launches: the kernel (``wave`` or ``ring``), rows and
    columns a block (``bm``, ``bn``), threads a block, the wave kernel's
    shared-memory row stride of x (``ldx``, 0 for the ring), dynamic
    shared-memory bytes a block, and the grid (N-tiles, M-tiles,
    clients)."""
    kernel: str
    bm: int
    bn: int
    threads: int
    ldx: int
    smem: int
    grid: tuple


def _wave_ldx(kmax):
    """x's row stride in the wave kernel's shared memory: at least kmax,
    a multiple of 4 (16-byte copies) and 8 words past a multiple of 32,
    so the rows of a warp's threads fall in different banks."""
    return kmax + (8 - kmax) % 32


def plan(M, Kx, Kw, N, n) -> Plan:
    """The launch of x [M, Kx] against w [n, Kw, N] (module doc).  A
    slice is at most min(Kx, Kw) wide whatever the sizes, which lie on
    the device; the wave kernel's shared memory holds that much."""
    bn = max(1, min(N, BN_MAX))
    kmax = max(0, min(Kx, Kw))
    ldx = _wave_ldx(kmax)
    wave_smem = 4 * (WAVE_BM * ldx + kmax * N + 3)
    if M <= WAVE_MAX_M and wave_smem <= SMEM_MAX:
        kernel, bm, threads, smem = "wave", WAVE_BM, WAVE_BM * bn, wave_smem
    else:
        kernel, bm, ldx = "ring", RING_BM, 0
        threads = RING_BM // RING_TM * bn
        smem = 4 * RING_STAGES * (RING_BM * (RING_BK + 4) + RING_BK * BN_MAX)
    return Plan(kernel, bm, bn, threads, ldx, smem,
                (-(-N // bn), -(-M // bm), n))


def _check(x, w, x_off, w_off, sizes):
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"vfl_matmul takes float32 only, got x {x.dtype} "
                        f"and w {w.dtype}")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"expected x [M, Kx] and w [n, Kw, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n = w.shape[0]
    for name, t in (("x_off", x_off), ("w_off", w_off), ("sizes", sizes)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (w, x_off, w_off, sizes):
        if t.device != x.device:
            raise ValueError(f"vfl_matmul inputs on {x.device} and "
                             f"{t.device}")


# the C launchers' arguments (csrc/vfl_matmul.cu)
_ARGTYPES = {"vfl_matmul_launch": [ctypes.c_void_p] * 6 +
             [ctypes.c_int] * 11 + [ctypes.c_void_p],
             "vfl_matmul_empty_launch": [ctypes.c_void_p]}


@functools.lru_cache(maxsize=None)
def _kernel(name):
    from repro_torch.kernels import build
    fn = getattr(build.load("vfl_matmul"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w, x_off, w_off, sizes, launch=None):
    """Run the CUDA kernel on PyTorch's current stream, as ``launch``
    (default ``plan(...)`` of the shapes) says."""
    tensors = (x, w, x_off, w_off, sizes)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("vfl_matmul's kernel takes contiguous tensors")
    n, kw, big_n = w.shape
    m, kx = x.shape
    p = launch or plan(m, kx, kw, big_n, n)
    if -(-m // p.bm) > 65535 or n > 65535:
        raise ValueError(f"M={m} rows or {n} clients exceed the kernel's "
                         f"grid")
    fn = _kernel("vfl_matmul_launch")
    y = torch.empty((n, m, big_n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), y.data_ptr(),
                 n, m, kx, kw, big_n, int(p.kernel == "ring"), p.bm, p.bn,
                 p.threads, p.ldx, p.smem, stream)
    if err != 0:
        raise RuntimeError(f"vfl_matmul kernel launch failed: CUDA error "
                           f"{err}")
    vfl_matmul_clients.launches += 1
    return y


def empty_launch(device=None):
    """Launch an empty kernel (one block of 32 threads) on the current
    stream: the launch floor chip_smoke.py times beside the kernels.  It
    computes nothing and is not counted."""
    with torch.cuda.device(device):
        err = _kernel("vfl_matmul_empty_launch")(
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def _forward(x, w, x_off, w_off, sizes):
    _check(x, w, x_off, w_off, sizes)
    if x.device.type == "cuda":
        return _launch(x, w, x_off, w_off, sizes)
    if x.device.type == "cpu":
        return vfl_matmul_clients_ref(x, w, x_off, w_off, sizes)
    raise ValueError(f"vfl_matmul runs on cuda or cpu, not {x.device}")


def _gather_rows(src, dst_len, src_off, dst_off, sizes):
    """Per client c, the rows of ``src`` [n_src, ..] that the slice maps
    onto ``dst_len`` rows: row ``dst_off[c]+k`` takes ``src_off[c]+k``
    for k < sizes[c]; returns (index [n, dst_len], valid [n, dst_len])."""
    rows = torch.arange(dst_len, device=sizes.device)
    k = rows[None, :] - dst_off.long()[:, None]
    valid = (k >= 0) & (k < sizes.long()[:, None])
    idx = (src_off.long()[:, None] + k).clamp(0, src.shape[-2] - 1)
    return idx, valid


class _VflMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, x_off, w_off, sizes):
        ctx.save_for_backward(x, w, x_off, w_off, sizes)
        return _forward(x, w, x_off, w_off, sizes)

    @staticmethod
    def backward(ctx, g):
        x, w, x_off, w_off, sizes = ctx.saved_tensors
        g = g.contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        if x.shape[1] == 0 or w.shape[1] == 0:     # every slice is empty
            return (torch.zeros_like(x) if need_dx else None,
                    torch.zeros_like(w) if need_dw else None,
                    None, None, None)
        dx = dw = None
        if need_dw:
            # x zero-padded into each client's W-row coordinates
            idx, valid = _gather_rows(x.T, w.shape[1], x_off, w_off, sizes)
            xw = torch.where(valid[:, :, None], x.T[idx], 0.0)  # [n,Kw,M]
            dw = torch.where(valid[:, :, None], torch.bmm(xw, g), 0.0)
        if need_dx:
            idx, valid = _gather_rows(w, x.shape[1], w_off, x_off, sizes)
            clients = torch.arange(w.shape[0], device=w.device)[:, None]
            wx = torch.where(valid[:, :, None], w[clients, idx], 0.0)
            dx = torch.bmm(g, wx.transpose(1, 2)).sum(0)     # [M, Kx]
        return dx, dw, None, None, None


def vfl_matmul_clients(x, w, x_off, w_off, sizes):
    """[n, M, N] first-layer outputs of every client (module doc)."""
    return _VflMatmul.apply(x, w, x_off, w_off, sizes)


# kernel launches since import or since the caller last set it to 0;
# the CPU path and the backward add nothing
vfl_matmul_clients.launches = 0


def vfl_matmul(x_local, w_full, offset: int, gate=None):
    """y = zeropad(x_local) @ w_full without materializing the padding:
    ``x_local @ w_full[offset:offset+K_local]`` through the all-clients
    kernel with one client.  ``gate`` (a scalar or 0-d tensor, e.g. a
    client_mask entry) multiplies y outside the gradient."""
    k_local, k_full = x_local.shape[1], w_full.shape[0]
    if not 0 <= offset <= k_full - k_local:
        raise ValueError(f"slice [{offset}, {offset + k_local}) is outside "
                         f"w_full's {k_full} rows")
    dev = x_local.device
    ints = [torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (0, offset, k_local)]
    y = vfl_matmul_clients(x_local, w_full.unsqueeze(0), *ints)[0]
    if gate is not None:
        y = y * torch.as_tensor(gate, dtype=y.dtype, device=dev)
    return y
