"""Public wrappers and gradient for the VFL first-layer matmul.

``vfl_matmul_clients(x, w, x_off, w_off, sizes)`` is the whole first
layer of every client:

  y[c] = x[:, x_off[c] : x_off[c]+sizes[c]] @ w[c, w_off[c] : w_off[c]+sizes[c]]

with x [M, Kx], w [n, Kw, N] and y [n, M, N] in float32, and the
offsets and sizes int32 [n] tensors on x's device.  On a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/vfl_matmul.cu``, built
at first use) or raises; on a CPU tensor it runs the plain version in
``ref.py``.  There is no other path.

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

import torch

from repro_torch.kernels.vfl_matmul.ref import vfl_matmul_clients_ref


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


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("vfl_matmul").vfl_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w, x_off, w_off, sizes):
    """Run the CUDA kernel on PyTorch's current stream."""
    tensors = (x, w, x_off, w_off, sizes)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("vfl_matmul's kernel takes contiguous tensors")
    n, kw, big_n = w.shape
    m, kx = x.shape
    if -(-m // 64) > 65535:
        raise ValueError(f"M={m} rows exceed the kernel's grid")
    fn = _kernel()
    y = torch.empty((n, m, big_n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), y.data_ptr(),
                 n, m, kx, kw, big_n, stream)
    if err != 0:
        raise RuntimeError(f"vfl_matmul kernel launch failed: CUDA error "
                           f"{err}")
    vfl_matmul_clients.launches += 1
    return y


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
