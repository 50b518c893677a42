"""Public wrapper for the Mamba selective scan.

``mamba_scan(a, bx, c, h0=None, *, h_out=None)``: a, bx [B, T, D, N] and
c [B, T, N] in one dtype (float32 or bfloat16), h0 [B, D, N] float32 or
None (zeros) -> (y [B, T, D] in a's dtype, final h [B, D, N] float32);
the semantics of ``mamba_scan_ref`` (``ref.py``).  The JAX package's
``repro.kernels.mamba_scan.mamba_scan`` starts from zeros and returns y
only; serving needs the state in and out: prefill keeps the final h in
the decode cache, and every decode step (T = 1) starts from it and
writes the new h over it in place (``h_out=h0``).  It takes any T >= 1
and D >= 1 (the Pallas kernel asks T % chunk == 0 and D % bd == 0) and
N 8 or 16.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/mamba_scan.cu``, built at first use) or raises; on a CPU tensor
it runs the plain version in ``ref.py``.  There is no other path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

STATE_DIMS = (8, 16)
DTYPES = (torch.float32, torch.bfloat16)


def _check(a, bx, c, h0, h_out):
    if a.dim() != 4 or bx.shape != a.shape:
        raise ValueError(f"expected a, bx [B, T, D, N] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(bx.shape)}")
    B, T, D, N = a.shape
    if B < 1 or T < 1 or D < 1 or N < 1:
        raise ValueError(f"mamba_scan needs B, T, D, N >= 1, got "
                         f"{tuple(a.shape)}")
    if c.shape != (B, T, N):
        raise ValueError(f"c must be [{B}, {T}, {N}], got {tuple(c.shape)}")
    if a.dtype not in DTYPES or bx.dtype != a.dtype or c.dtype != a.dtype:
        raise TypeError(f"mamba_scan takes float32 or bfloat16, one dtype "
                        f"for a, bx and c; got {a.dtype}, {bx.dtype}, "
                        f"{c.dtype}")
    for name, s in (("h0", h0), ("h_out", h_out)):
        if s is not None and (s.shape != (B, D, N)
                              or s.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 [{B}, {D}, {N}], got "
                             f"{s.dtype} {tuple(s.shape)}")
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("h_out must be contiguous: the kernel writes the "
                         "state into it")
    devices = {t.device for t in (a, bx, c, h0, h_out) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"mamba_scan inputs on {sorted(map(str, devices))}")


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("mamba_scan").mamba_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, bx, c, h0, h_out):
    B, T, D, N = a.shape
    if N not in STATE_DIMS:
        raise ValueError(f"the mamba_scan kernel takes state dims "
                         f"{STATE_DIMS}, got {N}")
    if B > 65535:
        raise ValueError(f"B={B} exceeds the kernel's grid")
    a, bx, c = a.contiguous(), bx.contiguous(), c.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    h = h_out if h_out is not None else torch.empty(
        (B, D, N), dtype=torch.float32, device=a.device)
    y = torch.empty((B, T, D), dtype=a.dtype, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), bx.data_ptr(), c.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h.data_ptr(), B, T, D, N, int(a.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    mamba_scan.launches += 1
    return y, h


def mamba_scan(a, bx, c, h0=None, *, h_out=None):
    """The selective scan over T with the state in and out (module
    doc): (y [B, T, D], h [B, D, N] float32)."""
    _check(a, bx, c, h0, h_out)
    if a.device.type == "cuda":
        return _launch(a, bx, c, h0, h_out)
    if a.device.type == "cpu":
        return mamba_scan_ref(a, bx, c, h0, h_out=h_out)
    raise ValueError(f"mamba_scan runs on cuda or cpu, not {a.device}")


# kernel launches since import or since the caller last set it to 0;
# the CPU path adds nothing
mamba_scan.launches = 0
