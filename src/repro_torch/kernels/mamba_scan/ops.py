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

``mamba_scan_fused(dt, x, Bm, Cm, A, h0=None, *, h_out=None)`` is the
scan the Mamba mixer calls: it takes what the recurrence is made from,
dt [B, T, D] float32 (softplus's output), x [B, T, D] and Bm, Cm [B, T,
N] in one dtype (the model's: float32 or bfloat16), A [D, N] float32,
and forms a = exp(dt A) and bx = (dt x) B itself, so the [B, T, D, N]
float32 a and bx are never written to device memory; -> (y [B, T, D]
float32, h [B, D, N] float32), the semantics of ``mamba_scan_fused_ref``.
The same T, D, N and state rules; Bm and Cm may be row-strided views
(the slices of the x projection they come from) with unit stride in N.

On a CUDA tensor each launches its hand-written Hopper kernel
(``csrc/mamba_scan.cu``, one library, built at first use) or raises; on
a CPU tensor each runs its plain version in ``ref.py``.  There is no
other path.  Each counts its own launches (``mamba_scan.launches``,
``mamba_scan_fused.launches``).

Gradient: where an input of ``mamba_scan_fused`` requires grad, a CUDA
call runs through ``MambaScanFusedFunction`` (a
``torch.autograd.Function``): its forward is the fused kernel, launched
and counted as above; its backward recomputes ``mamba_scan_fused_ref``
from the saved inputs and differentiates it with PyTorch ops, launching
no kernel.  The JAX package's training autodiffs its plain scan and has
no backward kernel either.  Such a call refuses ``h_out``: a state
written in place has no gradient.  ``mamba_scan``, the unfused kernel
that no model path calls, stays forward only.  On the CPU autograd
differentiates the plain versions directly.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.grad import needs_grad, plain_vjp
from repro_torch.kernels.mamba_scan.ref import (
    mamba_scan_fused_ref, mamba_scan_ref)

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
    _check_state(B, D, N, h0, h_out, (a, bx, c))


def _check_state(B, D, N, h0, h_out, inputs):
    for name, s in (("h0", h0), ("h_out", h_out)):
        if s is not None and (s.shape != (B, D, N)
                              or s.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 [{B}, {D}, {N}], got "
                             f"{s.dtype} {tuple(s.shape)}")
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("h_out must be contiguous: the kernel writes the "
                         "state into it")
    devices = {t.device for t in (*inputs, h0, h_out) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"mamba_scan inputs on {sorted(map(str, devices))}")


# the C launchers' arguments (csrc/mamba_scan.cu)
_ARGTYPES = {
    "mamba_scan_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
    [ctypes.c_void_p],
    "mamba_scan_fused_launch": [ctypes.c_void_p] * 4 +
    [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
    [ctypes.c_void_p]}


@functools.lru_cache(maxsize=None)
def _kernel(name):
    from repro_torch.kernels import build
    fn = getattr(build.load("mamba_scan"), name)
    fn.argtypes = _ARGTYPES[name]
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
    fn = _kernel("mamba_scan_launch")
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


def _check_fused(dt, x, Bm, Cm, A, h0, h_out):
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"expected dt, x [B, T, D] of one shape, got "
                         f"{tuple(dt.shape)} and {tuple(x.shape)}")
    B, T, D = dt.shape
    if B < 1 or T < 1 or D < 1:
        raise ValueError(f"mamba_scan_fused needs B, T, D >= 1, got "
                         f"{tuple(dt.shape)}")
    if A.dim() != 2 or A.shape[0] != D or A.dtype != torch.float32:
        raise ValueError(f"A must be float32 [{D}, N], got {A.dtype} "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    if N not in STATE_DIMS:
        raise ValueError(f"mamba_scan_fused takes state dims {STATE_DIMS}, "
                         f"got {N}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.shape != (B, T, N):
            raise ValueError(f"{name} must be [{B}, {T}, {N}], got "
                             f"{tuple(t.shape)}")
    if dt.dtype != torch.float32 or x.dtype not in DTYPES or \
            Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"mamba_scan_fused takes dt in float32 and x, Bm, "
                        f"Cm in one of float32 or bfloat16; got {dt.dtype}, "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    _check_state(B, D, N, h0, h_out, (dt, x, Bm, Cm, A))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _row_strided(t):
    """``t`` [B, T, N] as the kernel reads it: unit stride in N, rows
    ``t.stride(1)`` apart and batches ``t.stride(0)`` apart, which the
    slices of the x projection already are; anything else is copied."""
    if t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) < t.shape[2]):
        t = t.contiguous()
    return t


def _launch_fused(dt, x, Bm, Cm, A, h0, h_out):
    B, T, D = dt.shape
    N = A.shape[1]
    if B > 65535:
        raise ValueError(f"B={B} exceeds the kernel's grid")
    dt, x, A = dt.contiguous(), x.contiguous(), A.contiguous()
    Bm, Cm = _row_strided(Bm), _row_strided(Cm)
    if Bm.stride() != Cm.stride():
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    h = h_out if h_out is not None else torch.empty(
        (B, D, N), dtype=torch.float32, device=dt.device)
    y = torch.empty((B, T, D), dtype=torch.float32, device=dt.device)
    size = x.element_size()
    states = [t for t in (A, h0, h) if t is not None]
    # T = 1 loads A, the state, B and C by 16 (or 8) bytes; T > 1 stages
    # dt, x, B and C rows by 16-byte copies
    rows = Bm.stride(0) * size % 16 == 0 and (
        T == 1 or Bm.stride(1) * size % 16 == 0)
    vec = rows and _aligned(*states, Bm, Cm) and (
        T == 1 or (D % 8 == 0 and _aligned(dt, x)))
    fn = _kernel("mamba_scan_fused_launch")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 Bm.stride(1), Bm.stride(0), A.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h.data_ptr(), B, T, D, N, int(x.dtype == torch.bfloat16),
                 int(vec), stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_fused kernel launch failed: CUDA "
                           f"error {err}")
    mamba_scan_fused.launches += 1
    return y, h


class MambaScanFusedFunction(torch.autograd.Function):
    """The fused kernel forward, the plain version's gradient (module
    doc)."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A, h0):
        ctx.save_for_backward(dt, x, Bm, Cm, A, h0)
        return _launch_fused(dt, x, Bm, Cm, A, h0, None)

    @staticmethod
    def backward(ctx, g_y, g_h):
        return plain_vjp(mamba_scan_fused_ref, ctx.saved_tensors,
                         ctx.needs_input_grad, (g_y, g_h))


def mamba_scan_fused(dt, x, Bm, Cm, A, h0=None, *, h_out=None):
    """The discretisation and the selective scan in one call (module
    doc): (y [B, T, D] float32, h [B, D, N] float32)."""
    _check_fused(dt, x, Bm, Cm, A, h0, h_out)
    if dt.device.type == "cuda":
        if needs_grad(dt, x, Bm, Cm, A, h0):
            if h_out is not None:
                raise ValueError("mamba_scan_fused: h_out with inputs that "
                                 "require grad; a state written in place "
                                 "has no gradient")
            return MambaScanFusedFunction.apply(dt, x, Bm, Cm, A, h0)
        return _launch_fused(dt, x, Bm, Cm, A, h0, h_out)
    if dt.device.type == "cpu":
        return mamba_scan_fused_ref(dt, x, Bm, Cm, A, h0, h_out=h_out)
    raise ValueError(f"mamba_scan_fused runs on cuda or cpu, not "
                     f"{dt.device}")


# kernel launches since import or since the caller last set it to 0;
# the CPU path adds nothing
mamba_scan_fused.launches = 0
