"""Public wrapper for the RWKV6 WKV scan.

``rwkv6_scan(r, k, v, w, u, state=None, *, state_out=None)``: r, k, v, w
[B, T, H, hd] in one dtype (float32 or bfloat16), u [H, hd], state
[B, H, hd, hd] float32 or None (zeros) -> (o [B, T, H, hd] in r's
dtype, final state [B, H, hd, hd] float32); the semantics of
``rwkv6_scan_ref`` (``ref.py``).  The JAX package's
``repro.kernels.rwkv6_scan.rwkv6_scan`` starts from zeros and returns o
only; serving needs the state in and out: prefill keeps the final state
in the decode cache, and decode starts from it and writes the new state
over it in place (``state_out=state``).  It takes any T >= 1 (the
Pallas kernel asks T % chunk == 0) and hd 64 or 128.

On a CUDA tensor it launches the hand-written Hopper kernels
(``csrc/rwkv6_scan.cu``, built at first use) or raises; on a CPU tensor
it runs the plain version ``rwkv6_scan_ref`` in ``ref.py``.  There is
no other path.  On the card ``route(B, T, H, hd)``, a function of the
shape alone, picks the kernels:

- ``sequential``: one block per (b, h) walks the T steps in order; a
  decode step (T = 1) and any T under ``CHUNKED_MIN_T``.
- ``chunked``: three kernels over chunks of ``CHUNK`` steps (each
  chunk's decay products and summary, the scan over chunks into a
  float32 scratch buffer of every chunk's start state, then every
  chunk's outputs replayed from its start state in parallel); the
  algorithm of ``rwkv6_scan_chunked_ref``.  Prefills.

Either route adds one to ``rwkv6_scan.launches`` per call.

Gradient: where an input requires grad, a CUDA call runs through
``Rwkv6ScanFunction`` (a ``torch.autograd.Function``): its forward is
the kernels of ``route``, launched and counted as above; its backward
recomputes ``rwkv6_scan_ref`` from the saved inputs and differentiates
it with PyTorch ops, launching no kernel.  The JAX package's training
autodiffs its plain scan and has no backward kernel either.  Such a
call refuses ``state_out``: a state written in place has no gradient.
On the CPU autograd differentiates the plain version directly.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.grad import needs_grad, plain_vjp
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# the chunked kernels' chunk length (rwkv6_scan.cu's CHUNK), and the
# shortest T the wrapper sends them: the sequential kernel wins at T = 16
# and loses from T = 32 on (chip_smoke.py's ``route_crossover`` times both
# at B = 1, H = 32, hd = 64)
CHUNK = 64
CHUNKED_MIN_T = 32


def route(B, T, H, hd) -> str:
    """The kernels a CUDA call of r [B, T, H, hd] runs (module doc)."""
    return "chunked" if T >= CHUNKED_MIN_T else "sequential"


def _check(r, k, v, w, u, state, state_out):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"expected r, k, v, w [B, T, H, hd] of one shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, hd = r.shape
    if B < 1 or T < 1 or H < 1:
        raise ValueError(f"rwkv6_scan needs B, T, H >= 1, got "
                         f"{tuple(r.shape)}")
    if r.dtype not in DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"rwkv6_scan takes float32 or bfloat16, one dtype "
                        f"for r, k, v and w; got "
                        f"{[t.dtype for t in (r, k, v, w)]}")
    if u.shape != (H, hd):
        raise ValueError(f"u must be [{H}, {hd}], got {tuple(u.shape)}")
    for name, s in (("state", state), ("state_out", state_out)):
        if s is not None and (s.shape != (B, H, hd, hd)
                              or s.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 [{B}, {H}, {hd}, "
                             f"{hd}], got {s.dtype} {tuple(s.shape)}")
    if state_out is not None and not state_out.is_contiguous():
        raise ValueError("state_out must be contiguous: the kernel writes "
                         "the state into it")
    devices = {t.device for t in (r, k, v, w, u, state, state_out)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"rwkv6_scan inputs on {sorted(map(str, devices))}")


# C launcher -> its arguments after the four input pointers
_LAUNCHERS = {
    "rwkv6_scan_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5,
    "rwkv6_scan_chunked_launch":
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6,
}


@functools.lru_cache(maxsize=None)
def _kernel(name):
    """The C launcher ``name``, its library built at first use."""
    from repro_torch.kernels import build
    fn = getattr(build.load("rwkv6_scan"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + _LAUNCHERS[name] + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    """``t`` contiguous with its base on 16 bytes, as the chunked
    kernels' cp.async reads it (a copy only where not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(route_name, r, k, v, w, u, state, state_out):
    """The kernels of ``route_name`` on checked CUDA inputs; counts one
    launch.  ``rwkv6_scan`` calls it with ``route(*r.shape)``."""
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the rwkv6_scan kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    nC = -(-T // CHUNK)
    if B * H * nC > 2 ** 31 - 1:
        raise ValueError(f"B * H * chunks = {B * H * nC} exceeds the "
                         f"kernel's grid")
    r, k, v, w = (_aligned(t) for t in (r, k, v, w))
    u = u.float().contiguous()
    if state is not None:
        state = state.contiguous()
    s_out = state_out if state_out is not None else torch.empty(
        (B, H, hd, hd), dtype=torch.float32, device=r.device)
    o = torch.empty_like(r)
    args = [r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            o.data_ptr(), s_out.data_ptr()]
    if route_name == "chunked":
        slots = torch.empty((B, H, nC, hd, hd), dtype=torch.float32,
                            device=r.device)
        decay = torch.empty((B, H, nC, hd), dtype=torch.float32,
                            device=r.device)
        args += [slots.data_ptr(), decay.data_ptr(), B, T, H, hd, CHUNK]
        fn = _kernel("rwkv6_scan_chunked_launch")
    elif route_name == "sequential":
        args += [B, T, H, hd]
        fn = _kernel("rwkv6_scan_launch")
    else:
        raise ValueError(f"unknown rwkv6_scan route {route_name!r}")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan {route_name} launch failed: CUDA "
                           f"error {err}")
    rwkv6_scan.launches += 1
    return o, s_out


class Rwkv6ScanFunction(torch.autograd.Function):
    """The kernels forward, the plain version's gradient (module doc)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return _launch(route(*r.shape), r, k, v, w, u, state, None)

    @staticmethod
    def backward(ctx, g_o, g_state):
        return plain_vjp(rwkv6_scan_ref, ctx.saved_tensors,
                         ctx.needs_input_grad, (g_o, g_state))


def rwkv6_scan(r, k, v, w, u, state=None, *, state_out=None):
    """The WKV recurrence over T with the state in and out (module
    doc): (o [B, T, H, hd], state [B, H, hd, hd] float32)."""
    _check(r, k, v, w, u, state, state_out)
    if r.device.type == "cuda":
        if needs_grad(r, k, v, w, u, state):
            if state_out is not None:
                raise ValueError("rwkv6_scan: state_out with inputs that "
                                 "require grad; a state written in place "
                                 "has no gradient")
            return Rwkv6ScanFunction.apply(r, k, v, w, u, state)
        return _launch(route(*r.shape), r, k, v, w, u, state, state_out)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, state, state_out=state_out)
    raise ValueError(f"rwkv6_scan runs on cuda or cpu, not {r.device}")


# kernel launches since import or since the caller last set it to 0;
# the CPU path adds nothing
rwkv6_scan.launches = 0
