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

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/rwkv6_scan.cu``, built at first use) or raises; on a CPU tensor
it runs the plain version in ``ref.py``.  There is no other path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


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


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import build
    fn = build.load("rwkv6_scan").rwkv6_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(r, k, v, w, u, state, state_out):
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the rwkv6_scan kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if B * H > 2 ** 31 - 1:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid")
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.float().contiguous()
    if state is not None:
        state = state.contiguous()
    s_out = state_out if state_out is not None else torch.empty(
        (B, H, hd, hd), dtype=torch.float32, device=r.device)
    o = torch.empty_like(r)
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state is None else state.data_ptr(),
                 o.data_ptr(), s_out.data_ptr(), B, T, H, hd,
                 int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    rwkv6_scan.launches += 1
    return o, s_out


def rwkv6_scan(r, k, v, w, u, state=None, *, state_out=None):
    """The WKV recurrence over T with the state in and out (module
    doc): (o [B, T, H, hd], state [B, H, hd, hd] float32)."""
    _check(r, k, v, w, u, state, state_out)
    if r.device.type == "cuda":
        return _launch(r, k, v, w, u, state, state_out)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, state, state_out=state_out)
    raise ValueError(f"rwkv6_scan runs on cuda or cpu, not {r.device}")


# kernel launches since import or since the caller last set it to 0;
# the CPU path adds nothing
rwkv6_scan.launches = 0
