"""Plain PyTorch versions of the VFL first-layer matmul: what the CUDA
kernel computes, written with ordinary tensor ops.  The CPU path of the
wrapper runs them, and ``chip_smoke.py`` holds the kernel against them
on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def vfl_matmul_ref(x_local, w_full, offset: int):
    """zeropad(x_local) @ w_full, the literal Algorithm-1 computation
    (the port of ``repro.kernels.vfl_matmul.ref.vfl_matmul_ref``)."""
    k_local, k_full = x_local.shape[1], w_full.shape[0]
    x_pad = F.pad(x_local, (offset, k_full - offset - k_local))
    return x_pad @ w_full


def _ints(v):
    return v.tolist() if isinstance(v, torch.Tensor) else list(v)


def vfl_matmul_clients_ref(x, w, x_off, w_off, sizes):
    """Per-client slice form of the all-clients kernel:
    ``y[c] = x[:, x_off[c]:+sizes[c]] @ w[c, w_off[c]:+sizes[c]]``,
    [n, M, N]; a client of size 0 gets zeros.  The offsets and sizes
    are int sequences or tensors, read on the host."""
    outs = [x[:, xo:xo + s] @ w[c, wo:wo + s]
            for c, (xo, wo, s) in enumerate(zip(
                _ints(x_off), _ints(w_off), _ints(sizes)))]
    if not outs:
        return x.new_zeros((0, x.shape[0], w.shape[2]))
    return torch.stack(outs)
