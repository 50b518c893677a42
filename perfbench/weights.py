"""The served weights, drawn by the benchmark from ``--seed`` on the card.

The tree's layout (keys, shapes, dtypes) is the program's parameter
format, read from ``Model.init_meta()`` (no number drawn).  The numbers
are the benchmark's: every matrix is one slice of a flat buffer per
dtype, filled with standard normals in a few large calls of a CUDA
generator, in the dtype it is served in, then scaled by its fan-in to
the -1/2 (the table by its width to the -1/2; the Mamba convolution by
0.1); norm scales and the Mamba skip D are ones, biases zeros, and
A_log is log(1 .. N), the S4D-real initialisation.  The reference reads
the same tensors.
"""
from __future__ import annotations

import torch

MATRICES = ("kernel", "table", "in_proj", "x_proj", "dt_proj", "out_proj",
            "conv", "w_gate", "w_up", "w_down")
CHUNK = 1 << 30          # normals a draw


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree


def draw(meta, seed, device):
    """The tree ``meta`` (meta tensors) filled on ``device`` from
    ``seed``; returns (params, number of weights)."""
    params = _copy_tree(meta)
    gen = torch.Generator(device).manual_seed(int(seed))
    normal = {}
    for path, t in leaves(meta):
        key = path[-1]
        if key in MATRICES:
            normal.setdefault(t.dtype, []).append((path, t))
        elif key in ("scale", "D"):
            _set(params, path, torch.ones(t.shape, dtype=t.dtype,
                                          device=device))
        elif key in ("bias", "dt_bias"):
            _set(params, path, torch.zeros(t.shape, dtype=t.dtype,
                                           device=device))
        elif key == "A_log":
            n = t.shape[-1]
            row = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                         device=device))
            _set(params, path, row.to(t.dtype).expand(t.shape).contiguous())
        else:
            raise KeyError(f"no rule to draw the weight {'/'.join(path)}")
    for dtype, items in normal.items():
        total = sum(t.numel() for _, t in items)
        flat = torch.empty(total, dtype=dtype, device=device)
        for a in range(0, total, CHUNK):
            flat[a:a + CHUNK].normal_(generator=gen)
        at = 0
        for path, t in items:
            view = flat[at:at + t.numel()].view(t.shape)
            at += t.numel()
            key = path[-1]
            scale = 0.1 if key == "conv" else \
                t.shape[-1] ** -0.5 if key == "table" else \
                t.shape[-2] ** -0.5
            view.mul_(scale)
            _set(params, path, view)
    count = sum(t.numel() for _, t in leaves(params))
    return params, count
