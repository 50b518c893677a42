"""Tree checkpointing to .npz: the port of ``repro.checkpoint``.

A tree (dicts, NamedTuples such as ``LayoutArrays``, lists and tuples,
with tensors or numpy arrays at the leaves) is flattened to
'/'-joined path keys -- sorted dict keys, NamedTuple attribute names,
sequence indices -- exactly the keys the reference writes for the same
tree, so a checkpoint written by one package loads in the other.
Tensors go to the host as numpy; ``load_checkpoint`` puts each leaf
back in the like leaf's dtype and on its device.  An empty subtree
(the sync path's ``sched={}``) writes no key.

Saves are atomic (tmp + ``os.replace``).  A file that exists but cannot
be read back -- a truncated write, not an npz at all -- raises
:class:`CheckpointCorruptError` from every read path; a missing file
raises FileNotFoundError.  ``checkpoint_steps`` lists every step on
disk so ``Session.resume`` can walk back to the newest intact one.
"""
from __future__ import annotations

import os
import re
import tempfile
import zipfile
import zlib

import numpy as np
import torch

from repro_torch.interop import array_from_tensor, tensor_from_array

_READ_ERRORS = (zipfile.BadZipFile, zlib.error, ValueError, OSError,
                EOFError)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but cannot be read back -- truncated
    write, disk corruption, or not an npz archive.  The message names
    the file; delete it (or let ``Session.resume()`` skip it) and fall
    back to an older step."""


def _corrupt(path, e):
    return CheckpointCorruptError(
        f"checkpoint {path} is corrupt or truncated "
        f"({type(e).__name__}: {e}); delete it and resume from an "
        "older step")


def _open_npz(path):
    """np.load with corrupt-file detection."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        data = np.load(path, allow_pickle=False)
        data.files     # force the zip central directory to parse
        return data
    except _READ_ERRORS + (KeyError,) as e:
        raise _corrupt(path, e) from e


def _read(data, path, key):
    """One member; decompression is lazy, so a truncated member
    surfaces here, not at open."""
    try:
        return data[key]
    except _READ_ERRORS as e:
        raise _corrupt(path, e) from e


def _children(tree):
    """(key part, child) pairs of an inner node in the reference's
    order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    if tree is None:
        return []
    return None


def _flat_with_paths(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for part, child in kids:
        yield from _flat_with_paths(child, prefix + (part,))


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return array_from_tensor(leaf)
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    flat = {}
    for key, leaf in _flat_with_paths(tree):
        if key in flat:
            raise ValueError(f"duplicate flattened key {key!r}; tree "
                             "paths must be unique after '/'-joining")
        flat[key] = _to_numpy(leaf)
    return flat


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken from ``leaves``."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {part: _rebuild(c, leaves) for part, c in kids}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(c, leaves) for _, c in kids))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(c, leaves) for _, c in kids)
    return None


def _path(directory, step, name):
    return os.path.join(directory, f"{name}_{step:08d}.npz")


def save_checkpoint(directory, step, tree, name="state"):
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = _path(directory, step, name)
    # suffix must be .npz or np.savez appends one and the rename misses
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def checkpoint_steps(directory, name="state"):
    """All checkpoint steps present in ``directory``, ascending
    (``[]`` if none / no directory).  Presence only -- a listed step
    may still raise CheckpointCorruptError when read."""
    if not directory or not os.path.isdir(directory):
        return []
    pat = re.compile(rf"{name}_(\d+)\.npz$")
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := pat.match(f)))


def latest_step(directory, name="state"):
    steps = checkpoint_steps(directory, name=name)
    return steps[-1] if steps else None


def load_entry(directory, step, key, name="state"):
    """One flattened entry of a saved checkpoint as numpy (None if it
    has no such key): lets callers verify stamps before a structured
    load."""
    path = _path(directory, step, name)
    with _open_npz(path) as data:
        return _read(data, path, key) if key in data.files else None


def load_checkpoint(directory, step, like_tree, name="state"):
    """Restore into the structure of ``like_tree``: every leaf in the
    like leaf's dtype, tensors on the like leaf's device, numpy leaves
    as numpy."""
    path = _path(directory, step, name)
    with _open_npz(path) as data:
        leaves = []
        for key, leaf in _flat_with_paths(like_tree):
            if key not in data.files:
                raise ValueError(
                    f"checkpoint {path} has no entry {key!r}; the "
                    "like_tree structure does not match the saved tree "
                    f"(saved keys: {sorted(data.files)[:8]}...)")
            arr = _read(data, path, key)
            if arr.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"shape mismatch for {key!r}: checkpoint has "
                    f"{arr.shape}, like_tree expects "
                    f"{tuple(np.shape(leaf))} (padded client axes must "
                    "be restored into a like_tree of the same padded "
                    "width)")
            if isinstance(leaf, torch.Tensor):
                leaves.append(tensor_from_array(arr, leaf.device,
                                                leaf.dtype))
            else:
                leaves.append(arr.astype(np.asarray(leaf).dtype))
    return _rebuild(like_tree, iter(leaves))
