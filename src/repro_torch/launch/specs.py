"""Meta-device stand-ins for every model input, per (arch x input
shape): the port of ``repro.launch.specs``, with tensors on the meta
device (shape and dtype, no memory) in place of ``ShapeDtypeStruct``.
The dry run (``launch/dryrun.py``) builds its steps on these, and
``concretize`` turns them into zeros on a real device, so shapes
cannot diverge between the dry run and a run.
"""
from __future__ import annotations

import torch

from repro_torch.configs import INPUT_SHAPES, InputShape


def input_shape(shape) -> InputShape:
    """``shape``: a name of ``INPUT_SHAPES``, or an ``InputShape`` (a
    shape outside the table, e.g. the one the card trains at)."""
    return shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]


def sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_spec(cfg, shape_name):
    """Inputs for one train/prefill step.

    vlm: seq = prefix image tokens + text tokens (anyres tiling);
    audio: decoder sees seq_len text tokens, encoder num_prefix frames.
    """
    s = input_shape(shape_name)
    B, S = s.global_batch, s.seq_len
    batch = {}
    if cfg.modality == "vision_text":
        P = min(cfg.num_prefix_embeddings, S // 2)
        batch["prefix_emb"] = sds((B, P, cfg.d_model), torch.bfloat16)
        batch["tokens"] = sds((B, S - P), torch.int32)
        batch["labels"] = sds((B, S - P), torch.int32)
    elif cfg.modality == "audio_text":
        batch["prefix_emb"] = sds((B, cfg.num_prefix_embeddings,
                                   cfg.d_model), torch.bfloat16)
        batch["tokens"] = sds((B, S), torch.int32)
        batch["labels"] = sds((B, S), torch.int32)
    else:
        batch["tokens"] = sds((B, S), torch.int32)
        batch["labels"] = sds((B, S), torch.int32)
    return batch


def decode_batch_spec(cfg, shape_name):
    s = input_shape(shape_name)
    return {"tokens": sds((s.global_batch, 1), torch.int32)}


def input_specs(cfg, shape_name):
    s = input_shape(shape_name)
    if s.kind == "decode":
        return decode_batch_spec(cfg, shape_name)
    return train_batch_spec(cfg, shape_name)


def concretize(spec_tree, seed=0, device=None):
    """Zeros of each spec's shape and dtype on ``device`` (CUDA unless
    the caller names another), as the reference's ``concretize`` (whose
    ``seed`` draws nothing either)."""
    from repro_torch.core.protocol import resolve_device
    from repro_torch.tree import tree_map
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), spec_tree)
