"""One-card dry run: build every (architecture x input shape) step at
full size on the meta device (shapes and dtypes, no memory, no kernel
launched) and count what it would cost on one H100.  The port of
``repro.launch.dryrun``, which lowers and compiles each step for a
512-chip TPU mesh; here the step runs once on meta tensors under a
``roofline.costs.CostCounter``:

  train    make_train_step: Model.loss, its gradient, Adam over the tree
  prefill  Model.prefill
  decode   make_serve_step over a decode state of global_batch x seq_len

The kernels cannot run on meta tensors: the model gets
``roofline.costs.meta_hooks``, which return the kernels' output shapes
and count each kernel's work (``roofline.work``), its backward by a
stated rule.  The record keeps the reference's keys where they mean
something on one card; ``resident`` (weights, Adam moments, decode
state and batch) stands in for ``memory_analysis`` and is a lower bound
(activations are not counted).  Sharding (``--mesh``, ``--rules``) is
not ported.  ``--clients`` is the size of the emulated client axis of
the input block's exchange (16: the production mesh's ``model`` axis,
which the reference's ``client`` rule maps to).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k

It runs on the CPU (always on the meta device) and writes one JSON
record a (arch, shape) under ``build/dryrun/``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.serve import make_serve_step
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adam
from repro_torch.roofline import roofline_terms, summarize
from repro_torch.roofline.analysis import HBM_BYTES
from repro_torch.roofline.costs import BACKWARD_FACTOR, CostCounter, \
    meta_hooks
from repro_torch.tree import tree_leaves

ARCHS = [
    "qwen2-7b", "rwkv6-1.6b", "jamba-v0.1-52b", "deepseek-moe-16b",
    "llava-next-34b", "qwen1.5-0.5b", "mixtral-8x22b", "qwen1.5-4b",
    "gemma2-2b", "seamless-m4t-medium",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH = "1xH100"
LR = 1e-4  # Adam's counts do not depend on its value
RESIDENT_NOTE = ("weights, Adam moments, decode state and batch: a lower "
                 "bound; activations are not counted")
BACKWARD_RULE = (f"a kernel's backward counts {BACKWARD_FACTOR} x its "
                 "forward's operations and bytes (a GEMM's rule)")


def skip_reason(cfg, shape_name):
    INPUT_SHAPES[shape_name]          # an unknown shape raises KeyError
    if shape_name == "long_500k" and not cfg.sub_quadratic_decode:
        return ("pure full-attention arch: long_500k requires "
                "sub-quadratic attention (DESIGN.md section 4)")
    if shape_name == "long_500k" and cfg.is_encoder_decoder:
        return ("enc-dec speech model: 500k-token text decode out of "
                "family scope (DESIGN.md section 4)")
    return None


def model_step_flops(cfg, shape_name):
    """MODEL_FLOPS: 6*N_active*tokens for training, 2*N_active*tokens
    for inference (global, not per-chip)."""
    s = SP.input_shape(shape_name)
    n_active = cfg.param_counts()["active"]
    if s.kind == "train":
        return 6 * n_active * s.global_batch * s.seq_len
    if s.kind == "prefill":
        return 2 * n_active * s.global_batch * s.seq_len
    return 2 * n_active * s.global_batch  # decode: one token per seq


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def run_one(arch, shape, exchange=None, clients=16, cfg_overrides=None):
    """Build and count one (arch, shape) step on the meta device;
    returns a record dict.  ``shape`` is a name of ``INPUT_SHAPES`` or
    an ``InputShape`` (a shape the card runs, e.g. the training CLI's 8
    x 256)."""
    t0 = time.time()
    cfg = get_config(arch)
    if exchange:
        cfg = cfg.replace(vfl=cfg.vfl.__class__(enabled=True,
                                                exchange=exchange))
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    s = SP.input_shape(shape)
    record = {
        "arch": arch, "shape": s.name, "mesh": MESH,
        "exchange": cfg.vfl.exchange if cfg.vfl.enabled else "off",
        "kind": s.kind,
    }
    reason = skip_reason(cfg, s.name) if s.name in INPUT_SHAPES else None
    if reason:
        record["status"] = "skipped"
        record["reason"] = reason
        return record

    counter = CostCounter()
    model = build_model(cfg, clients=clients, **meta_hooks(counter))
    params = model.init_meta()
    resident = {"weights": _nbytes(params)}
    batch = SP.input_specs(cfg, s)
    if s.kind == "decode":
        state = model.init_decode_state(s.global_batch, s.seq_len,
                                        device="meta")
        resident["decode_state"] = _nbytes(state)
        with counter:
            make_serve_step(model)(params, state, batch["tokens"])
    elif s.kind == "prefill":
        batch.pop("labels")
        with counter:
            model.prefill(params, batch)
    else:
        opt = adam(LR, per_client=False)
        opt_state = opt.init(params)
        resident["adam_moments"] = _nbytes(opt_state)
        with counter:
            make_train_step(model, opt)(params, opt_state, 0, batch)
    resident["batch"] = _nbytes(batch)
    build_s = time.time() - t0

    tot = counter.totals()
    mf = model_step_flops(cfg, s)
    rl = roofline_terms(tot["flops"], tot["bytes"], 0.0,
                        model_flops_per_chip=mf,
                        fp32_flops=tot["fp32_flops"])
    prefix_rows = batch["prefix_emb"].shape[1] \
        if cfg.modality == "vision_text" and "prefix_emb" in batch else 0
    n_params = cfg.param_counts()
    total = sum(resident.values())
    record.update({
        "status": "ok",
        "n_chips": 1,
        "clients": clients,
        "per_chip_flops": tot["flops"],
        "per_chip_fp32_flops": tot["fp32_flops"],
        "per_chip_bytes": tot["bytes"],
        "collective_wire_bytes": {
            "total": 0.0,
            "exchange_bytes": model.exchange_bytes(
                tuple(batch["tokens"].shape), prefix_rows)},
        "kernels": tot["kernels"],
        "kernel_backward_rule": BACKWARD_RULE,
        "resident": {**resident, "total": total, "note": RESIDENT_NOTE},
        "fits_80GB": total <= HBM_BYTES,
        "roofline": rl,
        "params_total": n_params["total"],
        "params_active": n_params["active"],
        "build_s": round(build_s, 2),
    })
    return record


def result_path(record, out_dir):
    ex = record.get("exchange", "off")
    return os.path.join(
        out_dir, f"{record['arch']}__{record['shape']}__"
                 f"{record['mesh']}__{ex}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--exchange", default=None,
                    choices=[None, "zeropad_psum", "allgather"])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "save_mixer_ffn"])
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = SHAPES if args.shape == "all" else args.shape.split(",")
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape in shapes:
            probe = {"arch": arch, "shape": shape, "mesh": MESH,
                     "exchange": args.exchange or "zeropad_psum"}
            path = result_path(probe, args.out)
            if os.path.exists(path) and not args.force:
                with open(path) as f:
                    rec = json.load(f)
                print(f"[cached] {arch} {shape} {MESH}: "
                      f"{rec.get('status')}")
                continue
            try:
                ov = ({"remat_policy": args.remat_policy}
                      if args.remat_policy else None)
                rec = run_one(arch, shape, exchange=args.exchange,
                              clients=args.clients, cfg_overrides=ov)
                if rec["status"] == "ok":
                    print(f"[ok {rec['build_s']:.0f}s] " + summarize(rec))
                else:
                    print(f"[skip] {arch} {shape} {MESH}: "
                          f"{rec['reason']}")
            except Exception as e:
                failures += 1
                rec = dict(probe)
                rec["status"] = "error"
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["traceback"] = traceback.format_exc()[-4000:]
                print(f"[FAIL] {arch} {shape} {MESH}: {rec['error']}")
            with open(result_path(rec, args.out), "w") as f:
                json.dump(rec, f, indent=1, default=str)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
