"""End-to-end training script: a ~100M-parameter qwen-family decoder
trained on the synthetic Markov LM stream with warmup+cosine schedule,
gradient clipping and checkpointing -- the full substrate stack in one
script.  The twin of ``examples/train_lm_e2e.py``.

Defaults are small (~20M params, 60 steps); --preset 100m trains the
~100M model.  Checkpoints go under the checkout's ``build/`` unless
--ckpt-dir names another directory; a run resumes from the newest one
there.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e
  PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e \\
      --preset 100m --steps 300
"""
import argparse
import math
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import load_checkpoint, latest_step, \
    save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import markov_lm_batches
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adam, linear_warmup_cosine

PRESETS = {
    # ~20M params
    "20m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
                head_dim=64, d_ff=1536, vocab_size=8192),
    # ~100M params
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=16384),
}
CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "lm_ckpt"


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return tree.numel()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("qwen1.5-0.5b").replace(
        remat=False, dtype="float32", **PRESETS[args.preset])
    model = build_model(cfg)
    opt = adam(linear_warmup_cosine(args.lr, 20, args.steps),
               per_client=False)
    step_fn = make_train_step(model, opt)

    params = model.init(torch.Generator(device).manual_seed(0))
    opt_state = opt.init(params)
    n_params = _count(params)
    print(f"model: {n_params/1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size})")

    start = 0
    if latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        params = load_checkpoint(args.ckpt_dir, start, params)
        print(f"resumed from checkpoint at step {start}")

    it = markov_lm_batches(cfg.vocab_size, args.batch, args.seq, seed=1)
    step = start
    t0 = time.time()
    losses = []
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(it).items()}
        params, opt_state, step, m = step_fn(params, opt_state, step, batch)
        loss = float(m["loss"])
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            tput = args.batch * args.seq * (i - start + 1) / \
                (time.time() - t0)
            print(f"step {i:4d}  loss {loss:.4f}  {tput:,.0f} tok/s")
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, i + 1, params)
            print(f"  checkpoint -> {path}")

    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform would be {math.log(cfg.vocab_size):.2f})")
    assert losses[-1] < losses[0], "training must reduce loss"
    return {"losses": losses, "params": n_params}


if __name__ == "__main__":
    main()
