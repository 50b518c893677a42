"""Quickstart: build an assigned architecture (reduced), train a few
steps on the synthetic LM stream, then decode with a KV cache.  The
twin of ``examples/quickstart_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart_lm \\
      --arch gemma2-2b [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.reduced import reduced_config
from repro_torch.data import markov_lm_batches
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = reduced_config(args.arch)
    print(f"arch={cfg.name} family={cfg.family} "
          f"(reduced: {cfg.num_layers}L d={cfg.d_model})")
    model = build_model(cfg)
    opt = adam(1e-3, per_client=False)
    params = model.init(torch.Generator(device).manual_seed(0))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)

    it = markov_lm_batches(cfg.vocab_size, 4, 64)
    step = 0
    losses = []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(it).items()}
        if cfg.modality != "text":
            batch["prefix_emb"] = torch.zeros(
                (4, cfg.num_prefix_embeddings, cfg.d_model), device=device)
        params, opt_state, step, m = step_fn(params, opt_state, step, batch)
        losses.append(m["loss"])
        if i % 5 == 0:
            print(f"  step {i:3d}  loss {float(m['loss']):.4f}")

    # decode 8 tokens
    state = model.init_decode_state(2, 32, device=device)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=device)
    out = []
    for _ in range(8):
        logits, state = model.decode_step(params, state, toks)
        toks = logits[:, -1:].argmax(-1).to(torch.int32)
        out.append(int(toks[0, 0]))
    print("greedy decode:", out)
    return {"losses": torch.stack(losses).tolist(), "decoded": out}


if __name__ == "__main__":
    main()
