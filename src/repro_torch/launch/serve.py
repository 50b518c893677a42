"""Serving entry point: batched single-token decode against a KV
cache.  The port of ``repro.launch.serve``.

Any architecture of the LM zoo (``--arch qwen2-7b``, ``--arch
deepseek-moe-16b``, ``--arch rwkv6-1.6b``, ``--arch jamba-v0.1-52b``,
``--arch llava-next-34b``, ``--arch seamless-m4t-medium``; mixtral-8x22b
and the full 32-layer jamba do not fit one card).  An encoder-decoder
(seamless) decodes over the zero encoder memory ``init_decode_state``
makes, as the reference's ``launch/serve.py`` does.  On the GPU, at
full width with random weights::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b

On the CPU, at the reduced size::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --device cpu --reduced
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.protocol import resolve_device
from repro_torch.models import build_model


def make_serve_step(model):
    def serve_step(params, state, tokens):
        logits, new_state = model.decode_step(params, state, tokens)
        next_tok = logits[:, -1, :].argmax(-1)[:, None]
        return next_tok.to(torch.int32), new_state
    return serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--cache", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.reduced:
        from repro_torch.configs.reduced import reduced_config
        cfg = reduced_config(args.arch)
    else:
        cfg = get_config(args.arch)
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    state = model.init_decode_state(args.batch, args.cache, device=device)
    step_fn = make_serve_step(model)
    toks = torch.zeros((args.batch, 1), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    out = []
    for _ in range(args.steps):
        toks, state = step_fn(params, state, toks)
        out.append(toks[:, 0])
    out = torch.stack(out).cpu()          # waits for the device
    dt = time.perf_counter() - t0
    print(f"decoded {args.steps} tokens x batch {args.batch} in {dt:.2f}s "
          f"({args.steps * args.batch / dt:.1f} tok/s) on {device}")
    print("sample:", [int(t[0]) for t in out[:8]])
    return out


if __name__ == "__main__":
    main()
