"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   requires CUDA (exits 1 without it), prints nvidia-smi's
              name and power limit, the torch and CUDA versions, and
              the TF32 switches (both off: the reference is float32)
  2. build    builds every kernel from the sources in this checkout
  3. kernel   holds each kernel against its plain PyTorch version at
              the shapes the training path gives it (forward, dx, dW,
              gate 0 and 1) and times kernel, plain version, bound and
              one library call on the same inputs
  4. train    trains the paper's MNIST federation (784 -> 3x10 -> 10,
              5 clients, 70,000 samples, 2 rounds) through the kernel
              lane with every launch count set to 0 just before and
              read just after; then reruns round 1 from the same
              weights and batches on the kernel lane (bitwise) and the
              slice lane (allclose)

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
...}`` line.  Any failed check raises, so the script exits non-zero
and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores, the type these kernels compute in
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# kernel vs plain version: float32 with a different summation order,
# the tolerance tests/test_kernels.py uses for float32
KERNEL_TOL = 2e-5
# kernel lane vs slice lane, per-step losses over one 875-step round:
# float32 in another summation order in layer 0 only (9.1e-7 measured
# on an NVIDIA H100 80GB HBM3, power limit 700 W)
LANE_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def max_err(a, b) -> float:
    return float((a.detach() - b.detach()).abs().max()) if a.numel() else 0.0


def assert_close(name, got, ref) -> float:
    scale = max(1.0, float(ref.detach().abs().max())) if ref.numel() else 1.0
    err = max_err(got, ref)
    ok = torch.allclose(got, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL * scale)
    check(ok, f"{name}: max |kernel - plain| = {err} (atol "
          f"{KERNEL_TOL * scale}, rtol {KERNEL_TOL})")
    return err


def _events_ms(run, calls) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def eager_ms(fn, iters) -> float:
    """ms per call of ``fn`` called ``iters`` times from Python, warm,
    by CUDA events: where the host issues slower than the device runs,
    this is the host's time per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def device_ms(fn, calls=100, replays=5) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    time is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(replays):
            graph.replay()
    return _events_ms(run, calls * replays)


# ---------------------------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on a GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "nvidia_smi": card,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": r["seconds"],
                             "cached": r["seconds"] == 0.0,
                             "ptxas": [ln.strip() for ln in r["log"].splitlines()
                                       if "registers" in ln or "spill" in ln]}
                      for name, r in built.items()}})


# ---------------------------------------------------------------------------
def _clients_case(M, sizes, N, gen, kx_extra=0):
    """Inputs of the all-clients kernel at the protocol's layout: each
    client's slice at its canonical offset in x and in its W."""
    offs = [0]
    for s in sizes[:-1]:
        offs.append(offs[-1] + s)
    k = sum(sizes) + kx_extra
    dev = "cuda"
    x = torch.rand(M, k, generator=gen).to(dev)
    w = (torch.randn(len(sizes), k, N, generator=gen) * 0.05).to(dev)
    ints = [torch.tensor(v, dtype=torch.int32, device=dev)
            for v in (offs, offs, sizes)]
    return x, w, ints, offs


def _check_grads(name, fn, fn_ref, x, w, gen):
    xk = x.clone().requires_grad_()
    wk = w.clone().requires_grad_()
    y = fn(xk, wk)
    t = torch.randn(y.shape, generator=gen).to(y.device)
    dx, dw = torch.autograd.grad((y * t).sum(), (xk, wk))
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    y_ref = fn_ref(xr, wr)
    dx_r, dw_r = torch.autograd.grad((y_ref * t).sum(), (xr, wr))
    torch.cuda.synchronize()
    return (assert_close(f"{name} y", y, y_ref),
            assert_close(f"{name} dx", dx, dx_r),
            assert_close(f"{name} dW", dw, dw_r))


def phase_kernel() -> dict:
    """vfl_matmul against its plain version; returns the kernel's
    record for the kernels line (all but ``launches``)."""
    from repro_torch.kernels.vfl_matmul import (
        vfl_matmul, vfl_matmul_clients, vfl_matmul_clients_ref,
        vfl_matmul_ref)
    gen = torch.Generator().manual_seed(0)
    mnist = [168, 168, 168, 140, 140]      # 5 clients, image rows dealt
    cases = [("mnist5 batch", 64, mnist, 10, 0),
             ("mnist5 test set", 14000, mnist, 10, 0),
             ("titanic K tails of 3", 178, [3, 3, 3], 10, 0),
             ("skewed (5,3,1)", 96, [5, 3, 1], 10, 0),
             ("dead clients of size 0", 64, [40, 30, 0, 14, 0], 10, 0),
             ("M and N tails", 1001, [17, 17, 17], 33, 5)]
    y_err, g_err, rows = 0.0, 0.0, []
    for name, M, sizes, N, extra in cases:
        x, w, (xo, wo, sz), offs = _clients_case(M, sizes, N, gen, extra)
        e = _check_grads(
            name,
            lambda a, b: vfl_matmul_clients(a, b, xo, wo, sz),
            lambda a, b: vfl_matmul_clients_ref(a, b, offs, offs, sizes),
            x, w, gen)
        y_err, g_err = max(y_err, e[0]), max(g_err, *e[1:])
        rows.append({"case": name, "M": M, "sizes": sizes, "N": N,
                     "max_abs_err": {"y": e[0], "dx": e[1], "dW": e[2]}})

    # the JAX-signature wrapper: x_off = 0, w_off = offset (unaligned)
    x = torch.randn(5, 7, generator=gen).cuda()
    w = torch.randn(20, 33, generator=gen).cuda()
    e = _check_grads("single client, offset 6",
                     lambda a, b: vfl_matmul(a, b, 6),
                     lambda a, b: vfl_matmul_ref(a, b, 6), x, w, gen)
    y_err, g_err = max(y_err, e[0]), max(g_err, *e[1:])
    rows.append({"case": "single client, offset 6", "M": 5, "sizes": [7],
                 "N": 33, "max_abs_err": {"y": e[0], "dx": e[1], "dW": e[2]}})
    # gate 1 is a bitwise identity, gate 0 zeroes y, dx and dW
    xg = x.clone().requires_grad_()
    wg = w.clone().requires_grad_()
    y1 = vfl_matmul(xg, wg, 6, gate=torch.ones((), device="cuda"))
    check(torch.equal(y1, vfl_matmul(x, w, 6)), "gate 1 changed y")
    y0 = vfl_matmul(xg, wg, 6, gate=torch.zeros((), device="cuda"))
    dx0, dw0 = torch.autograd.grad(y0.sum(), (xg, wg))
    torch.cuda.synchronize()
    check(not y0.any() and not dx0.any() and not dw0.any(),
          "gate 0 left a non-zero in y, dx or dW")
    emit({"phase": "kernel", "kernel": "vfl_matmul", "tol": KERNEL_TOL,
          "cases": rows, "gates": "ok"})

    # times at the training path's shapes: a batch and the test set
    timings = []
    for M, iters in ((64, 500), (14000, 100)):
        x, w, (xo, wo, sz), offs = _clients_case(M, mnist, 10, gen)
        n, kx, N = w.shape
        # the library yardstick: one dense product with each client's W
        # zeroed outside its slice (prepared outside the timing)
        mask = torch.zeros(n, kx, 1, device="cuda")
        for c, (o, s) in enumerate(zip(offs, mnist)):
            mask[c, o:o + s] = 1
        w_masked = w * mask
        with torch.no_grad():
            lib_y = torch.matmul(x, w_masked)
            assert_close(f"library yardstick M={M}", lib_y,
                         vfl_matmul_clients_ref(x, w, offs, offs, mnist))
            fns = {"": lambda: vfl_matmul_clients(x, w, xo, wo, sz),
                   "plain_": lambda: vfl_matmul_clients_ref(x, w, offs, offs,
                                                            mnist),
                   "library_": lambda: torch.matmul(x, w_masked)}
            times = {}
            for key, fn in fns.items():
                times[key + "ms"] = device_ms(fn)
                times[key + "eager_ms"] = eager_ms(fn, iters)
        k_sum = sum(mnist)
        nbytes = 4 * (M * k_sum + k_sum * N + n * M * N) + 3 * 4 * n
        flops = 2 * M * N * k_sum
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        timings.append({"M": M, "sizes": mnist, "N": N, **times,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "bytes": nbytes, "flops": flops})
    emit({"phase": "kernel_times", "kernel": "vfl_matmul",
          "timings": timings})
    batch = timings[0]       # the shape of ~all launches on the path
    return {"name": "vfl_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/vfl_matmul/csrc/vfl_matmul.cu",
            "replaces": "src/repro/kernels/vfl_matmul/vfl_matmul.py:42",
            "max_abs_err": max(y_err, g_err),
            "ms": batch["ms"], "plain_ms": batch["plain_ms"],
            "bound_ms": batch["bound_ms"], "bound_by": batch["bound_by"],
            "library_ms": batch["library_ms"],
            "eager_ms": batch["eager_ms"],
            "at": {"M": batch["M"], "sizes": mnist, "N": batch["N"],
                   "ms": "device time per call, CUDA graph of 100 calls",
                   "eager_ms": "per call issued from Python"},
            "test_set": timings[1]}


# ---------------------------------------------------------------------------
def _round_one(pcfg, lane):
    """Round 1 of ``pcfg``'s training on ``lane`` from the weights and
    batches ``DeVertiFL.train`` draws first."""
    from repro_torch.core.protocol import DeVertiFL, train_generators
    fed = DeVertiFL(pcfg.replace(first_layer=lane), device="cuda")
    init_gen, loop_gen = train_generators(pcfg.seed)
    params = fed.init_params(init_gen)
    _, _, _, losses = fed.run_round(params, fed.opt.init(params), 0,
                                    fed.perms(loop_gen))
    return losses.cpu()


def phase_train(kernel_row, pcfg) -> None:
    from repro_torch.core.protocol import DeVertiFL
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    t0 = time.perf_counter()
    fed = DeVertiFL(pcfg, device="cuda")
    setup_s = time.perf_counter() - t0
    check(fed.first_layer == "kernel",
          f"first_layer='auto' resolved to {fed.first_layer!r} on CUDA")

    vfl_matmul_clients.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fed.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = vfl_matmul_clients.launches

    steps = pcfg.rounds * pcfg.epochs * fed.n_batches
    # one launch per training step, one per evaluation (each round + final)
    expected = steps + pcfg.rounds + 1
    check(launches == expected,
          f"vfl_matmul launched {launches} times, expected {expected}")
    losses = torch.cat([torch.as_tensor(h["round_losses"])
                        for h in out["history"]])
    check(losses.numel() == steps and bool(torch.isfinite(losses).all()),
          "training losses are not all finite")
    final = out["final"]
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0
              for v in (final["f1"], final["acc"])), f"metrics {final}")
    preds = fed.predict(out["params"], fed.xte[:7])
    check(tuple(preds.shape) == (pcfg.n_clients, 7), "predict shape")

    first = torch.as_tensor(out["history"][0]["round_losses"])
    again = _round_one(pcfg, "kernel")
    check(torch.equal(first, again),
          "kernel lane: round 1 rerun is not bitwise equal")
    sliced = _round_one(pcfg, "slice")
    rel = float(((sliced - first).abs() / first.abs()).max())
    check(torch.allclose(sliced, first, rtol=LANE_RTOL, atol=0.0),
          f"kernel vs slice lane round-1 losses: max rel diff {rel} > "
          f"rtol {LANE_RTOL}")
    kernel_row["launches"] = launches
    emit({"phase": "train", "dataset": pcfg.dataset,
          "n_clients": pcfg.n_clients, "n_samples": pcfg.n_samples,
          "n_train": len(fed.xtr), "batch_size": fed.bs,
          "rounds": pcfg.rounds, "steps": steps,
          "first_layer": fed.first_layer, "setup_s": setup_s,
          "train_s": train_s,
          "s_per_round": train_s / pcfg.rounds,
          "steps_per_s": steps / train_s,
          "final_f1": final["f1"], "final_acc": final["acc"],
          "round_f1": [h["f1"] for h in out["history"]],
          "last_loss": out["history"][-1]["loss"],
          "vfl_matmul_launches": launches,
          "kernel_vs_slice_max_rel": rel, "lane_rtol": LANE_RTOL,
          "rerun_bitwise": True})


def phase_profile(pcfg) -> None:
    """Where a training step's time goes: one round of the same
    federation at fewer samples under torch.profiler -- device time by
    kernel, and the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.protocol import DeVertiFL, train_generators
    fed = DeVertiFL(pcfg, device="cuda")
    init_gen, loop_gen = train_generators(pcfg.seed)
    params = fed.init_params(init_gen)
    opt_state = fed.opt.init(params)
    idx = fed.perms(loop_gen)
    fed.run_round(params, opt_state, 0, idx)        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_round(params, opt_state, 0, idx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type.name == "CUDA":
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    steps = pcfg.epochs * fed.n_batches
    emit({"phase": "profile", "n_samples": pcfg.n_samples, "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_ms_per_step": device_ms / steps if rows else None,
          "device_busy_share": device_ms / wall_ms if rows else None,
          "kernels_per_step": sum(r[2] for r in rows) / steps,
          "top_device_kernels": [
              {"kernel": k[:80], "ms_per_step": us / 1e3 / steps,
               "calls_per_step": n / steps} for us, k, n in rows[:10]]})


def main() -> None:
    info = phase_device()
    phase_build()
    kernel_row = phase_kernel()
    from repro_torch.core.protocol import ProtocolConfig
    pcfg = ProtocolConfig(dataset="mnist", n_clients=5, n_samples=70000,
                          rounds=2, epochs=1, batch_size=64)
    phase_train(kernel_row, pcfg)
    phase_profile(pcfg.replace(n_samples=4000))
    emit({"kernels": [kernel_row]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
