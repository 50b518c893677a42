"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   requires CUDA (exits 1 without it), prints nvidia-smi's
              name and power limit, the torch and CUDA versions, and
              the TF32 switches (both off: the reference is float32)
  2. build    builds every kernel from the sources in this checkout
  3. kernel   holds each kernel against its plain PyTorch version at
              the shapes the training path gives it (forward, dx, dW,
              gate 0 and 1), each case also through the other of
              vfl_matmul's two kernels (wave, ring: bitwise equal), and
              times kernel, plain version, bound, one library call and
              an empty kernel (the launch floor) on the same inputs,
              with the launch plan at each timed shape
  4. attn_kernel
              holds flash_attention against its plain version at the
              serving paths' shapes (qwen2-7b prefill at S = 128, 1024,
              1536; decode at B = 8 over 2048 ring slots, partly written
              and wrapped; deepseek-moe-16b prefill at S = 1024 and
              decode, 16 heads of 16, group 1; seamless-m4t-medium's
              encoder at S = 1024, non-causal, its decoder prefill at
              Sq = 16 and cross prefills at Sq = 16 and 100 over 1024
              frames, its cross decode at B = 8 over 1024 frames and
              self decode over 128 ring slots, 16 heads of 64, group 1;
              llava-next-34b prefill at S = 3392 and decode at B = 8
              over 3456 ring slots, group 7; the zoo's at the first zoo
              prompt's length: gemma2-2b's local and global prefills,
              hd 256 with softcap 50 on the CUDA-core route, qwen2-7b-swa
              and mixtral-8x22b windowed prefills, qwen1.5-4b at group
              1, and each decode step over its 4,096-slot ring wrapped or
              gemma2's 8,192 global slots), at the training path's
              (qwen1.5-0.5b's B = 8 at S = 256, 16 heads of 64;
              seamless's encoder at B = 2) and at the Pallas options
              the path does not use (window, softcap, hd 64 and 256,
              float32, tails of rows and keys), element by element
              against the plain float32 result, each case naming the
              route it ran (ops.route: wgmma, split_k_wgmma, split_k,
              cuda_cores); five planted faults (window and causal mask
              off by one, a ring tile dropped, one split's partial left
              out of the combine, a non-causal call's last key tile
              skipped) must fail that check; and times kernel, plain
              version, bound and scaled_dot_product_attention
  5. moe_router
              holds moe_router against its plain version at the MoE
              serving paths' shapes (T = 8 a decode step, 1326 and 1536
              prefills, deepseek's E = 64, k = 6; jamba's E = 16, k = 2
              at T = 8 and 1326; mixtral's E = 8, k = 2 at T = 8 and at
              the first zoo prompt's length), at the training path's
              (deepseek T = 2048, jamba T = 512), at mixtral's T = 384, at the
              limits (E = 256, k = 8; k = E), at T = 1 and tails, on
              exact ties and on rows that underflow; four planted faults
              (first and k-th picks swapped, the Pallas kernel's
              repeated index, the tail tile short a row, one block's
              partial stats dropped from a tile) must fail that check;
              times kernel, plain version, bound, softmax + topk and an
              empty kernel (the launch floor), with each timed case's
              launch plan (ops.plan); and both plans, one block and a
              cluster of 8, at T = 8 to 1536 and a jamba prefill (the
              crossover)
  6. rwkv6_scan
              holds rwkv6_scan against its plain version at the ssm
              serving path's shapes (rwkv6-1.6b prefill B = 1, T = 1326
              and 1536, H = 32, hd = 64, on the chunked route; decode B
              = 8, T = 1 from a random state, on the sequential route)
              and beyond it (hd 128, bf16 inputs, B = 4 at T = 700, the
              training path's B = 8 at T = 256, w
              with exact zeros and 1 - 2^-24, T = 46 and 64 through
              both routes: a chunk short and one whole), each case
              naming its route, element by element against the plain
              float32 result; a run split on the chunk grid (704 of
              1326) is bitwise one run, the old split point (702) within
              the limit; the state written in place at a prefill and at
              decode; five planted faults (the bonus u dropped, the
              state updated before the output is read, the input state
              ignored, each chunk replayed from the previous chunk's
              start state, a suffix product off by one step) must fail
              that check; and times both routes at the prefills (the
              sequential one as the "before"), the two routes at short
              T (where ops.route switches), plain version and bound (no
              single PyTorch call computes the recurrence)
  7. mamba_scan
              the same for mamba_scan at the hybrid serving path's
              shapes (jamba prefill B = 1, T = 1326 and 1536, D = 8192,
              N = 16; decode B = 8, T = 1 from a random h) and beyond
              (N = 8, tails of D, bf16 inputs, a split run); planted
              faults: y read from h_{t-1}, the input h ignored, the
              last channel tile short one channel; then the same for
              mamba_scan_fused, the serving path's route (dt, x, B, C,
              A in, a and bx formed in the kernel), against its plain
              version: jamba's bf16 prefills and decode, a float32
              model, N = 8 with D = 1000, D = 8190, B = 2, the training
              path's B = 2 at T = 256; a split run
              and reruns bitwise, the state in place; four planted
              faults (dt one step late, y read from h_{t-1}, the input
              h ignored, the last channel tile short); times beside the
              "before" (the discretisation + the unfused kernel) on the
              same inputs, and the bound by bytes, float32 operations
              and exponentials
  8. train    trains the paper's MNIST federation (784 -> 3x10 -> 10,
              5 clients, 70,000 samples, 2 rounds) through the kernel
              lane with every launch count set to 0 just before and
              read just after; then reruns round 1 from the same
              weights and batches on the kernel lane (bitwise) and the
              slice lane (allclose)
  9. api      the front door, repro_torch.api, at the train phase's
              config: build(ExperimentSpec(...)).run() records
              first_layer "kernel", launches vfl_matmul once a step and
              once an evaluation (the count set to 0 just before, read
              just after), and is bitwise the train phase's
              DeVertiFL.train(); its RunResult goes through json; then
              the same spec with checkpoints every round: the run and a
              resume() after the last round's file is deleted are
              bitwise the uninterrupted run, a truncated newest file is
              walked back past with a RuntimeWarning, a changed lr and a
              checkpoint beyond the rounds are refused (ms per save);
              and the Table II bank row (benchmarks/table2.py's
              bank_vs_splitnn, 2 of its 20 rounds) in devertifl and
              splitnn mode, each rerun bitwise, with steps/s and
              spec_hash
 10. obs      the obs layer at the api phase's config: a 2-round
              obs="full" Session bitwise its obs="none" run (params,
              metrics, round losses), launching vfl_matmul once a step
              and an evaluation (the count set to 0 just before, read
              just after), its series' shapes and positivity, its
              SpanTracer export parsed as JSON with one round span a
              round; obs="basic" leaves the per-client series at zero;
              under the adversity combination the staleness, bytes and
              quarantine series equal the inner layers' telemetry; an
              obs x seed lane grid (none, basic, full x seeds 0, 1) in
              one round, lanes (none, 0), (basic, 0), (full, 0), (full,
              1) bitwise their standalone runs, series included;
              SpanTracer.profile_to's torch.profiler trace names
              vfl_matmul; steps/s and kernels a step (torch.profiler)
              with the taps beside without; a planted fault (a tap that
              writes into the released stack) must fail the bitwise
              check
 11. serve_fed
              federated serving over the api phase's trained
              federation: the predict path's stages (first layer,
              hidden layers, head, exchange, argmax) on 64-row chunks
              bitwise the whole test set's; 4,096 requests from the
              mnist test rows
              (numpy seed 0), a quarter on 256 hot entities, each
              client's slice offered in shuffled order interleaved with
              step() through Session.server(max_slots=64, cache=512,
              queue_cap=256, overflow="evict_oldest"), vfl_matmul
              launched once a step (the count set to 0 just before,
              read just after); every completed result equal to
              Session.predict on its row, exactly; the same requests at
              8 and 1,024 slots the same; cache hits equal recomputes;
              every pressure entry at the cap; a topk+int8 Session's
              cache holds packed payloads whose hits are bitwise its
              fresh serves; prometheus_text parses (cumulative
              buckets); a planted fault (a cache returning another
              entity's stack) must fail the equality check;
              requests/s, p50/p99 latency, host and device ms a step
              and the busy share (torch.profiler over 50 steps)
 12. sweep    Fig. 3's paper grid (benchmarks/figures.py --paper: mnist,
              clients 2..10 x seeds 0, 1, 2, 70,000 samples, 2 rounds
              of 1 epoch) through repro_torch.api.run_grid: 27 lanes
              padded to 10 slots (a client axis of 270) in one round,
              vfl_matmul launched once a lane-batched step and once an
              evaluation (1,751; the count set to 0 just before, read
              just after); the grid rerun bitwise and round 1 again from
              fresh draws bitwise; lanes (2, 0), (5, 1), (10, 2) within
              LANE_RTOL of their standalone DeVertiFL rounds; their
              slices of one stacked launch each bitwise a launch of the
              lane alone, with a planted fault (x_offsets without the
              lane's l*F) failing; kernels a step at 27 lanes within 5%
              of one lane (torch.profiler, differing kernels named);
              the grid's cell 5 against a multi-seed Session (F1 within
              0.002, final loss within LANE_RTOL); lane-steps/s,
              cells/s, busy share, peak GB, F1 per cell
 13. adversity
              the round engine's schedule, fault and wire layers at the
              train phase's configuration cut to ADVERSITY_SAMPLES
              (mnist, 5 clients, 14,000 of its 70,000 samples, kernel
              lane): one round of each of sync,
              stale_k:0, partial:1.0, stale_k:2, partial:0.5,
              partial:0.5:det, double_buffer, crash:0.2:2,
              straggle:0.3:2, corrupt:0.05 (nan and scale), topk:1.0,
              topk:0.5, int8, dp:0.1 and the combination stale_k:2 +
              crash:0.2+corrupt:0.05 + topk:0.5+int8+dp:0.1 through
              DeVertiFL.train(), each rerun bitwise and launching
              vfl_matmul once a step and once an evaluation (877, the
              count set to 0 just before, read just after: 177 at
              14,000 samples); stale_k:0,
              partial:1.0 and topk:1.0 bitwise sync; under corruption
              every loss finite and every corrupted client-round
              quarantined, which a planted leaky screen (a NaN slice let
              through) must fail; wire bytes against wire_bytes for the
              round's live senders; the combination's busy share and
              kernels a step (torch.profiler), and two rounds of it
              through build(ExperimentSpec(...)).run(); a Session round
              poisoned on its first attempt (a registered test_poison
              plan): one watchdog trip, one reseeded retry, finite,
              rerun bitwise; a schedule grid (sync, stale_k:1,
              stale_k:2, partial:0.5 x seeds 0, 1, 2: 12 lanes, one
              launch a lane-batched step, lanes (sync, 0), (stale_k:2,
              1), (partial:0.5, 2) bitwise their standalone runs) and a
              fault x transform grid the same way; steps/s of each
              variant beside sync's, lane-steps/s
 14. profile  where a training step's time goes (torch.profiler)
 15. audit    the static auditor (repro_torch.analysis) on the card: the
              default audit grid on the kernel lane (mnist, 3 clients:
              every federated mode x the shipped schedules, the composite
              fault plan and the hot wire transforms), each combo traced
              once (make_fx, then functionalized) with vfl_matmul_clients
              one node (its custom-op route) and proved clean by the
              taint, deadness and retrace passes (audit_combos), with
              seconds a combo, channels and static_round_traces; the
              sweep's lane check on the kernel lane; a traced round
              bitwise an untraced one from the same state, both the
              traced run and the audited graph run anew (kernel and
              slice lanes); five planted faults each flagged with its
              code (a leaky first layer: cross-client-flow with a chain
              naming this file; the
              custom-op route off: opaque-write; a FedAvg term without
              its mask on 2 of 3 slots: unproven-dead-slot; a carried
              leaf cast to float64: carry-aval-drift; a lane first layer
              branching on its lane's client count:
              lane-retrace-divergence); vfl_matmul launched in the audit
              (the count set to 0 just before, read just after) as many
              times as the grid implies (AUDIT_LAUNCHES_A_TRACE), kept
              apart from the main path's count; then the profile
              phase's round again just before and just after the audit,
              outside it: the same kernels, by name and count, and
              vfl_matmul launches; and a 14,000-sample round through the
              raw launch against the custom op, alternating: steps/s of
              each, losses bitwise
 16. serve    serves qwen2-7b at full width and depth (28 layers,
              random bf16 weights drawn on the card) through
              ServingEngine: 12 greedy requests of 128-1536 prompt
              tokens and 32 new tokens on 8 slots, with the
              flash_attention count set to 0 just before and read just
              after; a rerun gives bitwise equal tokens, and the first
              prompt's logits agree with the plain attention's (a
              model built with ``attend=flash_attention_ref``) while a
              planted fault's do not; then one decode step and one
              prefill under torch.profiler
 17. serve_moe
              after qwen2-7b's memory is released, serves
              deepseek-moe-16b at full width and depth (28 layers, 64
              routed experts top-6 + 2 shared, random bf16 weights drawn
              on the card) with the same 12 requests' lengths, every
              count set to 0 just before and read just after:
              moe_router 27 and flash_attention 28 launches per prefill
              and decode step; a rerun gives bitwise equal tokens; on
              the first prompt's prefill every layer's routes through
              the kernel are held against the plain router on the same
              logits, and two planted faults (the first and k-th picks
              swapped, the k-th pick in place of the first) must fail
              that check; the logits against a prefill routed by the
              plain version; then one decode step and one prefill
              under torch.profiler
 18. serve_rwkv
              after deepseek-moe-16b's memory is released, serves
              rwkv6-1.6b at full width and depth (24 layers, random bf16
              weights drawn on the card) with the same 12 requests'
              lengths: rwkv6_scan 24 launches per prefill and decode
              step and no other kernel; a rerun gives bitwise equal
              tokens; on the first prompt's prefill every layer's scan
              through the kernel is held against the plain version on
              the same inputs (a planted fault, the bonus dropped, must
              fail), and the logits against a prefill through the plain
              scan (the same fault must exceed that limit); the state
              carry: prefill(prompt[:n]) then one decode step against
              prefill(prompt[:n + 1]), on the logits and every layer's
              state, which a decode from a zeroed state must fail; then
              one decode step and one prefill under torch.profiler
 19. serve_hybrid
              after rwkv6-1.6b's memory is released, serves
              jamba-v0.1-52b at full width and cut depth (16 of its 32
              layers: 103.15 GB of bf16 weights do not fit the card's
              80 GB; 14 Mamba, 2 attention, 8 MoE layers) the same way:
              mamba_scan_fused 14 (unfused mamba_scan 0),
              flash_attention 2 and moe_router 8 launches per prefill
              and decode step; rerun bitwise; every MoE layer's routes
              on the first prompt's prefill held to the plain router, as
              in serve_moe; every Mamba layer's fused
              scan held against its plain version on the first prompt's
              prefill (planted faults: y read from h_{t-1}, dt one step
              late, the last channel tile short one channel); logits
              against the plain scan; the state carry; profiles
 20. serve_audio
              after jamba's memory is released, serves
              seamless-m4t-medium at full size (12 encoder and 12
              decoder layers, d_model 1024, 16 heads of 64, bf16) on 8
              slots of 128: 12 greedy requests of 2-16 tokens (a
              target-language tag, then text; numpy seed 0), each over
              the engine's 1,024 zero frames, 64 new tokens;
              flash_attention 36 launches a prefill (12 encoder, 12
              self, 12 cross) and 24 a decode step, no other kernel;
              rerun bitwise; on the first prompt over random frames
              (numpy seed 1) every attention call of the prefill held to
              the plain version element by element, which a planted
              fault (every cross attention reading one frame fewer) must
              fail, and the logits against the plain attention's, which
              the cross attention skipped must fail; then one decode
              step and one prefill under torch.profiler
 21. serve_vlm
              serves llava-next-34b at full width and depth (60 layers,
              d_model 7168, 56/8 heads of 128, bf16) on 8 slots of
              3,456: 12 greedy requests of 32-512 tokens after the
              engine's 2,880 zero image rows, 32 new tokens;
              flash_attention 60 launches a prefill and a decode step,
              no other kernel; rerun bitwise; on the first prompt after
              random image rows (numpy seed 1) every attention call held
              to the plain version (a 32-key tile cut from every layer's
              last row must fail), the logits against the plain
              attention's (that cut and the first image row changed
              must fail); profiles
 22. serve_zoo
              the zoo's configurations never served before, at full
              width, bf16, random weights drawn on the card, each through
              ServingEngine with every count set to 0 just before and
              read just after and a rerun bitwise: gemma2-2b (26 layers,
              hd 256: the CUDA-core route, local/global layers, softcaps)
              on 8 slots of 8,192, 12 requests of 4,200-6,000 tokens
              (numpy seed 0), 32 new; qwen1.5-4b (40 layers, MHA, QKV
              bias) on the text traffic of serve; qwen1.5-4b-swa on the
              same tree and qwen2-7b-swa on the 8,192-slot traffic;
              mixtral-8x22b at MIXTRAL_LAYERS of 56 (its full depth does
              not fit 80 GB) the same.  Every windowed ring wraps in the
              prefill's fill and again in decode.  Checks: the parameter
              count; the first prompt's logits against the plain
              attention's (one 32-key tile cut must fail on a
              full-attention model; read on the windowed ones); for a
              windowed one every attention call of that prefill held to
              the plain version within a limit with the call's float32
              floor (the window 1 and 32 keys short must fail) and decode
              against forward for that request (stale rings must fail;
              mixtral at a capacity factor that drops no route);
              mixtral's routes against the plain router (two planted
              faults); gemma2's final softcap on lifted logits (the cap
              off must pass 30); launch.serve's main (--arch gemma2-2b)
              once; tokens/s, TTFT, step ms, peak, profiles.  Between
              the configurations, on their trees, the input shapes
              long_500k (qwen1.5-4b-swa: 524,288 tokens at B = 1, the
              key loop stopping at the window, the rings' positions, 32
              decode steps), prefill_32k (qwen2-7b, S = 32,768 into a
              cache of 32,800) and decode_32k (that cache spliced into 8
              slots, 32 steps): every layer's attention held to the
              plain version on its first and last 256 query rows (the
              one-tile cut must fail), the split-K step over the 32,768
              slots (a dropped tile must fail), decode against a
              32,769-row prefill (a cache not spliced must fail)
 23. shapes   long_500k on rwkv6-1.6b (524,288 tokens at B = 1 on the
              chunked route, 32 decode steps; layer 0's scan against the
              sequential kernel, output and state, and its last 4,096
              steps against the plain version from the chunked route's
              state at that chunk boundary, where a dropped state must
              fail; both routes timed); train_4k on qwen1.5-0.5b at S =
              4,096, the largest batch of 1, 2, 4, 8 whose peak the dry
              run's resident bytes and a measured B = 1 step predict
              under 72 GB, 3 steps rerun bitwise, the first loss against
              the plain attention's
 24. train_lm
              LM training, qwen1.5-0.5b at full width and depth (24
              layers, d_model 1024, 16 heads of 64, vocab 151,936, bf16,
              remat): one forward and backward of Model.loss at the
              reference CLI's batch 8 x 256 through flash_attention (its
              autograd Function: the kernel forward, a PyTorch backward)
              held leaf by leaf to the same through the plain attention
              (relative L2), where the kernel's output detached and a
              backward recomputed with the causal mask flipped must
              fail; flash_attention launched 48 times in it (24, and 24
              in the remat recompute); 2 steps rerun bitwise; 10 timed
              steps (steps/s, tokens/s, peak GB) and one under
              torch.profiler; make_federated_train_step over 2 pods with
              FedAvg every 2 steps, 4 steps: the replicas bitwise equal
              after each FedAvg, pod 0's first step bitwise
              make_train_step on its slice; then the main path, python
              -m repro_torch.launch.train's main with --vocab 512 at its
              defaults (50 steps, lr 3e-4, 10 warmup), every count set to
              0 just before and read just after (flash_attention 2,400,
              no other kernel), the last loss at least 0.5 below the
              first; then one forward and backward of deepseek-moe-16b (2
              layers: moe_router), rwkv6-1.6b (2 layers: rwkv6_scan),
              jamba-v0.1-52b (2 Mamba layers, one MoE: mamba_scan_fused
              and moe_router) and seamless-m4t-medium (full size over
              random frames: non-causal flash_attention), each at full
              width, through the kernels against the plain version of
              the family's kernel, with its output detached as the
              planted fault, and each kernel's launches; then
              rwkv6-1.6b and seamless-m4t-medium again at the same
              layers and batch in a float32 model, where rounding sets
              a small floor: the detached output must exceed the limit
              of rwkv6's bonus leaf and of the cross attention's q, k,
              v projections on their own (their readings recorded)
 25. exchange the De-VertiFL input block's exchange: qwen1.5-0.5b at
              full size with its embedding's d_model split among 16
              emulated clients (64 columns each), under zeropad_psum and
              allgather: at train_lm's batch the loss, the logits and
              every gradient leaf bitwise one client's, flash_attention
              launched 48 times in a forward and backward and no other
              kernel, 2 steps rerun bitwise and bitwise one client's,
              10 timed steps a mode beside one client's (steps/s, the
              bytes each mode sends) and one under torch.profiler
              (device ms, kernels a step); 6 greedy requests through
              ServingEngine, tokens equal one client's; llava-next-34b
              at full width and 4 layers (448 columns a client), a
              prefill after 2,880 random image rows, logits and caches
              bitwise one client's; three planted faults (a slice
              padded at the next client's offset, the gather in
              reversed client order, the image prefix not sliced) must
              fail those checks
 26. dryrun   the one-card dry run: python -m repro_torch.launch.dryrun
              over every ARCHS x SHAPES pair at 16 clients under
              zeropad_psum, in a process of its own (the meta device:
              no card, no memory), one line a record, every record ok
              or skipped with the reference's reason; qwen1.5-0.5b
              counted at train_lm's 8 x 256 (one client, and 16 in
              each mode): the counted bound at or under the step's
              device ms measured in train_lm and exchange, and the
              achieved TFLOP/s and the bound over the host step time
              beside it (not gated); then
              dryrun_federated.run("qwen1.5-0.5b")
 27. examples the seven twins of examples/ (src/repro_torch/examples)
              at their smoke sizes, each main with every count set to 0
              just before and read just after, held to the launches its
              rounds, evaluations, serving steps and decode steps imply
 28. datasets the synthetic draws the phases made and reused: every
              registered dataset's make goes through a cache keyed by
              its arguments (the phases build their federations from
              the same draws; each caller gets its own copy)

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
...}`` line.  Any failed check raises, so the script exits non-zero
and prints no result.  It imports nothing of JAX.  The peaks and each
kernel's operations and bytes behind every bound it prints come from
``repro_torch.roofline`` (``analysis``, ``work``), as the dry run's do.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the published H100 SXM peaks (HBM3 bandwidth, float32 outside the
# tensor cores, dense bf16 in them) and each kernel's operations and
# bytes, from the port's roofline package (fails outside a checkout)
from repro_torch.roofline import work as W  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    BF16_FLOP_PER_S, FP32_FLOP_PER_S, HBM_BYTES_PER_S)
# exponentials (MUFU.EX2, one an expf) a clock on each SM: the CUDA C++
# Programming Guide's throughput of base-2 exponentials at compute
# capability 9.0; the rate is this times the SMs times the SM clock read
# from the card in phase_device
SFU_EXP_PER_SM_CLOCK = 16
SFU_EXP_PER_S = None

# kernel vs plain version: float32 with a different summation order,
# the tolerance tests/test_kernels.py uses for float32
KERNEL_TOL = 2e-5
# kernel lane vs slice lane, per-step losses over one 875-step round:
# float32 in another summation order in layer 0 only (9.1e-7 measured
# on an NVIDIA H100 80GB HBM3, power limit 700 W)
LANE_RTOL = 1e-4
# flash_attention vs its plain version, element by element against the
# plain version's float32 result on the same inputs (bf16 inputs upcast
# exactly): |kernel - plain| <= ATTN_ATOL + ATTN_RTOL * |plain|.  The
# kernel sums in float32 in another order (at most 7.2e-7 on outputs up
# to 3, measured on an NVIDIA H100 80GB HBM3, power limit 700 W): 1e-5
# absolute and relative.  A bfloat16 output is its float32 result
# rounded once, by at most half an ulp: 2^-8 of |plain| more.
ATTN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5 + 2.0 ** -8}
ATTN_ATOL = 1e-5
# ATTN_ATOL is float32's error over a few thousand keys.  Over longer
# reductions float32 itself drifts further: on qwen2-7b's 32,768-row
# prefill the plain version in float32 reads up to 3.37e-5 from float64
# on the last rows, and the kernel about as much (measured on an NVIDIA
# H100 80GB HBM3, power limit 700 W).  The checks of the zoo's and the
# input shapes' calls measure that floor in the same run (the plain
# version in float32 against float64 on the call's longest rows,
# ``_plain_floor``) and add this many times it to the limit, as the
# gradient checks hold a leaf to GRAD_FLOOR_FACTOR times its floor
ATTN_FLOOR_FACTOR = 3
# SDPA, the timed yardstick, computes the same function to bf16's
# precision (it rounds the probabilities to bf16): tests/test_kernels.py's
# bf16 rule, 2e-2 * max(1, |plain|max)
LIBRARY_TOL = 2e-2
# moe_router vs its plain version, on the same logits.  Indices are
# equal, except where the plain probabilities at the first pick that
# differs sit within ROUTE_MARGIN of the next (the kernel's softmax
# rounds differently from torch.softmax by a few ulps: a flip there is
# float drift, not a fault).  Weights of agreeing rows within
# ROUTER_W_ATOL (weights <= 1, a few ulps apart).  Stats, sums of up to
# 128 positive terms in another order: (n - 1) * 2^-24 * |sum| at most,
# 7.6e-6 relative, plus a few ulps of each probability: within
# ROUTER_STATS_ATOL + ROUTER_STATS_RTOL * |plain|.
ROUTE_MARGIN = 1e-6
ROUTER_W_ATOL = 1e-6
ROUTER_STATS_ATOL = 1e-6
ROUTER_STATS_RTOL = 2e-5
# rwkv6_scan and mamba_scan vs their plain versions, element by element
# against the plain version's float32 result on the same (upcast)
# inputs: |kernel - plain| <= SCAN_ATOL * max(1, |plain|max) +
# SCAN_RTOL * |plain|.  Each output is a float32 sum taken in another
# order (rwkv: hd terms r_i (S_ij + u_i k_i v_j), each as large as the
# output; mamba: N terms after a fused multiply-add) and carried through
# the state, so the error scales with the output's size, not each
# element's: float32 cases read at most 0.12 of this limit (rwkv's
# prefill, outputs up to 237) and 0.056 (mamba's), measured on an NVIDIA
# H100 80GB HBM3, power limit 700 W.  A bf16 output is its float32
# result rounded once: 2^-8 of |plain| more (bf16 cases read 0.991 and
# 0.992 of the limit, the rounding's own bound).
SCAN_ATOL = 2e-6
SCAN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5 + 2.0 ** -8}
# qwen2-7b prefill logits through the kernel vs through the plain
# attention, |diff| over |plain| (L2 over the vocabulary): both round
# every layer's activations to bfloat16, so a float32 sum taken in
# another order flips some roundings by one bf16 ulp, and the flips
# compound through 28 residual layers: 0.0167 for the 1,326-token first
# prompt.  A planted fault, the last row missing its first 32-key tile
# in every layer, reads 0.203; missing its first key, 0.0290 (the
# attention check catches that one).  Both measured on an NVIDIA H100
# 80GB HBM3, power limit 700 W; the limit sits 3x above the first and
# 4x under the planted tile.  The vlm and audio families read against the
# same limit: llava-next-34b (60 layers, 2,880 image rows and 441 text
# tokens) 0.0323, its one-tile cut 0.345 and its first image row changed
# 0.945; seamless-m4t-medium (12 + 12 layers over 1,024 frames) 0.0094,
# its cross attention skipped 1.016, one frame fewer in every cross
# attention 0.0098 (one key of 1,024 moves the logits less than the
# roundings: the per-call attention check sees that one).  Measured on
# an NVIDIA H100 80GB HBM3, power limit 700 W.
SERVE_LOGIT_RTOL = 5e-2
# rwkv6-1.6b and jamba prefill logits through the scan kernel vs through
# its plain version, |diff| over |plain| (L2 over the vocabulary), as
# SERVE_LOGIT_RTOL: every layer's scan agrees with the plain version to
# float32 (checked element by element on the same prompt), but the bf16
# activations round differently where the float32 scans differ in the
# last bits, and the flips compound through the layers: 0.0567 (rwkv, 24
# layers) and 0.0165 (jamba, 16); the planted faults read 0.665 (rwkv,
# the bonus dropped) and 0.390 (jamba, y read from h_{t-1}).  Measured
# on an NVIDIA H100 80GB HBM3, power limit 700 W; the limit sits 2.6x
# above the larger honest reading and 2.6x under the smaller fault.
SSM_LOGIT_RTOL = 0.15
# the state carry, prefill(prompt[:n]) + one decode step against
# prefill(prompt[:n + 1]), |diff| over |plain| (L2): the last logits,
# and every recurrent layer's state (the largest).  The two paths
# compute bf16 activations with other GEMM shapes (one row against
# n + 1), and jamba's conv is a sum of bf16 products in prefill and an
# einsum in decode, as in the reference: logits 0.0157 (rwkv) and
# 0.0393 (jamba), states 0.0012 and 0.0268.  A decode from a zeroed
# state reads 1.10 and 0.99 (rwkv logits, state) and 0.0402 and 0.247
# (jamba): with random weights jamba's Mamba output is dominated by its
# D x skip term, so only the state reading sees the fault there.
# Measured on an NVIDIA H100 80GB HBM3, power limit 700 W; each limit
# sits 3x above the larger honest reading, the state limit 3.1x under
# jamba's zeroed state.
CARRY_LOGIT_RTOL = 0.12
CARRY_STATE_RTOL = 0.08


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# the synthetic draws made (and the host seconds they took) and reused
_DRAWS = {"drawn": 0, "draw_s": 0.0, "reused": 0}


def _cached_make(make):
    """``make`` (a DatasetEntry's) with each (n, seed, test_frac) drawn
    once; every call gets its own copy of the arrays."""
    memo = {}

    def cached(n=None, seed=None, test_frac=0.2):
        key = (n, seed, test_frac)
        if key in memo:
            _DRAWS["reused"] += 1
        else:
            t0 = time.perf_counter()
            memo[key] = make(n, seed=seed, test_frac=test_frac)
            _DRAWS["drawn"] += 1
            _DRAWS["draw_s"] += time.perf_counter() - t0
        return tuple(a.copy() for a in memo[key])
    return cached


def reuse_dataset_draws() -> None:
    """Route every registered dataset's ``make`` through a cache (module
    doc, phase 25): the phases build their federations from the same
    draws, and the mnist stand-in at 70,000 samples is seconds of host
    numpy a draw.  A cached draw is the same bits as a fresh one."""
    from repro_torch.data import registry as DR
    for name in DR.dataset_names():
        entry = DR.get_dataset(name)
        DR.DATASETS.register(name, dataclasses.replace(
            entry, make=_cached_make(entry.make)), overwrite=True)


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sm_mhz = float(clock.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    global SFU_EXP_PER_S
    SFU_EXP_PER_S = SFU_EXP_PER_SM_CLOCK * sms * sm_mhz * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "nvidia_smi": card,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": sms, "max_sm_clock_mhz": sm_mhz,
            "sfu_exp_per_s": SFU_EXP_PER_S,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32}
    emit(info)
    return info


def _ptxas_lines(log) -> list:
    """``-Xptxas -v``'s registers and spills, each line after the name
    of the kernel it is about (the anonymous namespace cut off)."""
    out = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            out.append(name.split("_cu_", 1)[-1].lstrip("0123456789abcdef"))
        elif "registers" in ln or "spill" in ln:
            out.append(ln.strip())
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": r["seconds"],
                             "cached": r["seconds"] == 0.0,
                             "ptxas": _ptxas_lines(r["log"])}
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


# rows at which both vfl_matmul kernels are timed (ops.WAVE_MAX_M)
VFL_CROSSOVER_M = (64, 256, 1024, 2048, 4096)


def phase_kernel() -> dict:
    """vfl_matmul against its plain version; returns the kernel's
    record for the kernels line (all but ``launches``)."""
    from repro_torch.kernels.vfl_matmul import (
        ops, vfl_matmul, vfl_matmul_clients, vfl_matmul_clients_ref,
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
        # the kernel ops.plan picks, and the other one on the same inputs:
        # one summation order, so the same bits
        n, kw = w.shape[:2]
        picked = ops.plan(M, x.shape[1], kw, N, n)
        other = ops.plan(ops.WAVE_MAX_M + 1 if picked.kernel == "wave"
                         else min(M, ops.WAVE_MAX_M), x.shape[1], kw, N, n)
        with torch.no_grad():
            ys = [ops._launch(x, w, xo, wo, sz, launch=p)
                  for p in (picked, other)]
        check(other.kernel != picked.kernel and torch.equal(*ys),
              f"vfl_matmul {name}: the {picked.kernel} and {other.kernel} "
              f"kernels differ")
        rows.append({"case": name, "M": M, "sizes": sizes, "N": N,
                     "kernel": picked.kernel,
                     "other_kernel_bitwise": True,
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

    # times at the training path's shapes: a batch and the test set; the
    # launch floor: an empty kernel in the same CUDA-graph harness
    floor_ms = device_ms(lambda: ops.empty_launch())
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
        nbytes, flops = W.vfl_matmul_work(M, sum(mnist), N, n)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        p = ops.plan(M, kx, kx, N, n)
        timings.append({"M": M, "sizes": mnist, "N": N, **times,
                        "launch_floor_ms": floor_ms,
                        "plan": {"kernel": p.kernel, "blocks":
                                 p.grid[0] * p.grid[1] * p.grid[2],
                                 "threads": p.threads,
                                 "smem_bytes": p.smem},
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "bytes": nbytes, "flops": flops})
    # where ops.plan switches kernels: both timed at mnist's layout
    crossover = {}
    for M in VFL_CROSSOVER_M:
        x, w, (xo, wo, sz), _ = _clients_case(M, mnist, 10, gen)
        picked = ops.plan(M, x.shape[1], x.shape[1], 10, len(mnist))
        plans = {"wave": ops.plan(min(M, ops.WAVE_MAX_M), x.shape[1],
                                  x.shape[1], 10, len(mnist)),
                 "ring": ops.plan(max(M, ops.WAVE_MAX_M + 1), x.shape[1],
                                  x.shape[1], 10, len(mnist))}
        with torch.no_grad():
            crossover[M] = {"picked": picked.kernel, **{
                name: device_ms(lambda p=p: ops._launch(x, w, xo, wo, sz,
                                                        launch=p))
                for name, p in plans.items()}}
    emit({"phase": "kernel_times", "kernel": "vfl_matmul",
          "timings": timings, "crossover": crossover,
          "wave_max_m": ops.WAVE_MAX_M})
    batch = timings[0]       # the shape of ~all launches on the path
    return {"name": "vfl_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/vfl_matmul/csrc/vfl_matmul.cu",
            "replaces": "src/repro/kernels/vfl_matmul/vfl_matmul.py:42",
            "max_abs_err": max(y_err, g_err),
            "ms": batch["ms"], "plain_ms": batch["plain_ms"],
            "bound_ms": batch["bound_ms"], "bound_by": batch["bound_by"],
            "library_ms": batch["library_ms"],
            "eager_ms": batch["eager_ms"],
            "launch_floor_ms": floor_ms, "plan": batch["plan"],
            "at": {"M": batch["M"], "sizes": mnist, "N": batch["N"],
                   "ms": "device time per call, CUDA graph of 100 calls",
                   "eager_ms": "per call issued from Python"},
            "test_set": timings[1]}


# ---------------------------------------------------------------------------
def _ring_positions(B, size, last):
    """Ring-buffer key positions after decoding up to ``last[b]``
    (inclusive), as the serving cache holds them: slot s keeps the
    newest position p <= last[b] with p % size == s, -1 if none."""
    kpos = torch.full((B, size), -1, dtype=torch.int32)
    for b, n in enumerate(last.tolist()):
        p = torch.arange(max(0, n + 1 - size), n + 1, dtype=torch.int32)
        kpos[b, (p % size).long()] = p
    return kpos.cuda()


def _attn_case(gen, B, H, KV, Sq, Skv, hd, dtype, cache_layout=False):
    """q, k, v on the card; ``cache_layout`` gives k, v as the serving
    cache holds them ([B, Skv, KV, hd], read as transposed views)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)
    if cache_layout:
        return (rand(B, Sq, H, hd).transpose(1, 2),
                rand(B, Skv, KV, hd).transpose(1, 2),
                rand(B, Skv, KV, hd).transpose(1, 2))
    return rand(B, H, Sq, hd), rand(B, KV, Skv, hd), rand(B, KV, Skv, hd)


def attn_excess(out, ref, floor=0.0) -> float:
    """The largest |out - ref| over its limit, ATTN_ATOL + ATTN_RTOL *
    |ref| with ref the plain float32 result (and ATTN_FLOOR_FACTOR x
    ``floor``, the float32 rounding floor of a long call measured by
    ``_plain_floor``, where given): 1 or less passes."""
    limit = ATTN_ATOL + ATTN_RTOL[out.dtype] * ref.abs() + \
        ATTN_FLOOR_FACTOR * floor
    return float(((out.float() - ref).abs() / limit).max())


def _planted_faults(kept) -> dict:
    """The check must reject the kernel run with its mask off by one or
    a tile short: each planted fault is the kernel on a case's inputs
    with one option changed, held to the case's plain result."""
    from repro_torch.kernels.flash_attention import flash_attention, ops
    q, k, v, opts, _ = kept["prefill S=1024"]
    ahead = torch.arange(1, q.shape[2] + 1, dtype=torch.int32,
                         device=q.device)
    ring = kept["decode B=8 over 2048 ring slots"][3]["k_pos"].clone()
    ring[:, 32:64] = -1                 # live in every row (positions >= 128)
    # a non-causal call with its last 64-key tile skipped: the frames
    # given positions, the last tile's -1 (unwritten), so the kernel
    # leaves them out; every row sees them in the true mask
    cross = "seamless cross prefill Sq=100 over 1024 frames"
    frames = kept[cross][1].shape[2]
    last_tile = torch.arange(frames, dtype=torch.int32, device=q.device)
    last_tile[-64:] = -1
    faults = {"window 257 for 256": ("window 256", {"window": 257}),
              "causal: each row sees the next key":
                  ("prefill S=1024", {"q_pos": ahead}),
              "decode: one 32-key tile of the ring dropped":
                  ("decode B=8 over 2048 ring slots", {"k_pos": ring}),
              "non-causal: the last key tile skipped":
                  (cross, {"k_pos": last_tile})}
    readings = {}
    for fault, (case, change) in faults.items():
        q, k, v, opts, ref = kept[case]
        with torch.no_grad():
            out = flash_attention(q, k, v, **{**opts, **change})
        readings[fault] = attn_excess(out, ref)
    # the split-K kernels with split 1 (slots 256-511, live in every row
    # whose position is past 255) left out of the combine: its l set to 0
    # between the two kernels, as if the split had seen no key
    q, k, v, opts, ref = kept["decode B=8 over 2048 ring slots"]

    def drop_split(ws_o, ws_ml):
        ws_ml[:, :, :, 1, 1] = 0.0
    with torch.no_grad():
        out = ops._split_k(q, k, v, True, None, 0.0, q.shape[-1] ** -0.5,
                           opts["q_pos"], opts["k_pos"], edit=drop_split)
    readings["decode: one split's partial left out of the combine"] = \
        attn_excess(out, ref)
    for fault, reading in readings.items():
        check(reading > 1.0, f"planted fault '{fault}' passed the "
              f"flash_attention check ({reading} x its limit)")
    return readings


def _sdpa(q, k, v, opts):
    """PyTorch's fused attention on the call's inputs and mask (the
    library yardstick): a boolean mask where the call has positions or
    a window, else its causal flag.  It has no softcap: a softcapped
    call's yardstick is the same attention without the cap.  None where
    the mask would not fit the card."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import attention_mask
    causal = opts.get("causal", True)
    if "k_pos" in opts or opts.get("window"):
        if q.shape[0] * q.shape[2] * k.shape[2] > 1 << 31:
            return None                 # the mask alone would be > 2 GB
        mask = attention_mask(q.shape[2], k.shape[2], opts.get("q_pos"),
                              opts.get("k_pos"), causal, opts.get("window"),
                              q.device)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def _attn_times(q, k, v, opts, ref, calls, replays=3, eager=True) -> dict:
    """flash_attention's device ms on the call (a CUDA graph of
    ``calls`` calls), eager ms, the plain version's (where ``ref``, its
    float32 result, is given: a call whose plain version does not fit
    the card passes None) and SDPA's, held to ``ref`` within
    LIBRARY_TOL; and the bound, from the call's visible pairs (counted
    on the meta device where the mask would not fit)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref)
    lib = _sdpa(q, k, v, opts)
    fns = {"": lambda: flash_attention(q, k, v, **opts)}
    times = {"plain_ms": None, "plain_eager_ms": None, "library_ms": None,
             "library_eager_ms": None}
    if lib is not None:
        fns["library_"] = lib
    with torch.no_grad():
        if ref is not None and lib is not None:
            if not opts.get("softcap"):
                lib_err = max_err(lib().float(), ref)
                lib_tol = LIBRARY_TOL * max(1.0, float(ref.abs().max()))
                check(lib_err <= lib_tol, f"SDPA yardstick: max |SDPA - "
                      f"plain| = {lib_err} > {lib_tol}")
        if ref is not None:
            fns["plain_"] = lambda: flash_attention_ref(q, k, v, **opts)
        for key, fn in fns.items():
            times[key + "ms"] = device_ms(fn, calls=calls, replays=replays)
            if eager:
                times[key + "eager_ms"] = eager_ms(fn, calls)
    causal, window = opts.get("causal", True), opts.get("window")
    if q.shape[2] * k.shape[2] > 1 << 28:     # a mask of the pairs > 256 MB
        q, k = (torch.empty(t.shape, dtype=t.dtype, device="meta")
                for t in (q, k))
    flops, nbytes = W.attention_work(q, k, causal, window, opts.get("q_pos"),
                                     opts.get("k_pos"))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {**times, "library_without_softcap": bool(opts.get("softcap")),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes,
            "tflops_per_s": flops / times["ms"] / 1e9,
            "gb_per_s": nbytes / times["ms"] / 1e6}


def phase_attn_kernel() -> dict:
    """flash_attention against its plain version; returns the kernel's
    record for the kernels line (all but ``launches``)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref, ops)
    gen = torch.Generator().manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    B_dec, slots = 8, 2048
    last = torch.randint(128, 1600, (B_dec,), generator=gen)
    ring = _ring_positions(B_dec, slots, last)
    qpos_dec = last.to(torch.int32)[:, None].cuda()
    # a ring that has wrapped: positions past its 2048 slots (every slot
    # written, the oldest overwritten)
    last_wrap = torch.randint(2100, 4000, (B_dec,), generator=gen)
    ring_wrap = _ring_positions(B_dec, slots, last_wrap)
    qpos_wrap = last_wrap.to(torch.int32)[:, None].cuda()
    # seamless-m4t-medium's decoder ring (phase serve_audio: 128 slots,
    # prompts of up to 16 tokens and 64 new) and llava-next-34b's
    # (serve_vlm: 3,456 slots, 2,880 image rows, prompts of 32-512
    # tokens and 32 new), each partly written
    last_s = torch.randint(2, 80, (B_dec,), generator=gen)
    ring_s = _ring_positions(B_dec, AUDIO.cache_len, last_s)
    qpos_s = last_s.to(torch.int32)[:, None].cuda()
    last_l = torch.randint(2912, 3424, (B_dec,), generator=gen)
    ring_l = _ring_positions(B_dec, VLM.cache_len, last_l)
    qpos_l = last_l.to(torch.int32)[:, None].cuda()
    frames = 1024                       # seamless's encoder frames
    # name, (B, H, KV, Sq, Skv, hd, dtype, cache layout), options,
    # on the serving path
    cases = [
        ("prefill S=128", (1, 28, 4, 128, 128, 128, bf16, True), {}, True),
        ("prefill S=1024", (1, 28, 4, 1024, 1024, 128, bf16, True), {},
         True),
        ("prefill S=1536", (1, 28, 4, 1536, 1536, 128, bf16, True), {},
         True),
        ("decode B=8 over 2048 ring slots",
         (B_dec, 28, 4, 1, slots, 128, bf16, True),
         {"q_pos": qpos_dec, "k_pos": ring}, True),
        # deepseek-moe-16b: MHA, 16 heads of 16, group 1
        ("deepseek prefill S=1024", (1, 16, 16, 1024, 1024, 128, bf16, True),
         {}, True),
        ("deepseek decode B=8 over 2048 ring slots",
         (B_dec, 16, 16, 1, slots, 128, bf16, True),
         {"q_pos": qpos_dec, "k_pos": ring}, True),
        # seamless-m4t-medium: MHA, 16 heads of 64; the encoder and the
        # cross attention non-causal over 1,024 frames, no positions
        ("seamless encoder S=1024",
         (1, 16, 16, frames, frames, 64, bf16, True), {"causal": False},
         True),
        ("seamless decoder prefill Sq=16",
         (1, 16, 16, 16, 16, 64, bf16, True), {}, True),
        ("seamless cross prefill Sq=16 over 1024 frames",
         (1, 16, 16, 16, frames, 64, bf16, True), {"causal": False}, True),
        ("seamless cross prefill Sq=100 over 1024 frames",
         (1, 16, 16, 100, frames, 64, bf16, True), {"causal": False},
         True),
        ("seamless cross decode B=8 over 1024 frames",
         (B_dec, 16, 16, 1, frames, 64, bf16, True), {"causal": False},
         True),
        ("seamless decode B=8 over 128 ring slots",
         (B_dec, 16, 16, 1, AUDIO.cache_len, 64, bf16, True),
         {"q_pos": qpos_s, "k_pos": ring_s}, True),
        # llava-next-34b: 56 heads over 8, hd 128; 2,880 image rows and
        # 512 text tokens
        ("llava prefill S=3392", (1, 56, 8, 3392, 3392, 128, bf16, True),
         {}, True),
        ("llava decode B=8 over 3456 ring slots",
         (B_dec, 56, 8, 1, VLM.cache_len, 128, bf16, True),
         {"q_pos": qpos_l, "k_pos": ring_l}, True),
        # the training path (phase train_lm): qwen1.5-0.5b's batch of 8
        # at S = 256, 16 heads of 64; seamless's encoder over a batch of 2
        ("training prefill B=8, S=256 (qwen1.5-0.5b)",
         (8, 16, 16, 256, 256, 64, bf16, True), {}, False),
        ("training encoder B=2 over 1024 frames (seamless)",
         (2, 16, 16, frames, frames, 64, bf16, True), {"causal": False},
         False),
        ("decode float32", (B_dec, 28, 4, 1, slots, 128, f32, True),
         {"q_pos": qpos_dec, "k_pos": ring}, False),
        ("window 256", (1, 28, 4, 1024, 1024, 128, bf16, False),
         {"window": 256}, False),
        ("softcap 50", (2, 8, 2, 512, 512, 128, bf16, False),
         {"softcap": 50.0}, False),
        ("hd 64 float32, tails", (2, 4, 2, 300, 300, 64, f32, False),
         {"window": 100}, False),
        ("hd 256 (gemma2), window and softcap",
         (1, 8, 4, 700, 700, 256, bf16, False),
         {"window": 256, "softcap": 50.0}, False),
        ("non-causal, Q and K tails", (2, 6, 3, 100, 77, 128, f32, False),
         {"causal": False}, False),
        # the tensor-core routes beyond the served shapes
        ("bf16 prefill hd 64", (1, 28, 4, 1024, 1024, 64, bf16, True), {},
         False),
        ("bf16 prefill S=300, group 7: a row tail",
         (1, 28, 4, 300, 300, 128, bf16, True), {}, False),
        ("decode B=8 over a wrapped ring of 2048 slots",
         (B_dec, 28, 4, 1, slots, 128, bf16, True),
         {"q_pos": qpos_wrap, "k_pos": ring_wrap}, True),
        ("deepseek decode B=8 over a wrapped ring, group 1",
         (B_dec, 16, 16, 1, slots, 128, bf16, True),
         {"q_pos": qpos_wrap, "k_pos": ring_wrap}, True),
    ]
    # the zoo's configurations (phase serve_zoo) at the first zoo
    # prompt's length: gemma2-2b (8 heads over 4 of 256, softcap 50: the
    # CUDA-core route), its local layers windowed at 4,096 and its global
    # ones not; the windowed prefills of qwen2-7b-swa (group 7) and
    # mixtral-8x22b (48 heads over 8, group 6); qwen1.5-4b (MHA, 20
    # heads) at the text traffic's S = 1024; and each decode step over
    # its cache: a 4,096-slot ring wrapped past its window, gemma2's
    # global layers' 8,192 slots
    S_zoo, W_zoo = _zoo_lengths()[0], 4096
    last_z = torch.randint(S_zoo, S_zoo + ZOO.n_new, (B_dec,), generator=gen)
    ring_z = _ring_positions(B_dec, W_zoo, last_z)
    full_z = _ring_positions(B_dec, ZOO.cache_len, last_z)
    qpos_z = last_z.to(torch.int32)[:, None].cuda()
    local = {"window": W_zoo, "softcap": 50.0}
    cases += [
        (f"gemma2 local prefill S={S_zoo}, window 4096, softcap 50",
         (1, 8, 4, S_zoo, S_zoo, 256, bf16, True), local, True),
        (f"gemma2 global prefill S={S_zoo}, softcap 50",
         (1, 8, 4, S_zoo, S_zoo, 256, bf16, True), {"softcap": 50.0}, True),
        ("gemma2 local decode B=8 over a wrapped ring of 4096 slots",
         (B_dec, 8, 4, 1, W_zoo, 256, bf16, True),
         {"q_pos": qpos_z, "k_pos": ring_z, **local}, True),
        ("gemma2 global decode B=8 over 8192 slots",
         (B_dec, 8, 4, 1, ZOO.cache_len, 256, bf16, True),
         {"q_pos": qpos_z, "k_pos": full_z, "softcap": 50.0}, True),
        ("qwen1.5-4b prefill S=1024, group 1",
         (1, 20, 20, 1024, 1024, 128, bf16, True), {}, True),
        ("qwen1.5-4b decode B=8 over 2048 ring slots",
         (B_dec, 20, 20, 1, slots, 128, bf16, True),
         {"q_pos": qpos_dec, "k_pos": ring}, True),
        ("qwen1.5-4b-swa decode B=8 over a wrapped ring of 4096 slots",
         (B_dec, 20, 20, 1, W_zoo, 128, bf16, True),
         {"q_pos": qpos_z, "k_pos": ring_z, "window": W_zoo}, True),
        (f"qwen2-7b-swa prefill S={S_zoo}, window 4096",
         (1, 28, 4, S_zoo, S_zoo, 128, bf16, True), {"window": W_zoo}, True),
        ("qwen2-7b-swa decode B=8 over a wrapped ring of 4096 slots",
         (B_dec, 28, 4, 1, W_zoo, 128, bf16, True),
         {"q_pos": qpos_z, "k_pos": ring_z, "window": W_zoo}, True),
        (f"mixtral prefill S={S_zoo}, window 4096, group 6",
         (1, 48, 8, S_zoo, S_zoo, 128, bf16, True), {"window": W_zoo},
         True),
        ("mixtral decode B=8 over a wrapped ring of 4096 slots",
         (B_dec, 48, 8, 1, W_zoo, 128, bf16, True),
         {"q_pos": qpos_z, "k_pos": ring_z, "window": W_zoo}, True),
    ]
    rows, err_max, timings, kept = [], 0.0, {}, {}
    for name, (B, H, KV, Sq, Skv, hd, dtype, cache), opts, on_path in cases:
        q, k, v = _attn_case(gen, B, H, KV, Sq, Skv, hd, dtype, cache)
        with torch.no_grad():
            out = flash_attention(q, k, v, **opts)
            ref = flash_attention_ref(q.float(), k.float(), v.float(),
                                      **opts)
            torch.cuda.synchronize()
            err = max_err(out.float(), ref)
            excess = attn_excess(out, ref)
            check(excess <= 1.0, f"flash_attention {name}: |kernel - plain| "
                  f"is {excess} x its limit (max {err})")
            again = flash_attention(q, k, v, **opts)
            check(torch.equal(out, again),
                  f"flash_attention {name}: a rerun is not bitwise equal")
        err_max = max(err_max, err)
        kept[name] = (q, k, v, opts, ref)
        rows.append({"case": name,
                     "route": ops.route(Sq, H // KV, hd, dtype),
                     "B": B, "H": H, "KV": KV, "Sq": Sq,
                     "Skv": Skv, "hd": hd, "dtype": str(dtype)[6:],
                     "opts": sorted(opts), "max_abs_err": err,
                     "err_over_limit": excess})
        if not on_path:
            continue
        calls = 100 if Sq * Skv <= 1 << 20 or Sq == 1 else 20
        timings[name] = {**_attn_times(q, k, v, opts, ref, calls),
                         "route": rows[-1]["route"]}
    emit({"phase": "attn_kernel", "kernel": "flash_attention",
          "limit": f"{ATTN_ATOL} + rtol * |plain|, element by element",
          "rtol": {"float32": ATTN_RTOL[f32], "bfloat16": ATTN_RTOL[bf16]},
          "cases": rows, "planted_faults": _planted_faults(kept)})
    emit({"phase": "attn_kernel_times", "kernel": "flash_attention",
          "timings": timings})
    main = timings["prefill S=1024"]
    csrc = "src/repro_torch/kernels/flash_attention/csrc/"
    return {"name": "flash_attention", "route": "cuda",
            "source": csrc + "flash_attention_wgmma.cu",
            "sources": {"wgmma": csrc + "flash_attention_wgmma.cu",
                        "split_k_wgmma": csrc + "flash_attention_wgmma.cu "
                                         "+ flash_attention.cu (combine)",
                        "split_k": csrc + "flash_attention.cu",
                        "cuda_cores": csrc + "flash_attention.cu"},
            "kernels_per_call": {"wgmma": 1, "split_k_wgmma": 2,
                                 "split_k": 2, "cuda_cores": 1},
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:88",
            "max_abs_err": err_max,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "eager_ms": main["eager_ms"],
            "at": {"shape": "qwen2-7b prefill, B=1, H=28, KV=4, hd=128, "
                            "S=1024, causal, bf16",
                   "ms": "device time per call, CUDA graph",
                   "library": "torch.nn.functional."
                              "scaled_dot_product_attention"},
            "decode": timings["decode B=8 over 2048 ring slots"],
            "timings": timings}


# ---------------------------------------------------------------------------
def _stats_of(idx, p, bt):
    """Per-tile (routed count + probability mass) of picks ``idx`` over
    probabilities ``p``, tiles of ``bt`` rows, the last its real rows."""
    T, E = p.shape
    n_tiles = -(-T // bt)
    rows = torch.zeros((n_tiles * bt, E), dtype=p.dtype, device=p.device)
    rows[:T] = torch.zeros_like(p).scatter_(1, idx.long(), 1.0) + p
    return rows.view(n_tiles, bt, E).sum(1)


def route_reading(got, plain, logits) -> dict:
    """A router's output ``got`` = (w, idx, stats) against the plain
    version's on the same logits: the rows whose picks differ, and the
    largest gap between the plain probabilities at the first pick that
    differs and the next (a flip within ROUTE_MARGIN is float drift);
    rows with a repeated index; the weights of the agreeing rows over
    ROUTER_W_ATOL; and the stats over their limit, held to the stats
    of ``got``'s own picks over the plain probabilities (tiles of
    min(128, T) rows, the wrapper's default)."""
    w, idx, stats = got
    w_p, idx_p, _ = plain
    T, E = logits.shape
    p = torch.softmax(logits.float(), dim=-1)
    ordered = torch.sort(idx.long(), dim=-1).values
    repeated = int((ordered[:, 1:] == ordered[:, :-1]).any(-1).sum())
    mismatch = idx != idx_p
    differ = mismatch.any(-1)
    margin = 0.0
    if bool(differ.any()):
        vals = torch.sort(p[differ], dim=-1, descending=True).values
        j = mismatch[differ].int().argmax(-1)[:, None]
        margin = float((vals.gather(1, j) -
                        vals.gather(1, (j + 1).clamp(max=E - 1))).max())
    agree = ~differ
    w_err = (w - w_p).abs()[agree]
    want = _stats_of(idx, p, min(128, T))
    limit = ROUTER_STATS_ATOL + ROUTER_STATS_RTOL * want.abs()
    return {"routes": T, "differ": int(differ.sum()),
            "max_margin_of_differing": margin, "repeated": repeated,
            "w_max_abs_err": float(w_err.max()) if w_err.numel() else 0.0,
            "stats_excess": float(((stats - want).abs() / limit).max())}


def route_ok(r) -> bool:
    return r["repeated"] == 0 and r["w_max_abs_err"] <= ROUTER_W_ATOL and \
        r["stats_excess"] <= 1.0 and \
        (r["differ"] == 0 or r["max_margin_of_differing"] < ROUTE_MARGIN)


def _pallas_like_router(logits, k):
    """A planted fault: a router written as the Pallas kernel's body,
    each pick masked by multiplying by (1 - onehot), so a row whose rest
    underflows to 0 picks index 0 again."""
    p = torch.softmax(logits.float(), dim=-1)
    probs, ws, ids = p, [], []
    for _ in range(k):
        best = probs.argmax(-1)
        ws.append(probs.gather(1, best[:, None])[:, 0])
        ids.append(best)
        probs = probs * (1.0 - torch.zeros_like(p).scatter_(
            1, best[:, None], 1.0))
    w = torch.stack(ws, 1)
    idx = torch.stack(ids, 1)
    return (w / w.sum(-1, keepdim=True), idx.to(torch.int32),
            _stats_of(idx, p, min(128, p.shape[0])))


def _swap_first_and_kth(out):
    """A planted fault: the first and the k-th picks swapped."""
    w, idx, stats = out
    perm = list(range(idx.shape[1]))
    perm[0], perm[-1] = perm[-1], perm[0]
    return w[:, perm], idx[:, perm], stats


def _kth_for_first(out):
    """A planted fault: the k-th pick returned in place of the first
    (an index repeated)."""
    w, idx, stats = out
    w, idx = w.clone(), idx.clone()
    w[:, 0], idx[:, 0] = w[:, -1], idx[:, -1]
    return w, idx, stats


def _block_partial_dropped(out, logits, plan, block):
    """A planted fault: one block's partial stats left out of its tile's
    sum (the cluster's sum over its blocks short one rank)."""
    from repro_torch.kernels.moe_router import ops
    w, idx, stats = out
    rows = ops.block_rows(plan, block)
    rows = slice(rows.start, rows.stop)
    p = torch.softmax(logits.float(), dim=-1)
    stats = stats.clone()
    stats[block // plan.cluster] -= _stats_of(idx[rows], p[rows],
                                              rows.stop - rows.start)[0]
    return w, idx, stats


def _plan_row(plan) -> dict:
    return {"lanes_per_row": plan.lanes, "values_per_lane": plan.per_lane,
            "blocks_per_tile": plan.cluster,
            "rows_per_block": plan.rows_per_block, "threads": plan.threads,
            "blocks": plan.grid, "smem_bytes": plan.smem}


# shapes at which the router's one-block and cluster plans are both
# timed, to place ops.ONE_BLOCK_WORK: deepseek's E = 64, k = 6 at T = 8 to
# 1536, and a jamba prefill (E = 16, k = 2)
ROUTER_CROSSOVER = [(T, 64, 6) for T in (8, 32, 64, 256, 1024, 1536)] + [
    (1326, 16, 2)]


def _library_router(x, k):
    """The library yardstick: softmax, topk and a division, the stats
    by a scatter of the picks."""
    p = torch.softmax(x, dim=-1)
    v, i = torch.topk(p, k)
    return v / v.sum(-1, keepdim=True), i, _stats_of(i, p, min(128,
                                                                x.shape[0]))


def phase_moe_router() -> dict:
    """moe_router against its plain version; returns the kernel's
    record for the kernels line (all but ``launches``)."""
    from repro_torch.kernels.moe_router import moe_router, moe_router_ref, ops
    from repro_torch.kernels.vfl_matmul.ops import empty_launch
    gen = torch.Generator().manual_seed(2)

    def rand(T, E):
        return (torch.randn(T, E, generator=gen) * 2).cuda()
    ties = torch.randint(0, 3, (256, 64), generator=gen).float().cuda()
    underflow = torch.zeros(16, 64)
    underflow[torch.arange(16), torch.arange(16) * 5 % 64] = 200.0
    # name, logits, k, timed (a shape of the serving path: deepseek's
    # E = 64, k = 6 and jamba's E = 16, k = 2)
    cases = [("decode T=8", rand(8, 64), 6, True),
             ("prefill T=1326", rand(1326, 64), 6, True),
             ("prefill T=1536", rand(1536, 64), 6, True),
             ("jamba decode T=8, E=16 k=2", rand(8, 16), 2, True),
             ("jamba prefill T=1326, E=16 k=2", rand(1326, 16), 2, True),
             ("mixtral decode T=8, E=8 k=2", rand(8, 8), 2, True),
             (f"mixtral prefill T={_zoo_lengths()[0]}, E=8 k=2",
              rand(_zoo_lengths()[0], 8), 2, True),
             ("training T=2048 (deepseek, B=8 x S=256)", rand(2048, 64), 6,
              False),
             ("jamba training T=512, E=16 k=2", rand(512, 16), 2, False),
             ("T=1", rand(1, 64), 6, False),
             ("T=200, a tail tile of 72 rows", rand(200, 64), 6, False),
             ("mixtral E=8 k=2, T=384", rand(384, 8), 2, False),
             ("E=256 k=8, T=300", rand(300, 256), 8, False),
             ("k = E = 5, T=77", rand(77, 5), 5, False),
             ("exact ties", ties, 6, False),
             ("rows that underflow", underflow.cuda(), 6, False)]
    # the launch floor: an empty kernel in the same CUDA-graph harness
    floor_ms = device_ms(lambda: empty_launch())
    rows, err_max, kept, timings = [], 0.0, {}, {}
    for name, x, k, timed in cases:
        out = moe_router(x, k)
        plain = moe_router_ref(x, k)
        torch.cuda.synchronize()
        r = route_reading(out, plain, x)
        check(route_ok(r), f"moe_router {name}: {r}")
        if name in ("exact ties", "rows that underflow"):
            check(r["differ"] == 0, f"moe_router {name}: picks differ {r}")
        again = moe_router(x, k)
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"moe_router {name}: a rerun is not bitwise equal")
        err_max = max(err_max, r["w_max_abs_err"])
        kept[name] = (x, k, out, plain)
        rows.append({"case": name, "T": x.shape[0], "E": x.shape[1], "k": k,
                     **r})
        if not timed:
            continue
        lib = _library_router(x, k)
        r_lib = route_reading(lib, plain, x)
        check(route_ok(r_lib), f"softmax + topk yardstick {name}: {r_lib}")
        fns = {"": lambda: moe_router(x, k),
               "plain_": lambda: moe_router_ref(x, k),
               "library_": lambda: _library_router(x, k)}
        times = {}
        for key, fn in fns.items():
            times[key + "ms"] = device_ms(fn)
            times[key + "eager_ms"] = eager_ms(fn, 100)
        T, E = x.shape
        nbytes, n_ops = W.router_work(T, E, k)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / FP32_FLOP_PER_S * 1e3
        timings[name] = {"T": T, "E": E, "k": k, **times,
                         "launch_floor_ms": floor_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations", "bytes": nbytes, "ops": n_ops,
                         "plan": _plan_row(ops.plan(T, E, k))}

    x, k, out, plain = kept["decode T=8"]
    faults = {"first and k-th picks swapped":
                  route_reading(_swap_first_and_kth(out), plain, x)}
    x, k, out, plain = kept["rows that underflow"]
    faults["Pallas masking: index 0 picked again"] = route_reading(
        _pallas_like_router(x, k), plain, x)
    x, k, out, plain = kept["prefill T=1326"]
    p = torch.softmax(x, dim=-1)
    short = out[2].clone()
    short[-1] -= _stats_of(out[1][-1:], p[-1:], 1)[0]
    faults["tail tile short its last row"] = route_reading(
        (out[0], out[1], short), plain, x)
    # tile 3 without rank 5's 16 rows (a cluster of 8 at T=1326)
    faults["one block's partial stats dropped from a tile"] = route_reading(
        _block_partial_dropped(out, x, ops.plan(*x.shape, k), 29), plain, x)
    for fault, r in faults.items():
        check(not route_ok(r), f"planted fault '{fault}' passed the "
              f"moe_router check: {r}")
    emit({"phase": "moe_router", "kernel": "moe_router",
          "limits": {"route_margin": ROUTE_MARGIN,
                     "w_atol": ROUTER_W_ATOL,
                     "stats": f"{ROUTER_STATS_ATOL} + {ROUTER_STATS_RTOL} "
                              "* |plain|"},
          "cases": rows, "planted_faults": faults})
    # where ops.plan switches from one block to a cluster: both timed
    crossover = {}
    for T, E, k in ROUTER_CROSSOVER:
        x, bt = rand(T, E), min(128, T)
        plain = moe_router_ref(x, k)
        at = f"T={T}, E={E}, k={k}"
        crossover[at] = {"picked": "cluster" if ops.plan(T, E, k).cluster
                         > 1 else "one block"}
        outs = []
        for name, c in (("one block", 1), ("cluster", ops.MAX_CLUSTER)):
            p = ops.plan(T, E, k, cluster=c)
            outs.append(ops._launch(x, k, bt, launch=p))
            r = route_reading(outs[-1], plain, x)
            check(route_ok(r), f"moe_router crossover {at} {name}: {r}")
            crossover[at][name] = {
                "ms": device_ms(lambda p=p: ops._launch(x, k, bt, launch=p)),
                "blocks": p.grid, "threads": p.threads}
        # a row's picks and weights do not depend on the plan
        check(torch.equal(outs[0][0], outs[1][0]) and
              torch.equal(outs[0][1], outs[1][1]),
              f"moe_router crossover {at}: the plans' routes differ")
    emit({"phase": "moe_router_times", "kernel": "moe_router",
          "timings": timings, "crossover": crossover,
          "one_block_work": ops.ONE_BLOCK_WORK})
    main = timings["decode T=8"]
    return {"name": "moe_router", "route": "cuda",
            "source": "src/repro_torch/kernels/moe_router/csrc/"
                      "moe_router.cu",
            "replaces": "src/repro/kernels/moe_router/moe_router.py:51",
            "max_abs_err": err_max,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "eager_ms": main["eager_ms"],
            "launch_floor_ms": floor_ms, "plan": main["plan"],
            "at": {"shape": "deepseek-moe-16b decode step, T=8, E=64, k=6",
                   "ms": "device time per call, CUDA graph of 100 calls",
                   "library": "torch.softmax + torch.topk + division, "
                              "stats by scatter"},
            "timings": timings}


# ---------------------------------------------------------------------------
def scan_excess(out, ref) -> float:
    """The largest |out - ref| over its limit, SCAN_ATOL * max(1,
    |ref|max) + SCAN_RTOL * |ref| with ref the plain float32 result (a
    bf16 ``out`` gets the bf16 rtol): 1 or less passes."""
    rtol = SCAN_RTOL[out.dtype]
    limit = SCAN_ATOL * max(1.0, float(ref.abs().max())) + \
        rtol * ref.abs()
    return float(((out.float() - ref).abs() / limit).max())


def _scan_reading(got, plain) -> dict:
    """A scan's (output, state) against the plain version's float32
    (output, state): the excess of each over its limit, and the max
    |difference|."""
    (o, s), (o_p, s_p) = got, plain
    return {"excess": scan_excess(o, o_p),
            "state_excess": scan_excess(s, s_p),
            "max_abs_err": max(max_err(o.float(), o_p), max_err(s, s_p))}


def _scan_ok(r) -> bool:
    return r["excess"] <= 1.0 and r["state_excess"] <= 1.0


def _scan_timings(fn, plain, decode, nbytes, flops, exps=0) -> dict:
    """Kernel and plain version timed on the same inputs (CUDA graphs of
    100 calls at a decode step; at a prefill 20 kernel calls and one
    call of the plain version's Python loop over T), eager, and the
    bound: the largest of the bytes over HBM_BYTES_PER_S, the float32
    operations over FP32_FLOP_PER_S and the exponentials over
    SFU_EXP_PER_S (``bound_detail`` names which)."""
    calls, plain_calls = (100, 100) if decode else (20, 1)
    times = {"ms": device_ms(fn, calls=calls, replays=3),
             "eager_ms": eager_ms(fn, calls),
             "plain_ms": device_ms(plain, calls=plain_calls, replays=2),
             "plain_eager_ms": eager_ms(plain, plain_calls),
             "library_ms": None}
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32 operations": flops / FP32_FLOP_PER_S * 1e3,
             "exponentials": exps / SFU_EXP_PER_S * 1e3 if exps else 0.0}
    detail = max(parts, key=parts.get)
    return {**times, "bound_ms": parts[detail],
            "bound_by": "bytes" if detail == "bytes" else "operations",
            "bound_detail": detail, "bound_parts_ms": parts,
            "bytes": nbytes, "flops": flops, "exps": exps}


def _rwkv_inputs(gen, B, T, H, hd, dtype, with_state, edge=False):
    """r, k, v ~ N(0, 1) and the decay of rwkv6's init, w =
    exp(-exp(-4 + 0.5 N(0, 1))) (w near 0.98: ~50 steps of memory), u
    its init 0.5 plus noise; a random state ~ 3 N(0, 1), the size the
    serving path's states reach.  ``edge``: 10% of w exactly 0 and 30%
    exactly 1 - 2^-24."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    r, k, v = rand(B, T, H, hd), rand(B, T, H, hd), rand(B, T, H, hd)
    w = torch.exp(-torch.exp(-4 + 0.5 * rand(B, T, H, hd)))
    if edge:
        pick = torch.rand(B, T, H, hd, generator=gen).cuda()
        w = torch.where(pick < 0.1, 0.0, w)
        w = torch.where(pick > 0.7, 1 - 2.0 ** -24, w)
    u = 0.5 + 0.1 * rand(H, hd)
    s0 = 3 * rand(B, H, hd, hd) if with_state else None
    return [x.to(dtype) for x in (r, k, v, w)] + [u, s0]


def _rwkv_update_first(r, k, v, w, u, state):
    """A planted fault: the state updated before the output is read,
    o_t = r_t (S_t + u k_t v_t) with S_t already holding step t."""
    B, T, H, hd = r.shape
    S = state.clone()
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None].float() * v[:, t, :, None, :].float()
        S = w[:, t, :, :, None].float() * S + kv
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                                 S + u[..., None] * kv))
    return torch.stack(outs, 1), S


def _rwkv_chunked_fault(r, k, v, w, u, state, *, shift_starts=False,
                        inclusive=False):
    """Planted faults of the chunked route: ``rwkv6_scan_chunked_ref``
    with each chunk replayed from the previous chunk's start state
    (``shift_starts``; chunk 0 from its own), or with the suffix products
    one step too long, P_s = prod_{s <= tau < L} w_tau (``inclusive``)."""
    from repro_torch.kernels.rwkv6_scan import ops, ref
    B, T, H, hd = r.shape
    rc, kc, vc = (ref.chunks(x, ops.CHUNK, 0.0) for x in (r, k, v))
    wc = ref.chunks(w, ops.CHUNK, 1.0)
    dS, D = [], []
    for c in range(rc.shape[1]):
        P, Dc = ref.suffix_products(wc[:, c])
        dS.append(ref.chunk_summary(kc[:, c], vc[:, c],
                                    P * wc[:, c] if inclusive else P))
        D.append(Dc)
    starts, S = ref.chunk_states(torch.stack(dS, 1), torch.stack(D, 1),
                                 state)
    if shift_starts:
        starts = torch.cat([starts[:, :1], starts[:, :-1]], 1)
    o = ref.chunk_outputs(rc, kc, vc, wc, u, starts)
    return o.reshape(B, -1, H, hd)[:, :T], S


# name, (B, T, H, hd, dtype, from a state, w with exact zeros and 1 -
# 2^-24), timed (the serving path's shape), launcher (None: the wrapper,
# on ops.route's route; else that route's launcher, for the chunked
# kernels' edges the wrapper routes elsewhere): rwkv6-1.6b's prefill of
# the first and the longest prompt, a decode step of 8 slots; then what
# the path does not run
RWKV_CASES = [
    ("prefill T=1326", (1, 1326, 32, 64, torch.float32, False, False), True,
     None),
    ("prefill T=1536", (1, 1536, 32, 64, torch.float32, False, False), True,
     None),
    ("decode B=8", (8, 1, 32, 64, torch.float32, True, False), True, None),
    ("hd 128, B=2, T=300, from a state",
     (2, 300, 4, 128, torch.float32, True, False), False, None),
    ("hd 128, bf16 inputs, B=2, T=300",
     (2, 300, 4, 128, torch.bfloat16, False, False), False, None),
    ("bf16 inputs, T=512, from a state",
     (1, 512, 32, 64, torch.bfloat16, True, False), False, None),
    ("B=4, T=700, from a state", (4, 700, 32, 64, torch.float32, True, False),
     False, None),
    ("training B=8, T=256 (rwkv6-1.6b)",
     (8, 256, 32, 64, torch.float32, False, False), False, None),
    ("w with exact zeros and 1 - 2^-24, T=300, from a state",
     (1, 300, 32, 64, torch.float32, True, True), False, None),
    ("T=46, from a state (a chunk short)",
     (1, 46, 32, 64, torch.float32, True, False), False, None),
    ("T=46, from a state, sequential kernel",
     (1, 46, 32, 64, torch.float32, True, False), False, "sequential"),
    ("T=64, from a state (one whole chunk)",
     (1, 64, 32, 64, torch.float32, True, False), False, None),
    ("T=64, from a state, sequential kernel",
     (1, 64, 32, 64, torch.float32, True, False), False, "sequential")]
# where ops.route switches: both routes timed at B = 1, H = 32, hd = 64
RWKV_CROSSOVER_T = (16, 32, 48, 64, 128, 256)


def phase_rwkv6_scan() -> dict:
    """rwkv6_scan against its plain version; returns the kernel's record
    for the kernels line (all but ``launches``)."""
    from repro_torch.kernels.rwkv6_scan import ops, rwkv6_scan, \
        rwkv6_scan_ref
    gen = torch.Generator().manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    rows, kept, timings, err_max = [], {}, {}, 0.0
    for name, (B, T, H, hd, dtype, with_state, edge), timed, launcher in \
            RWKV_CASES:
        r, k, v, w, u, s0 = _rwkv_inputs(gen, B, T, H, hd, dtype,
                                         with_state, edge)
        route = launcher or ops.route(B, T, H, hd)

        def scan(r=r, k=k, v=v, w=w, u=u, s0=s0, launcher=launcher):
            if launcher is None:
                return rwkv6_scan(r, k, v, w, u, s0)
            return ops._launch(launcher, r, k, v, w, u, s0, None)
        with torch.no_grad():
            out = scan()
            plain = rwkv6_scan_ref(r.float(), k.float(), v.float(),
                                   w.float(), u, s0)
            torch.cuda.synchronize()
            reading = _scan_reading(out, plain)
            check(_scan_ok(reading), f"rwkv6_scan {name}: {reading}")
            again = scan()
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"rwkv6_scan {name}: a rerun is not bitwise equal")
        err_max = max(err_max, reading["max_abs_err"])
        kept[name] = (r, k, v, w, u, s0, out, plain)
        rows.append({"case": name, "route": route, "B": B, "T": T, "H": H,
                     "hd": hd, "dtype": str(dtype)[6:],
                     "from_state": with_state, "edge_decay": edge,
                     **reading})
        if not timed:
            continue
        nbytes, flops = W.rwkv6_scan_work(r, u, with_state)
        timings[name] = {"route": route, **_scan_timings(
            scan, lambda: rwkv6_scan_ref(r, k, v, w, u, s0),
            T == 1, nbytes, flops)}
        if route == "chunked":
            # the sequential kernel on the same inputs: the "before"
            seq = device_ms(lambda: ops._launch("sequential", r, k, v, w,
                                                u, s0, None),
                            calls=20, replays=3)
            timings[name].update(sequential_ms=seq, sequential_over_chunked=
                                 seq / timings[name]["ms"])
    crossover = {}
    for T in RWKV_CROSSOVER_T:
        r, k, v, w, u, s0 = _rwkv_inputs(gen, 1, T, 32, 64, f32, False)
        crossover[T] = {"route": ops.route(1, T, 32, 64), **{
            name: device_ms(lambda: ops._launch(name, r, k, v, w, u, s0,
                                                None), calls=20, replays=3)
            for name in ("sequential", "chunked")}}

    r, k, v, w, u, s0, (o, s), plain = kept["prefill T=1326"]
    T = r.shape[1]
    # a split on the chunk grid (both halves chunked): bitwise one run
    T1 = 11 * ops.CHUNK
    check({ops.route(1, T1, 32, 64), ops.route(1, T - T1, 32, 64)} ==
          {"chunked"}, f"rwkv6_scan: a split at {T1} leaves the chunked "
          f"route")
    with torch.no_grad():
        o1, s1 = rwkv6_scan(r[:, :T1], k[:, :T1], v[:, :T1], w[:, :T1], u)
        o2, s2 = rwkv6_scan(r[:, T1:], k[:, T1:], v[:, T1:], w[:, T1:], u,
                            s1)
    split = torch.equal(torch.cat([o1, o2], 1), o) and torch.equal(s2, s)
    check(split, f"rwkv6_scan: {T1} steps then the rest from the state "
          f"differ from one run of {T}")
    # off the grid (the old split point): within the limit
    T1 = T * 53 // 100
    with torch.no_grad():
        o1, s1 = rwkv6_scan(r[:, :T1], k[:, :T1], v[:, :T1], w[:, :T1], u)
        o2, s2 = rwkv6_scan(r[:, T1:], k[:, T1:], v[:, T1:], w[:, T1:], u,
                            s1)
    off_grid = _scan_reading((torch.cat([o1, o2], 1), s2), plain)
    check(_scan_ok(off_grid), f"rwkv6_scan: {T1} steps then the rest: "
          f"{off_grid}")
    # the state written over the input state in place, prefill and decode
    for name in ("B=4, T=700, from a state", "decode B=8"):
        r, k, v, w, u, s0, (o, s), _ = kept[name]
        s_in = s0.clone()
        with torch.no_grad():
            o_in, _ = rwkv6_scan(r, k, v, w, u, s_in, state_out=s_in)
        check(torch.equal(s_in, s) and torch.equal(o_in, o),
              f"rwkv6_scan {name}: the in-place state differs")

    r, k, v, w, u, s0, _, plain = kept["decode B=8"]
    with torch.no_grad():
        faults = {
            "bonus u dropped": _scan_reading(
                rwkv6_scan(r, k, v, w, torch.zeros_like(u), s0), plain),
            "state updated before the output is read": _scan_reading(
                _rwkv_update_first(r, k, v, w, u, s0), plain),
            "input state ignored": _scan_reading(
                rwkv6_scan(r, k, v, w, u), plain)}
        r, k, v, w, u, s0, _, plain = kept["prefill T=1326"]
        faults.update({
            "each chunk replayed from the previous chunk's start state":
                _scan_reading(_rwkv_chunked_fault(r, k, v, w, u, s0,
                                                  shift_starts=True), plain),
            "a suffix product off by one step": _scan_reading(
                _rwkv_chunked_fault(r, k, v, w, u, s0, inclusive=True),
                plain)})
    for fault, reading in faults.items():
        check(not _scan_ok(reading), f"planted fault '{fault}' passed the "
              f"rwkv6_scan check: {reading}")
    emit({"phase": "rwkv6_scan", "kernel": "rwkv6_scan",
          "limit": f"{SCAN_ATOL} * max(1, |plain|max) + rtol * |plain|, "
                   "element by element",
          "rtol": {"float32": SCAN_RTOL[f32], "bfloat16": SCAN_RTOL[bf16]},
          "cases": rows, "split_on_chunk_grid_bitwise": split,
          "split_off_grid": off_grid, "in_place": True,
          "planted_faults": faults})
    emit({"phase": "rwkv6_scan_times", "kernel": "rwkv6_scan",
          "timings": timings, "route_crossover": crossover,
          "chunked_min_t": ops.CHUNKED_MIN_T})
    main = timings["prefill T=1536"]
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6_scan/csrc/"
                      "rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:59",
            "max_abs_err": err_max,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "eager_ms": main["eager_ms"],
            "kernel_route": main["route"],
            "sequential_ms": main["sequential_ms"],
            "at": {"shape": "rwkv6-1.6b prefill, B=1, T=1536, H=32, hd=64, "
                            "float32 inputs",
                   "ms": "device time per call, CUDA graph of 20 calls",
                   "sequential_ms": "the sequential route on the same "
                                    "inputs, the same way",
                   "library": "none: no single PyTorch call computes "
                              "this recurrence"},
            "decode": timings["decode B=8"], "timings": timings}


def _mamba_inputs(gen, B, T, D, N, dtype, with_state):
    """The discretised inputs as the model makes them: a = exp(dt A)
    with dt = softplus(N(0, 1)) and A = -(1 .. N), bx ~ 0.5 N(0, 1),
    c ~ N(0, 1); a random h ~ N(0, 1)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    dt = torch.nn.functional.softplus(rand(B, T, D))
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dt.device)
    a = torch.exp(dt[..., None] * A)
    bx, c = 0.5 * rand(B, T, D, N), rand(B, T, N)
    h0 = rand(B, D, N) if with_state else None
    return [x.to(dtype) for x in (a, bx, c)] + [h0]


def _mamba_y_from_previous(a, bx, c, h0=None, *, h_out=None):
    """A planted fault: y read from h_{t-1} (before the step's update),
    y_t = h_{t-1} . c_t.  The kernel fed c shifted one step earlier
    gives h_t . c_{t+1}, which is y_{t+1} of the fault."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    shifted = torch.cat([c[:, 1:], c[:, -1:]], 1)
    y, h = mamba_scan(a, bx, shifted, h0, h_out=h_out)
    first = torch.zeros_like(y[:, :1]) if h0 is None else torch.einsum(
        "bdn,bn->bd", h0, c[:, 0].float())[:, None].to(y.dtype)
    return torch.cat([first, y[:, :-1]], 1), h


def _last_channel_short(out):
    """A planted fault: the last channel tile one channel short, its
    last channel's y and h never written (zero here)."""
    y, h = (t.clone() for t in out)
    y[..., -1] = 0
    h[:, -1] = 0
    return y, h


def _fused_inputs(gen, B, T, D, N, dtype, with_state):
    """The fused scan's inputs as the model makes them: dt = softplus(N(0,
    1)) float32, x, B, C ~ N(0, 1) in the model's dtype with B and C
    views of one projection row (jamba's dt_rank 256 columns, then B,
    then C), A = -(1 .. N) for every channel; a random h ~ N(0, 1)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    dt = torch.nn.functional.softplus(rand(B, T, D))
    x = rand(B, T, D).to(dtype)
    proj = rand(B, T, 256 + 2 * N).to(dtype)
    A = -torch.exp(torch.log(torch.arange(
        1, N + 1, dtype=torch.float32, device=dt.device))).expand(
            D, N).contiguous()
    h0 = rand(B, D, N) if with_state else None
    return dt, x, proj[..., 256:256 + N], proj[..., 256 + N:], A, h0


def _fused_y_from_previous(dt, x, Bm, Cm, A, h0=None, *, h_out=None):
    """A planted fault of the fused scan: y read from h_{t-1}, as
    ``_mamba_y_from_previous``."""
    from repro_torch.kernels.mamba_scan import mamba_scan_fused
    shifted = torch.cat([Cm[:, 1:], Cm[:, -1:]], 1)
    y, h = mamba_scan_fused(dt, x, Bm, shifted, A, h0, h_out=h_out)
    first = torch.zeros_like(y[:, :1]) if h0 is None else torch.einsum(
        "bdn,bn->bd", h0, Cm[:, 0].float())[:, None]
    return torch.cat([first, y[:, :-1]], 1), h


def _fused_dt_late(dt, x, Bm, Cm, A, h0=None, *, h_out=None):
    """A planted fault: dt one step late, as a staging ring off by one
    would pair it: step t discretised with dt_{t-1} (dt_{-1} = 0)."""
    from repro_torch.kernels.mamba_scan import mamba_scan_fused
    late = torch.cat([torch.zeros_like(dt[:, :1]), dt[:, :-1]], 1)
    return mamba_scan_fused(late, x, Bm, Cm, A, h0, h_out=h_out)


def _fused_short(dt, x, Bm, Cm, A, h0=None, *, h_out=None):
    """A planted fault: the fused kernel's last channel tile one channel
    short."""
    from repro_torch.kernels.mamba_scan import mamba_scan_fused
    return _last_channel_short(mamba_scan_fused(dt, x, Bm, Cm, A, h0,
                                                h_out=h_out))


def _discretise_then_scan(dt, x, Bm, Cm, A, h0=None):
    """The "before": the model's discretisation (a, bx materialised in
    float32) and the unfused kernel."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    a = torch.exp(dt[..., None] * A)
    bx = (dt * x)[..., None] * Bm[..., None, :].to(dt.dtype)
    return mamba_scan(a, bx, Cm.float(), h0)


# name, (B, T, D, N, model dtype, from a state), timed (the serving
# path's shape): jamba's prefill of the first and the longest prompt in
# its bf16 (dt float32, x, B and C bf16), a decode step of 8 slots; then
# what the path does not run
FUSED_SPLIT_CASE = "N=8, D=1000 (a tile of 40 channels), B=2, T=300"
FUSED_TAIL_CASE = "D=8190 (staged by plain loads; the last tile 30 " \
    "channels), T=64"
FUSED_CASES = [
    ("prefill T=1326", (1, 1326, 8192, 16, torch.bfloat16, False), True),
    ("prefill T=1536", (1, 1536, 8192, 16, torch.bfloat16, False), True),
    ("decode B=8", (8, 1, 8192, 16, torch.bfloat16, True), True),
    ("float32 model, T=300, from a state",
     (1, 300, 8192, 16, torch.float32, True), False),
    (FUSED_SPLIT_CASE, (2, 300, 1000, 8, torch.float32, True), False),
    (FUSED_TAIL_CASE, (1, 64, 8190, 16, torch.bfloat16, True), False),
    ("B=2, T=200, from a state", (2, 200, 8192, 16, torch.bfloat16, True),
     False),
    ("training B=2, T=256 (jamba)", (2, 256, 8192, 16, torch.bfloat16, False),
     False)]


def _phase_mamba_fused(gen) -> dict:
    """mamba_scan_fused against its plain version: the cases, a split run
    and reruns bitwise, the state in place, four planted faults, and the
    times beside the "before" (the discretisation + the unfused kernel)
    on the same inputs in one CUDA graph."""
    from repro_torch.kernels.mamba_scan import (
        mamba_scan_fused, mamba_scan_fused_ref)
    rows, kept, timings, err_max = [], {}, {}, 0.0
    for name, (B, T, D, N, dtype, with_state), timed in FUSED_CASES:
        args = _fused_inputs(gen, B, T, D, N, dtype, with_state)
        with torch.no_grad():
            out = mamba_scan_fused(*args)
            plain = mamba_scan_fused_ref(*args)
            torch.cuda.synchronize()
            reading = _scan_reading(out, plain)
            check(_scan_ok(reading), f"mamba_scan_fused {name}: {reading}")
            again = mamba_scan_fused(*args)
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"mamba_scan_fused {name}: a rerun is not bitwise equal")
        err_max = max(err_max, reading["max_abs_err"])
        kept[name] = (args, out, plain)
        rows.append({"case": name, "B": B, "T": T, "D": D, "N": N,
                     "model_dtype": str(dtype)[6:], "from_state": with_state,
                     **reading})
        if not timed:
            continue
        nbytes, flops, exps = W.mamba_scan_fused_work(*args[:3], args[4],
                                                      args[5])
        with torch.no_grad():
            timings[name] = _scan_timings(
                lambda: mamba_scan_fused(*args),
                lambda: mamba_scan_fused_ref(*args), T == 1, nbytes, flops,
                exps)
            # the "before" on the same inputs: graphs of 5 calls at a
            # prefill (each holds 2 x 0.8 GB of a and bx at T = 1536)
            timings[name]["before_ms"] = device_ms(
                lambda: _discretise_then_scan(*args),
                calls=100 if T == 1 else 5, replays=3)
        timings[name]["before_over_fused"] = \
            timings[name]["before_ms"] / timings[name]["ms"]

    args, (y, h), plain = kept[FUSED_SPLIT_CASE]
    dt, x, Bm, Cm, A, h0 = args
    T1 = dt.shape[1] * 41 // 100
    with torch.no_grad():
        y1, h1 = mamba_scan_fused(dt[:, :T1], x[:, :T1], Bm[:, :T1],
                                  Cm[:, :T1], A, h0)
        y2, h2 = mamba_scan_fused(dt[:, T1:], x[:, T1:], Bm[:, T1:],
                                  Cm[:, T1:], A, h1)
    split = torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    check(split, f"mamba_scan_fused: {T1} steps then the rest from the "
          f"state differ from one run of {dt.shape[1]}")
    for name in ("decode B=8", "B=2, T=200, from a state"):
        args, (y, h), _ = kept[name]
        h_in = args[5].clone()
        with torch.no_grad():
            y_in, _ = mamba_scan_fused(*args[:5], h_in, h_out=h_in)
        check(torch.equal(h_in, h) and torch.equal(y_in, y),
              f"mamba_scan_fused {name}: the in-place state differs")

    with torch.no_grad():
        args, _, plain = kept[FUSED_SPLIT_CASE]
        faults = {
            "dt one step late": _scan_reading(_fused_dt_late(*args), plain),
            "y read from h_{t-1}": _scan_reading(
                _fused_y_from_previous(*args), plain)}
        args, _, plain = kept["decode B=8"]
        faults["input h ignored"] = _scan_reading(
            mamba_scan_fused(*args[:5]), plain)
        args, out, plain = kept[FUSED_TAIL_CASE]
        faults["last channel tile short one channel"] = _scan_reading(
            _last_channel_short(out), plain)
    for fault, reading in faults.items():
        check(not _scan_ok(reading), f"planted fault '{fault}' passed the "
              f"mamba_scan_fused check: {reading}")
    return {"cases": rows, "split_bitwise": split, "in_place": True,
            "planted_faults": faults, "timings": timings,
            "max_abs_err": err_max}


# name, (B, T, D, N, dtype, from a state), timed (the serving path's
# shape): jamba's prefill of the first and the longest prompt, a decode
# step of 8 slots; then what the path does not run
SPLIT_CASE = "N=8, D=1000 (a tile of 8 channels), B=2, T=300"
TAIL_CASE = "D=8190 (the last tile 14 channels), T=64"
MAMBA_CASES = [
    ("prefill T=1326", (1, 1326, 8192, 16, torch.float32, False), True),
    ("prefill T=1536", (1, 1536, 8192, 16, torch.float32, False), True),
    ("decode B=8", (8, 1, 8192, 16, torch.float32, True), True),
    (SPLIT_CASE, (2, 300, 1000, 8, torch.float32, True), False),
    (TAIL_CASE, (1, 64, 8190, 16, torch.float32, True), False),
    ("bf16 inputs, T=512, from a state",
     (1, 512, 8192, 16, torch.bfloat16, True), False)]


def phase_mamba_scan() -> dict:
    """mamba_scan against its plain version; returns the kernel's record
    for the kernels line (all but ``launches``)."""
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    gen = torch.Generator().manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    rows, kept, timings, err_max = [], {}, {}, 0.0
    for name, (B, T, D, N, dtype, with_state), timed in MAMBA_CASES:
        a, bx, c, h0 = _mamba_inputs(gen, B, T, D, N, dtype, with_state)
        with torch.no_grad():
            out = mamba_scan(a, bx, c, h0)
            plain = mamba_scan_ref(a.float(), bx.float(), c.float(), h0)
            torch.cuda.synchronize()
            reading = _scan_reading(out, plain)
            check(_scan_ok(reading), f"mamba_scan {name}: {reading}")
            again = mamba_scan(a, bx, c, h0)
            check(all(torch.equal(x, y) for x, y in zip(out, again)),
                  f"mamba_scan {name}: a rerun is not bitwise equal")
        err_max = max(err_max, reading["max_abs_err"])
        kept[name] = (a, bx, c, h0, out, plain)
        rows.append({"case": name, "B": B, "T": T, "D": D, "N": N,
                     "dtype": str(dtype)[6:], "from_state": with_state,
                     **reading})
        if not timed:
            continue
        nbytes, flops = W.mamba_scan_work(a, c, with_state)
        timings[name] = _scan_timings(
            lambda: mamba_scan(a, bx, c, h0),
            lambda: mamba_scan_ref(a, bx, c, h0),
            T == 1, nbytes, flops)

    a, bx, c, h0, (y, h), _ = kept[SPLIT_CASE]
    T1 = a.shape[1] * 41 // 100
    with torch.no_grad():
        y1, h1 = mamba_scan(a[:, :T1], bx[:, :T1], c[:, :T1], h0)
        y2, h2 = mamba_scan(a[:, T1:], bx[:, T1:], c[:, T1:], h1)
    split = torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    check(split, f"mamba_scan: {T1} steps then the rest from the state "
          f"differ from one run of {a.shape[1]}")
    a, bx, c, h0, (y, h), plain = kept["decode B=8"]
    h_in = h0.clone()
    with torch.no_grad():
        mamba_scan(a, bx, c, h_in, h_out=h_in)
    check(torch.equal(h_in, h), "mamba_scan: the in-place state differs")

    with torch.no_grad():
        a, bx, c, h0, _, plain = kept[SPLIT_CASE]
        faults = {"y read from h_{t-1}": _scan_reading(
            _mamba_y_from_previous(a, bx, c, h0), plain)}
        a, bx, c, h0, _, plain = kept["decode B=8"]
        faults["input h ignored"] = _scan_reading(mamba_scan(a, bx, c),
                                                  plain)
        a, bx, c, h0, out, plain = kept[TAIL_CASE]
        faults["last channel tile short one channel"] = _scan_reading(
            _last_channel_short(out), plain)
    for fault, reading in faults.items():
        check(not _scan_ok(reading), f"planted fault '{fault}' passed the "
              f"mamba_scan check: {reading}")
    emit({"phase": "mamba_scan", "kernel": "mamba_scan",
          "limit": f"{SCAN_ATOL} * max(1, |plain|max) + rtol * |plain|, "
                   "element by element",
          "rtol": {"float32": SCAN_RTOL[f32], "bfloat16": SCAN_RTOL[bf16]},
          "cases": rows, "split_bitwise": split, "in_place": True,
          "planted_faults": faults})
    emit({"phase": "mamba_scan_times", "kernel": "mamba_scan",
          "timings": timings})
    fused = _phase_mamba_fused(gen)
    fused_times = fused.pop("timings")
    emit({"phase": "mamba_scan_fused", "kernel": "mamba_scan_fused",
          "limit": f"{SCAN_ATOL} * max(1, |plain|max) + rtol * |plain|, "
                   "element by element against the float32 output",
          "rtol": SCAN_RTOL[f32], **fused})
    emit({"phase": "mamba_scan_fused_times", "kernel": "mamba_scan_fused",
          "timings": fused_times})
    main = fused_times["prefill T=1536"]
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                      "mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:55",
            "max_abs_err": max(err_max, fused["max_abs_err"]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_detail": main["bound_detail"],
            "library_ms": None, "eager_ms": main["eager_ms"],
            "before_ms": main["before_ms"],
            "at": {"shape": "jamba-v0.1-52b prefill, B=1, T=1536, D=8192, "
                            "N=16, dt float32, x, B, C bf16, through "
                            "mamba_scan_fused (the serving path's route)",
                   "ms": "device time per call, CUDA graph of 20 calls",
                   "before_ms": "the model's discretisation and the "
                                "unfused kernel on the same inputs, CUDA "
                                "graph of 5 calls",
                   "library": "none: no single PyTorch call computes "
                              "this recurrence"},
            "routes": {
                "fused": {"entry": "mamba_scan_fused", "launches": None,
                          "timings": fused_times},
                "unfused": {"entry": "mamba_scan (the Pallas signature: "
                                     "a, bx, c)", "launches": None,
                            "timings": timings}},
            "decode": fused_times["decode B=8"]}


# ---------------------------------------------------------------------------
def _round_one(pcfg, lane):
    """Round 1 of ``pcfg``'s training on ``lane`` from the weights and
    batches ``DeVertiFL.train`` draws first."""
    from repro_torch.core.protocol import (DeVertiFL, round_generator,
                                           train_generators)
    fed = DeVertiFL(pcfg.replace(first_layer=lane), device="cuda")
    init_gen, _ = train_generators(pcfg.seed)
    params = fed.init_params(init_gen)
    _, _, _, losses = fed.run_round(params, fed.opt.init(params), 0,
                                    fed.perms(round_generator(pcfg.seed,
                                                              0)))
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
    out["steps_per_s"] = steps / train_s
    return out


def _same_run(a, b) -> bool:
    """Bitwise: the final metrics and params, and the losses of every
    round ``a`` ran (a resumed run holds the last rounds of ``b``)."""
    from repro_torch.tree import tree_leaves
    tail = b.history[len(b.history) - len(a.history):]
    return (len(a.history) == len(b.history) - (a.resumed_from or 0)
            and all(x["round"] == y["round"] and torch.equal(
                torch.as_tensor(x["round_losses"]),
                torch.as_tensor(y["round_losses"]))
                    for x, y in zip(a.history, tail))
            and a.metrics == b.metrics
            and all(torch.equal(x, y) for x, y in
                    zip(tree_leaves(a.params), tree_leaves(b.params))))


def _refusal(fn, fragment) -> str:
    """Run ``fn``, which must raise ValueError naming ``fragment``."""
    try:
        fn()
    except ValueError as e:
        check(fragment in str(e), f"refused for another reason: {e}")
        return str(e)[:120]
    raise RuntimeError(f"chip_smoke check failed: no refusal ({fragment})")


def _api_checkpoints(spec, uninterrupted) -> dict:
    """Session checkpoints and resume() at the training phase's spec:
    the checkpointed run and a resume after round 2's file is deleted
    are bitwise the uninterrupted run; a truncated newest file is walked
    back past with a RuntimeWarning; a changed lr and a checkpoint
    beyond ``rounds`` are refused."""
    import os
    import tempfile
    import warnings
    import repro_torch.api.session as session
    from repro_torch.api import build
    save_ms = []
    save = session.save_checkpoint

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        out = save(*args, **kw)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    session.save_checkpoint = timed_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = spec.replace(checkpoint_dir=tmp, checkpoint_every=1)
            newest = os.path.join(tmp, f"session_{spec.rounds:08d}.npz")
            sess = build(ck)        # one federation for its three runs
            check(_same_run(sess.run(), uninterrupted),
                  "the checkpointed run is not the uninterrupted run")
            os.remove(newest)
            res = sess.resume()
            check(res.resumed_from == spec.rounds - 1,
                  f"resumed from {res.resumed_from}")
            check(_same_run(res, uninterrupted),
                  "resume() is not the uninterrupted run")
            with open(newest, "rb") as f:
                blob = f.read()
            with open(newest, "wb") as f:
                f.write(blob[:len(blob) // 2])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                walked = sess.resume()
            check(any(issubclass(w.category, RuntimeWarning)
                      and "corrupt" in str(w.message) for w in caught),
                  "a truncated checkpoint was not reported")
            check(walked.resumed_from == spec.rounds - 1
                  and _same_run(walked, uninterrupted),
                  "walking back past a truncated file changed the run")
            lr = _refusal(lambda: build(ck.replace(lr=2 * spec.lr)).resume(),
                          "resume_hash")
            beyond = _refusal(
                lambda: build(ck.replace(rounds=spec.rounds - 1)).resume(),
                "beyond spec.rounds")
    finally:
        session.save_checkpoint = save
    return {"saves": len(save_ms), "save_ms": save_ms,
            "save_ms_mean": sum(save_ms) / len(save_ms),
            "resumed_from": res.resumed_from, "resume_bitwise": True,
            "truncated_newest": f"RuntimeWarning, resumed from "
                                f"{walked.resumed_from}, bitwise",
            "lr_changed": lr, "beyond_rounds": beyond}


def _table2_row(spec) -> dict:
    """One Table II row at ``spec``: finite F1 and accuracy in [0, 1],
    and a rerun bitwise."""
    from repro_torch.api import build
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    vfl_matmul_clients.launches = 0
    rr = build(spec).run()
    launches = vfl_matmul_clients.launches
    m = rr.metrics
    check(all(math.isfinite(m[k]) and 0.0 <= m[k] <= 1.0
              for k in ("f1", "acc")), f"{spec.mode} metrics {m}")
    again = build(spec).run()
    check(_same_run(rr, again), f"{spec.mode}: the rerun is not bitwise")
    tel = rr.telemetry
    return {"mode": spec.mode, "spec_hash": rr.spec_hash,
            "first_layer": spec.first_layer, "f1": m["f1"],
            "acc": m["acc"], "steps": tel.steps, "wall_s": tel.wall_s,
            "steps_per_s": tel.steps_per_sec,
            "vfl_matmul_launches": launches, "rerun_bitwise": True}


def phase_api(train_out, pcfg) -> None:
    """The front door, ``repro_torch.api``, on the card: a Session at the
    training phase's config runs through vfl_matmul (the count set to 0
    just before, read just after) and is bitwise ``phase_train``'s
    ``DeVertiFL.train()``; checkpoints and resume(); the Table II bank
    row in devertifl and splitnn mode."""
    from repro_torch.api import RESULT_SCHEMA_VERSION, ExperimentSpec, build
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    spec = ExperimentSpec(dataset=pcfg.dataset, n_clients=pcfg.n_clients,
                          n_samples=pcfg.n_samples, rounds=pcfg.rounds,
                          epochs=pcfg.epochs, batch_size=pcfg.batch_size)
    check(spec.first_layer == "kernel",
          f"first_layer='auto' canonicalized to {spec.first_layer!r}")
    t_phase = t0 = time.perf_counter()
    sess = build(spec)
    fed = sess.federation
    setup_s = time.perf_counter() - t0
    vfl_matmul_clients.launches = 0
    rr = sess.run()
    launches = vfl_matmul_clients.launches
    steps = pcfg.rounds * pcfg.epochs * fed.n_batches
    expected = steps + pcfg.rounds + 1
    check(launches == expected,
          f"Session: vfl_matmul launched {launches} times, expected "
          f"{expected}")
    check(rr.telemetry.steps == steps, "Session telemetry steps")
    check(all(torch.equal(torch.as_tensor(h["round_losses"]),
                          torch.as_tensor(t["round_losses"]))
              for h, t in zip(rr.history, train_out["history"], strict=True)),
          "Session round losses are not DeVertiFL.train()'s, bitwise")
    check(rr.metrics == train_out["final"],
          f"Session metrics {rr.metrics} != train()'s {train_out['final']}")
    record = json.loads(json.dumps(rr.to_dict()))
    check(record["schema_version"] == RESULT_SCHEMA_VERSION == 5,
          "RunResult schema")
    ckpt = _api_checkpoints(spec, rr)
    # benchmarks/table2.py's bank_vs_splitnn row, cut from 20 rounds to 2
    bank = ExperimentSpec(dataset="bank", n_clients=2, rounds=2,
                          epochs=10)
    rows = [_table2_row(bank), _table2_row(bank.replace(mode="splitnn"))]
    check(rows[0]["vfl_matmul_launches"] == rows[0]["steps"] + 3,
          f"bank devertifl: {rows[0]['vfl_matmul_launches']} launches")
    check(rows[1]["vfl_matmul_launches"] == 0, "splitnn ran vfl_matmul")
    emit({"phase": "api", "spec_hash": rr.spec_hash,
          "first_layer": spec.first_layer, "setup_s": setup_s,
          "steps": steps, "wall_s": rr.telemetry.wall_s,
          "steps_per_s": rr.telemetry.steps_per_sec,
          "vfl_matmul_launches": launches,
          "bitwise_vs_train": True, "final_f1": rr.metrics["f1"],
          "schema_version": record["schema_version"],
          "checkpoint": ckpt, "table2_bank": rows,
          "reduced": "bank_vs_splitnn (benchmarks/table2.py): 2 of its "
                     "20 rounds",
          "phase_s": time.perf_counter() - t_phase})
    return sess, rr


# ---------------------------------------------------------------------------
# the obs layer at the api phase's configuration: taps bitwise obs-free,
# the series, an obs lane grid, spans, the profiler
OBS_GRID_LEVELS = ("none", "basic", "full")
OBS_GRID_SEEDS = (0, 1)
# the grid's lanes held to their standalone runs: (level, seed)
OBS_LANES = (("none", 0), ("basic", 0), ("full", 0), ("full", 1))
OBS_PROFILE_SAMPLES = 4000
OBS_TRACE_SAMPLES = 1000    # profile_to's round: a trace of 15 steps


def _check_series(name, ser, rounds, n) -> None:
    """tests/test_obs.py's shapes and positivity of a full series."""
    from repro_torch.obs import SERIES_KEYS
    check(set(ser) == set(SERIES_KEYS), f"{name}: series keys {sorted(ser)}")
    check(ser["loss"].shape == (rounds,)
          and ser["exchange_norm"].shape == (rounds, n)
          and ser["grad_norm"].shape == (rounds, n),
          f"{name}: series shapes {[v.shape for v in ser.values()]}")
    check(bool((ser["loss"] > 0).all()) and bool(np.isfinite(
        ser["loss"]).all()), f"{name}: loss series {ser['loss']}")
    check(bool((ser["exchange_norm"] > 0).any())
          and bool((ser["grad_norm"] > 0).any()),
          f"{name}: norm series all zero")


def _obs_profile(pcfg, obs) -> dict:
    """One round at fewer samples under torch.profiler: kernels a step
    and the busy share at ``obs``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.protocol import (DeVertiFL, round_generator,
                                           train_generators)
    fed = DeVertiFL(pcfg.replace(n_samples=OBS_PROFILE_SAMPLES, obs=obs,
                                 rounds=1), device=DEVICE)
    params, opt_state = fed.start(fed.init_params(
        train_generators(pcfg.seed)[0]))
    idx = fed.perms(round_generator(pcfg.seed, 0))
    fed.run_round(params, opt_state, 0, idx, fed.init_sched_state(),
                  fed.draws().round(0))
    _dev_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_round(params, opt_state, 0, idx, fed.init_sched_state(),
                      fed.draws().round(0))
        _dev_sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof, wall_ms, idx.shape[0])
    return {k: rows[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                 "device_busy_share", "kernels_per_step",
                                 "by_kind")}


def _profile_to_reading(pcfg) -> dict:
    """``SpanTracer.profile_to`` around one round at fewer samples: the
    torch.profiler trace it writes must name vfl_matmul's kernel, and the
    tracer holds its ``torch_profile`` span."""
    import os
    import tempfile
    from repro_torch.core.protocol import DeVertiFL, round_generator
    from repro_torch.obs import SpanTracer
    fed = DeVertiFL(pcfg.replace(n_samples=OBS_TRACE_SAMPLES, rounds=1,
                                 epochs=1), device=DEVICE)
    params, opt_state = fed.start(fed.init_params(torch.Generator()))
    tracer = SpanTracer()
    with tempfile.TemporaryDirectory() as tmp:
        with tracer.profile_to(tmp, device=DEVICE):
            fed.run_round(params, opt_state, 0,
                          fed.perms(round_generator(0, 0)))
            _dev_sync()
        path = os.path.join(tmp, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    hits = sorted(n for n in names if "vfl_matmul" in n)
    check(bool(hits), "profile_to: the trace names no vfl_matmul kernel")
    spans = [r["name"] for r in tracer.to_records()]
    check(spans == ["torch_profile"], f"profile_to spans {spans}")
    return {"trace_bytes": size, "events": len(events),
            "vfl_matmul_names": hits[:4]}


def _obs_grid(pcfg) -> dict:
    """One round of the obs x seed lane batch (one vfl_matmul launch a
    lane-batched step, counted), each of OBS_LANES bitwise its
    standalone DeVertiFL round, losses and series; the "none" lanes'
    series all zero."""
    from repro_torch.core import sweep as SW
    from repro_torch.core.protocol import (DeVertiFL, round_generator,
                                           train_generators)
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    scfg = SW.SweepConfig(client_counts=(pcfg.n_clients,),
                          seeds=OBS_GRID_SEEDS, rounds=1, epochs=1,
                          n_samples=pcfg.n_samples,
                          batch_size=pcfg.batch_size, obs=OBS_GRID_LEVELS)
    lb = SW.build_lane_batch(pcfg.dataset, "devertifl", scfg, device=DEVICE)
    idx, draws = lb.round_indices(0), lb.round_draws(0)
    vfl_matmul_clients.launches = 0
    _dev_sync()
    t0 = time.perf_counter()
    _, _, _, sched, losses = lb.round_fn(lb.params, lb.opt_state, 0, idx,
                                         lb.xtr, lb.ytr, lb.lay,
                                         lb.sched_state, draws)
    _dev_sync()
    wall = time.perf_counter() - t0
    launches = vfl_matmul_clients.launches
    check(launches == lb.n_batches,
          f"obs grid: {launches} vfl_matmul launches for {lb.n_batches} "
          "lane-batched steps")
    losses, series = losses.cpu(), lb.impl.obs_series(sched)
    out = {}
    for level, s in OBS_LANES:
        li = OBS_GRID_LEVELS.index(level) * len(OBS_GRID_SEEDS) + \
            OBS_GRID_SEEDS.index(s)
        fed = DeVertiFL(pcfg.replace(seed=s, rounds=1, epochs=1, obs=level),
                        device=DEVICE)
        params, opt_state = fed.start(fed.init_params(
            train_generators(s)[0]))
        _, _, _, st, solo = fed.run_round(
            params, opt_state, 0, fed.perms(round_generator(s, 0)),
            fed.init_sched_state(), fed.draws().round(0))
        check(torch.equal(losses[li], solo.cpu()),
              f"obs grid: lane {li} ({level}, seed {s}) is not its "
              "standalone run, bitwise")
        mine = {k: v[li] for k, v in series.items()}
        if level == "none":
            check(all(not v.any() for v in mine.values()),
                  "obs grid: a none lane recorded a series")
        else:
            theirs = fed.obs_series(st)
            differ = [k for k in theirs
                      if not np.array_equal(mine[k], theirs[k])]
            check(not differ, f"obs grid: lane {li} ({level}, seed {s})'s "
                  f"series {differ} are not its standalone run's, bitwise")
        out[f"{level}/{s}"] = "bitwise"
    return {"lanes": lb.n_lanes, "steps": lb.n_batches, "wall_s": wall,
            "lane_steps_per_s": lb.n_lanes * lb.n_batches / wall,
            "vfl_matmul_launches": launches, "vs_standalone": out}


def phase_obs(kernel_row, sess, rr) -> None:
    """The obs layer on the card at the api phase's configuration (mnist
    784 -> 3x10 -> 10, 5 clients, 70,000 samples, kernel lane): a
    2-round obs="full" Session bitwise the api phase's obs="none" run
    (params, metrics, round losses), launching vfl_matmul once a step
    and an evaluation, its series' shapes and positivity, its spans
    exported as JSON with one round span a round; obs="basic" leaves
    the per-client series at zero; under the adversity combination the
    staleness, bytes and quarantine series equal the inner layers' own
    telemetry; an obs x seed lane grid, lanes bitwise their standalone
    runs; ``profile_to``'s trace names vfl_matmul; kernels a step and
    steps/s with the taps beside without; a planted fault (a tap that
    writes into the released stack) must fail the bitwise check."""
    import tempfile
    import repro_torch.obs.taps as OT
    from repro_torch.api import build
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    t_phase = time.perf_counter()
    spec, pcfg = sess.spec, sess.federation.pcfg
    n, rounds = spec.n_clients, spec.rounds
    full_sess = build(spec.replace(obs="full"), device=DEVICE)
    full_sess.federation        # built outside the launch count
    vfl_matmul_clients.launches = 0
    full = full_sess.run()
    launches = vfl_matmul_clients.launches
    steps = full.telemetry.steps
    check(launches == steps + rounds + 1,
          f"obs full: {launches} vfl_matmul launches, expected "
          f"{steps + rounds + 1}")
    check(_same_run(full, rr), "obs='full' is not obs='none', bitwise")
    ser = full.telemetry.series
    _check_series("obs full", ser, rounds, n)
    check(not (ser["staleness"].any() or ser["encoded_bytes"].any()
               or ser["quarantined"].any()),
          "obs full: sync recorded staleness, bytes or quarantines")
    with tempfile.TemporaryDirectory() as tmp:
        with open(full_sess.tracer.export(f"{tmp}/trace.json")) as f:
            spans = [e["name"] for e in json.load(f)["traceEvents"]]
    check(spans.count("round") == rounds and "build" in spans
          and spans.count("eval") == rounds + 1,
          f"obs full: exported spans {spans}")

    basic = build(spec.replace(obs="basic", rounds=1), device=DEVICE).run()
    bser = basic.telemetry.series
    check(bool((bser["loss"] > 0).all())
          and not bser["exchange_norm"].any() and not bser["grad_norm"].any(),
          f"obs basic: per-client series {bser}")
    check(np.array_equal(bser["loss"], ser["loss"][:1]),
          "obs basic: round 1's loss is not obs full's")

    combo = build(spec.replace(obs="full", rounds=1, **ADV_COMBO),
                  device=DEVICE).run()
    cser = combo.telemetry.series
    _check_series("obs combination", cser, 1, n)
    depth = int(ADV_COMBO["schedule"].split(":")[1])
    check(bool((cser["staleness"] == depth).all()),
          f"obs combination: staleness {cser['staleness']}")
    check(bool((cser["encoded_bytes"] > 0).all())
          and int(cser["encoded_bytes"][-1]) ==
          combo.telemetry.wire["encoded_bytes"],
          f"obs combination: bytes {cser['encoded_bytes']} vs "
          f"{combo.telemetry.wire}")
    check(int(cser["quarantined"][-1]) == combo.telemetry.fault["quarantined"],
          f"obs combination: quarantines {cser['quarantined']} vs "
          f"{combo.telemetry.fault}")

    grid = _obs_grid(pcfg)
    prof = {obs: _obs_profile(pcfg, obs) for obs in ("none", "full")}
    profile_to = _profile_to_reading(pcfg)

    # the planted fault: a tap that writes into the released stack
    select = OT.ObsImpl.select

    def writing(self, state, h_now):
        h_ref, st = select(self, state, h_now)
        h_ref.mul_(1.0 + 2.0 ** -8)
        return h_ref, st
    OT.ObsImpl.select = writing
    try:
        planted = build(spec.replace(obs="full"), device=DEVICE).run()
    finally:
        OT.ObsImpl.select = select
    check(not _same_run(planted, rr),
          "obs: a tap writing into h_ref passed the bitwise check")
    kernel_row["obs"] = {"session_2_rounds": launches,
                         "grid_round": grid["vfl_matmul_launches"]}
    emit({"phase": "obs", "spec_hash": full.spec_hash,
          "steps": steps, "vfl_matmul_launches": launches,
          "steps_per_s": {"none": rr.telemetry.steps_per_sec,
                          "full": full.telemetry.steps_per_sec},
          "full_over_none": full.telemetry.steps_per_sec
          / rr.telemetry.steps_per_sec,
          "bitwise_vs_none": True, "series": {
              k: v.tolist() for k, v in ser.items()
              if k in ("loss", "quarantined", "encoded_bytes", "staleness")},
          "combination_series": {k: v.tolist() for k, v in cser.items()
                                 if k in ("quarantined", "encoded_bytes",
                                          "staleness")},
          "spans": {s: spans.count(s) for s in sorted(set(spans))},
          "span_summary": full_sess.tracer.summary().splitlines(),
          "grid": grid, "profile": prof,
          "kernels_per_step_full_over_none":
              prof["full"]["kernels_per_step"]
              / prof["none"]["kernels_per_step"],
          "profile_to": profile_to,
          "planted_writing_tap": "fails the bitwise check",
          "phase_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# federated serving on the api phase's trained federation
SERVE_REQUESTS = 4096
SERVE_HOT = 256             # hot entities, 25% of the requests
SERVE_HOT_SHARE = 0.25
SERVE_SLOTS = 64
SERVE_CACHE = 512
SERVE_QUEUE_CAP = 256
SERVE_WINDOW = 512          # requests announced before their slices arrive
SERVE_PROFILE_STEPS = 50
_PROM_SAMPLE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+="[^"]*"\})? \S+$'


def _serve_requests(n_test, n, seed=0):
    """(rows, entities) of ``n`` requests over the test set (numpy
    ``seed``): a SERVE_HOT_SHARE of them on SERVE_HOT hot entities, the
    rest on random rows (entity = row)."""
    rng = np.random.default_rng(seed)
    hot_rows = rng.choice(n_test, SERVE_HOT, replace=False)
    is_hot = rng.random(n) < SERVE_HOT_SHARE
    hot = rng.integers(0, SERVE_HOT, n)
    rows = np.where(is_hot, hot_rows[hot], rng.integers(0, n_test, n))
    entities = [f"hot{h}" if b else f"row{r}"
                for b, h, r in zip(is_hot, hot, rows)]
    return rows, entities


def _stream(srv, fed, rows, entities, seed) -> None:
    """Announce the requests a window at a time; deliver each window's
    client slices in one shuffled interleaving with a step() every
    SERVE_SLOTS requests' worth of slices; drain."""
    from repro_torch.api import ServeRequest, split_features
    rng = np.random.default_rng(seed)
    every = SERVE_SLOTS * fed.pcfg.n_clients
    offers = []
    for i, (r, e) in enumerate(zip(rows, entities)):
        srv.submit(ServeRequest(uid=i, entity_id=e))
        sl = split_features(fed.layout, fed.xte[r])
        offers += [(i, c, sl[c]) for c in sl]
        if (i + 1) % SERVE_WINDOW and i + 1 < len(rows):
            continue
        for j, k in enumerate(rng.permutation(len(offers))):
            srv.offer(*offers[k])
            if (j + 1) % every == 0:
                srv.step()
        offers = []
    srv.run()


def _serve_mismatches(report, want, rows) -> int:
    """Completed requests whose predictions differ from predict()'s
    column of their row (``want`` {row: [n_live] predictions})."""
    return sum(not np.array_equal(p, want[int(rows[uid])])
               for uid, p in report.results.items())


def _prom_ok(text, report) -> bool:
    """Every sample line is ``name{labels} value``, the latency buckets
    cumulative, +Inf == _count == completed."""
    import re
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    buckets = [int(ln.rsplit(" ", 1)[1]) for ln in samples
               if "_bucket{" in ln]
    count = [int(ln.rsplit(" ", 1)[1]) for ln in samples
             if ln.startswith("repro_serve_latency_seconds_count ")]
    return (all(re.match(_PROM_SAMPLE, ln) for ln in samples)
            and all(float(ln.rsplit(" ", 1)[1]) >= 0 for ln in samples)
            and buckets == sorted(buckets) and bool(buckets)
            and buckets[-1] == count[0] == report.counters["completed"])


def _wrong_entity_cache(capacity):
    """The planted fault: an ExchangeCache whose hits return the stack
    stored for the NEXT entity in its order."""
    from repro_torch.api import ExchangeCache

    class WrongEntityCache(ExchangeCache):
        def lookup(self, key):
            keys = list(self._store)
            if key in self._store and len(keys) > 1:
                self.hits += 1
                return self._store[keys[(keys.index(key) + 1) % len(keys)]]
            return super().lookup(key)
    return WrongEntityCache(capacity)


def _predict_stages(sess, rows_canonical) -> dict:
    """The predict path's stages (first layer, each hidden layer, head,
    exchange, argmax) of the Session's params on canonical-order rows."""
    from repro_torch.core import protocol as P
    from repro_torch.core.exchange import hidden_output_exchange
    fed, params = sess.federation, sess._last_params
    model, lay = fed.model, fed._lay
    first = P.make_first_layer_fn(model, fed.pcfg, fed.layout, fed.device)
    out = {}
    with torch.no_grad():
        h = out["first_layer"] = first(params, rows_canonical, lay)
        for i in range(1, model.n_hidden):
            h = out[f"hidden_{i}"] = model.forward_from(
                h, start=i, upto=i + 1, params=params)
        h = out["head"] = model.head(h, params=params)
        h = out["exchange"] = hidden_output_exchange(
            h, differentiable=False, client_mask=lay.client_mask)
        out["argmax"] = torch.argmax(h, dim=-1)
    return out


def _stage_reading(sess, n_rows) -> dict:
    """Elements of each predict stage that differ between the whole test
    set at once (vfl_matmul's ``ring`` kernel, cuBLAS at M = 14,000) and
    SERVE_SLOTS-row chunks of its first ``n_rows`` (the ``wave`` kernel
    at a serve step's M)."""
    x = sess.federation._xte
    whole = _predict_stages(sess, x)
    chunks = [_predict_stages(sess, x[i:i + SERVE_SLOTS])
              for i in range(0, n_rows, SERVE_SLOTS)]
    return {k: int((torch.cat([c[k] for c in chunks], dim=1)
                    != whole[k][:, :n_rows]).sum()) for k in whole}


def _serve_profile(sess, fed, rows, entities) -> dict:
    """SERVE_PROFILE_STEPS full-pool steps under torch.profiler, after
    warm ones: host and device ms a step, the busy share, kernels a
    step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import ServeRequest, split_features
    srv = sess.server(max_slots=SERVE_SLOTS, cache=SERVE_CACHE)
    n = SERVE_SLOTS * (SERVE_PROFILE_STEPS + 4)
    for i in range(n):
        r = rows[i % len(rows)]
        srv.submit(ServeRequest(uid=i, entity_id=f"p{i}",
                                slices=split_features(fed.layout,
                                                      fed.xte[r])))
    for _ in range(4):
        srv.step()
    _dev_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE_STEPS):
            srv.step()
        _dev_sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows_ = _profile_rows(prof, wall_ms, SERVE_PROFILE_STEPS)
    return {k: rows_[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                  "device_busy_share", "kernels_per_step",
                                  "by_kind", "top_device_kernels")}


def phase_serve_fed(kernel_row, sess) -> None:
    """Federated serving on the card over the api phase's trained
    federation (mnist, 5 clients, kernel lane): the predict path's
    stages at a serve step's M (64-row chunks) bitwise the whole test
    set's; SERVE_REQUESTS requests
    from the test rows (numpy seed 0), a quarter on SERVE_HOT hot
    entities, each client's slice offered in shuffled order interleaved
    with step() through ``Session.server(max_slots=64, cache=512,
    queue_cap=256, overflow="evict_oldest")``, vfl_matmul launched once
    a step (the count set to 0 just before, read just after); every
    completed result equal to ``Session.predict`` on its row, exactly;
    the same requests at 8 and 1,024 slots the same; cache hits equal
    recomputes; every pressure entry at the cap; a topk+int8 Session's
    cache holds packed payloads whose hits are bitwise its fresh serves;
    ``prometheus_text`` parses; a planted fault (a cache returning
    another entity's stack) must fail the equality check; requests/s,
    latency, host and device ms a step."""
    from repro_torch.api import (ServeRequest, build, split_features)
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    from repro_torch.obs import prometheus_text
    from repro_torch.wire import WirePayload
    t_phase = time.perf_counter()
    fed = sess.federation
    check(fed.pcfg.exchange_at == -1, "serve_fed: the stage check reads "
          "the logits exchange")
    stages = _stage_reading(sess, SERVE_REQUESTS // 4)
    check(not any(stages.values()),
          f"serve_fed: the predict path's stages differ between 64-row "
          f"chunks and the whole test set: {stages}")
    rows, entities = _serve_requests(len(fed.xte), SERVE_REQUESTS)
    used = np.unique(rows)
    _dev_sync()
    t0 = time.perf_counter()
    pred = sess.predict(fed.xte[used]).cpu().numpy()
    predict_ms = (time.perf_counter() - t0) * 1e3
    want = {int(r): pred[:, j] for j, r in enumerate(used)}

    srv = sess.server(max_slots=SERVE_SLOTS, cache=SERVE_CACHE,
                      queue_cap=SERVE_QUEUE_CAP, overflow="evict_oldest")
    vfl_matmul_clients.launches = 0
    _stream(srv, fed, rows, entities, seed=1)
    _dev_sync()
    launches = vfl_matmul_clients.launches
    report = srv.report()
    c = report.counters
    check(launches == c["steps"] > 0,
          f"serve_fed: {launches} vfl_matmul launches for {c['steps']} steps")
    check(c["completed"] + c["evicted"] == SERVE_REQUESTS
          and c["rejected"] == c["waiting"] == 0,
          f"serve_fed: counters {c}")
    check(bool(srv.pressure_log) and all(
        p == SERVE_QUEUE_CAP for p in srv.pressure_log),
        f"serve_fed: pressure log {sorted(set(srv.pressure_log))}")
    bad = _serve_mismatches(report, want, rows)
    first_bad = next(((uid, int(rows[uid]), p.tolist(),
                       want[int(rows[uid])].tolist())
                      for uid, p in report.results.items()
                      if not np.array_equal(p, want[int(rows[uid])])), None)
    check(bad == 0, f"serve_fed: {bad} of {c['completed']} served results "
          f"differ from predict() (uid, row, served, predicted: "
          f"{first_bad})")
    cached = {t["uid"] for t in report.telemetry if t["cached"]}
    check(report.cache["hits"] > 0 and len(cached) > 0,
          f"serve_fed: cache {report.cache}")
    fresh = {}
    for uid, p in report.results.items():
        if uid not in cached:
            fresh.setdefault(entities[uid], p)
    check(all(np.array_equal(report.results[u], fresh[entities[u]])
              for u in cached if entities[u] in fresh),
          "serve_fed: a cache hit differs from its entity's recompute")
    text = prometheus_text(report)
    check(_prom_ok(text, report), "serve_fed: prometheus_text does not parse")

    reqs = [ServeRequest(uid=i, entity_id=e, slices=split_features(
        fed.layout, fed.xte[r])) for i, (r, e) in enumerate(zip(rows,
                                                                entities))]
    by_slots = {}
    for slots in (8, 1024):
        rep = sess.serve(reqs, max_slots=slots, cache=SERVE_CACHE)
        check(rep.counters["completed"] == SERVE_REQUESTS
              and _serve_mismatches(rep, want, rows) == 0
              and all(np.array_equal(rep.results[u], p)
                      for u, p in report.results.items()),
              f"serve_fed: {slots} slots do not give the 64-slot results")
        by_slots[slots] = {"steps": rep.counters["steps"],
                           "requests_per_s": rep.throughput_rps,
                           "latency_ms": rep.latency_ms}

    wrong = sess.server(max_slots=SERVE_SLOTS,
                        cache=_wrong_entity_cache(SERVE_CACHE),
                        queue_cap=SERVE_QUEUE_CAP, overflow="evict_oldest")
    _stream(wrong, fed, rows[:2 * SERVE_WINDOW],
            entities[:2 * SERVE_WINDOW], seed=1)
    check(wrong.cache.hits > 0 and _serve_mismatches(
        wrong.report(), want, rows) > 0,
        "serve_fed: a cache serving another entity's stack passed the "
        "equality check")

    # a topk+int8 federation: packed payloads in the cache
    wire = build(sess.spec.replace(transform="topk:0.5+int8", rounds=1),
                 device=DEVICE)
    wire.run()
    hot = [i for i, e in enumerate(entities) if e.startswith("hot")]
    first = {}
    for i in hot:
        first.setdefault(entities[i], rows[i])
    wsrv = wire.server(max_slots=SERVE_SLOTS, cache=SERVE_CACHE)
    for k, (e, r) in enumerate(first.items()):
        wsrv.submit(ServeRequest(uid=f"f{k}", entity_id=e, slices=(
            split_features(wire.federation.layout, fed.xte[r]))))
    wfresh = wsrv.run()
    packed = all(isinstance(v, WirePayload)
                 for v in wsrv.cache._store.values())
    for k, e in enumerate(first):
        wsrv.submit(ServeRequest(uid=f"h{k}", entity_id=e))
    whits = wsrv.run()
    check(packed and whits.cache["hits"] == len(first) and all(
        np.array_equal(whits.results[f"h{k}"], wfresh.results[f"f{k}"])
        for k in range(len(first))),
        "serve_fed: topk+int8 cache hits are not their fresh serves, "
        "bitwise, or the cache holds unpacked stacks")
    nbytes = [v.nbytes for v in wsrv.cache._store.values()]

    prof = _serve_profile(sess, fed, rows, entities)
    kernel_row["serve_fed"] = launches
    emit({"phase": "serve_fed", "requests": SERVE_REQUESTS,
          "hot_entities": SERVE_HOT, "max_slots": SERVE_SLOTS,
          "cache": report.cache, "queue_cap": SERVE_QUEUE_CAP,
          "counters": c, "pressure_events": len(srv.pressure_log),
          "requests_per_s": report.throughput_rps,
          "latency_ms": report.latency_ms, "steps": c["steps"],
          "vfl_matmul_launches": launches, "served_vs_predict": "equal",
          "cache_hits_vs_recompute": "equal", "predict_ms": predict_ms,
          "stage_diffs_64_rows_vs_whole": stages,
          "by_slots": by_slots, "step_profile": prof,
          "wire": {"transform": "topk:0.5+int8", "entities": len(first),
                   "packed": packed, "hits_bitwise_fresh": True,
                   "payload_bytes_mean": float(np.mean(nbytes))},
          "prometheus_lines": len(text.splitlines()),
          "planted_wrong_entity_cache": "fails the equality check",
          "phase_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# the sweep: Fig. 3's paper grid as lanes of one batched round
SWEEP_COUNTS = tuple(range(2, 11))      # benchmarks/figures.py --paper
SWEEP_SEEDS = (0, 1, 2)
SWEEP_SAMPLES, SWEEP_ROUNDS = 70000, 2   # cut from 15 x 5 epochs
SWEEP_LANES = ((2, 0), (5, 1), (10, 2))  # held to standalone runs
SWEEP_PROFILE_STEPS = 20
# kernels a step at 27 lanes against one lane of the same config: the
# per-client layers run once for all lanes, so the count must not grow
# with L (a per-lane loop would multiply it)
KERNELS_PER_STEP_RTOL = 0.05
# the grid's cell 5 against a multi-seed Session of the same cell, which
# runs its seeds as 3 unpadded lanes: F1 within the CPU tests' limit
SWEEP_CELL, SWEEP_F1_TOL = 5, 0.002


def _kernel_counts(prof) -> dict:
    """Launches of each device kernel in a torch.profiler run."""
    counts = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type.name == "CUDA":
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return counts


def _backward_ops(prof, steps) -> dict:
    """Device ms a step of vfl_matmul's backward (``_VflMatmul``'s
    node, inclusive) and of each op it calls, by name: the xw gather is
    ``aten::index``, its product ``aten::bmm``."""
    def ms(ev):
        return getattr(ev, "device_time_total",
                       getattr(ev, "cuda_time_total", 0)) / 1e3 / steps
    total, ops = 0.0, {}
    for ev in prof.events():
        if ev.name == "_VflMatmulBackward":
            total += ms(ev)
            for child in ev.cpu_children:
                ops[child.name] = ops.get(child.name, 0.0) + ms(child)
    return {"ms_per_step": total,
            "ops_ms_per_step": dict(sorted(
                ((k, v) for k, v in ops.items() if v > 0),
                key=lambda kv: -kv[1]))}


def _lane_step_profile(lb):
    """A short round of ``lb`` (SWEEP_PROFILE_STEPS steps and its
    FedAvg) under torch.profiler, after a warm one."""
    from torch.profiler import ProfilerActivity, profile
    params, opt_state = lb.fresh_state()
    idx = lb.round_indices(0)[:, :SWEEP_PROFILE_STEPS]
    lb.round_fn(params, opt_state, 0, idx, lb.xtr, lb.ytr, lb.lay)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lb.round_fn(params, opt_state, 0, idx, lb.xtr, lb.ytr, lb.lay)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof, wall_ms, SWEEP_PROFILE_STEPS)
    rows["vfl_matmul_backward"] = _backward_ops(prof, SWEEP_PROFILE_STEPS)
    return rows, _kernel_counts(prof)


def _stacked_launch(lb, xb, calls) -> dict:
    """One stacked first-layer launch of the lane batch on xb [M, L, F]
    (L*max_c clients, Kx = L*F, x_off = l*F + off != w_off = off): the
    whole output held against the plain version; the three SWEEP_LANES'
    slices are each a launch of that lane alone, bitwise; a planted
    fault (x_offsets without the lane's l*F: every lane reads lane 0's
    columns) must fail that; times beside the plain version, the bound
    and one library call (``calls`` a CUDA graph)."""
    from repro_torch.core.sweep import lane_arrays
    from repro_torch.kernels.vfl_matmul import (ops, vfl_matmul_clients,
                                                vfl_matmul_clients_ref)
    flat = lane_arrays(lb.lay)
    n_lanes, c, n_features = lb.lay.masks.shape
    m = xb.shape[0]
    x = xb.reshape(m, n_lanes * n_features)
    w = lb.params["layer_0"]["kernel"].detach()
    n_out = w.shape[-1]
    args = (x, w, flat.x_offsets, flat.offsets, flat.sizes)
    with torch.no_grad():
        launches = vfl_matmul_clients.launches
        y = vfl_matmul_clients(*args)
        planted = vfl_matmul_clients(x, w, flat.offsets, flat.offsets,
                                     flat.sizes)
        bitwise = {}
        for nc, s in SWEEP_LANES:
            li = lb.lanes.index((nc, s))
            one = slice(li * c, (li + 1) * c)
            off = lb.lay.offsets[li].contiguous()
            alone = vfl_matmul_clients(xb[:, li].contiguous(),
                                       w[one].contiguous(), off, off,
                                       lb.lay.sizes[li].contiguous())
            bitwise[f"{nc}/{s}"] = bool(torch.equal(y[one], alone))
            check(bitwise[f"{nc}/{s}"],
                  f"sweep: lane ({nc}, {s})'s slice of the stacked launch "
                  f"at M = {m} is not its launch alone")
            if li:
                check(not torch.equal(planted[one], alone),
                      f"sweep: the planted lane-offset fault passed at "
                      f"lane ({nc}, {s}), M = {m}")
        del planted
        sizes = [int(v) for v in flat.sizes.tolist()]
        offs = [int(v) for v in flat.offsets.tolist()]
        xoffs = [int(v) for v in flat.x_offsets.tolist()]
        max_abs_err = assert_close(
            f"stacked lanes vs plain at M = {m}", y,
            vfl_matmul_clients_ref(x, w, xoffs, offs, sizes))
        # the library yardstick: one bmm of each lane's x against its
        # clients' W zeroed outside their slices, side by side on N
        x_lanes = xb.transpose(0, 1).contiguous()          # [L, M, F]
        w_lanes = (w * flat.masks[:, :, None]).reshape(
            n_lanes, c, n_features, n_out).transpose(1, 2).reshape(
            n_lanes, n_features, c * n_out).contiguous()   # [L, F, c*N]
        lib = torch.bmm(x_lanes, w_lanes).reshape(
            n_lanes, m, c, n_out).transpose(1, 2).reshape_as(y)
        assert_close(f"stacked library yardstick at M = {m}", lib, y)
        del lib, y
        times = {"ms": device_ms(lambda: vfl_matmul_clients(*args),
                                 calls=calls),
                 "plain_ms": device_ms(lambda: vfl_matmul_clients_ref(
                     x, w, xoffs, offs, sizes), calls=5, replays=2),
                 "library_ms": device_ms(
                     lambda: torch.bmm(x_lanes, w_lanes), calls=calls)}
        vfl_matmul_clients.launches = launches
    nbytes, flops = W.vfl_matmul_work(m, sum(sizes), n_out, len(sizes))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    p = ops.plan(m, x.shape[1], w.shape[1], n_out, len(sizes))
    return {"M": m, "clients": len(sizes), "Kx": x.shape[1],
            "Kw": w.shape[1], "N": n_out, **times,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "max_abs_err": max_abs_err,
            "plan": {"kernel": p.kernel, "grid": list(p.grid),
                     "threads": p.threads, "smem_bytes": p.smem},
            "lanes_bitwise_alone": bitwise,
            "planted_lane_offset_fault": "fails"}


def _lanes_vs_standalone(losses, lanes) -> dict:
    """Round 1 of SWEEP_LANES from the lane batch against
    ``DeVertiFL.run_round`` of each lane's standalone federation from
    the same draws."""
    from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig,
                                           round_generator,
                                           train_generators)
    out = {}
    for nc, s in SWEEP_LANES:
        fed = DeVertiFL(ProtocolConfig(dataset="mnist", n_clients=nc,
                                       n_samples=SWEEP_SAMPLES, seed=s,
                                       rounds=SWEEP_ROUNDS, epochs=1),
                        device="cuda")
        params = fed.init_params(train_generators(s)[0])
        _, _, _, solo = fed.run_round(params, fed.opt.init(params), 0,
                                      fed.perms(round_generator(s, 0)))
        lane = losses[lanes.index((nc, s))]
        solo = solo.cpu()
        rel = float(((lane - solo).abs() / solo.abs()).max())
        check(torch.allclose(lane, solo, rtol=LANE_RTOL, atol=0.0),
              f"sweep: lane ({nc}, {s}) round-1 losses vs its standalone "
              f"run: max rel diff {rel} > rtol {LANE_RTOL}")
        out[f"{nc}/{s}"] = {"max_rel": rel,
                            "bitwise": bool(torch.equal(lane, solo))}
    return out


def phase_sweep(kernel_row, train_steps_per_s) -> None:
    """Fig. 3's paper grid (benchmarks/figures.py --paper: clients 2..10
    x seeds 0, 1, 2) at the full mnist set through
    ``repro_torch.api.run_grid``: 27 lanes of one round, one
    ``vfl_matmul`` launch a step (the count set to 0 just before, read
    just after); the grid rerun bitwise; lanes against standalone runs;
    the stacked launch against the plain version and each lane alone,
    at the step's shape and the evaluation's; kernels a step at 27
    lanes against one; the grid's cell 5 against a multi-seed Session."""
    from repro_torch.api import ExperimentSpec, build, run_grid, spec_grid
    from repro_torch.api.session import sweep_config_for_specs
    from repro_torch.core import sweep as SW
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    t_phase = time.perf_counter()
    specs = spec_grid(datasets=("mnist",), modes=("devertifl",),
                      client_counts=SWEEP_COUNTS, seeds=SWEEP_SEEDS,
                      rounds=SWEEP_ROUNDS, epochs=1,
                      n_samples=SWEEP_SAMPLES)
    check(all(s.first_layer == "kernel" for s in specs),
          "sweep specs' first_layer is not 'kernel'")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vfl_matmul_clients.launches = 0
    t0 = time.perf_counter()
    grid = run_grid(specs)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    launches = vfl_matmul_clients.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cells = [grid["cells"][f"mnist/devertifl/{nc}"] for nc in SWEEP_COUNTS]
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for cell in cells
              for v in cell["f1_per_seed"] + cell["acc_per_seed"])
          and all(math.isfinite(cell["final_loss_mean"]) for cell in cells),
          "sweep: a cell's metrics are not finite in [0, 1]")
    wall = cells[0]["wall_s"]
    lane_steps_per_s = sum(cell["steps_per_sec"] for cell in cells)

    # the same lane batch again: the grid rerun bitwise, round 1 once
    # more from fresh draws, the lanes against standalone runs
    ds, mode, scfg = sweep_config_for_specs(specs)
    lb = SW.build_lane_batch(ds, mode, scfg)
    n_lanes, c = lb.lay.client_mask.shape
    expected = SWEEP_ROUNDS * lb.n_batches + 1
    check(launches == expected,
          f"sweep: vfl_matmul launched {launches} times, expected "
          f"{expected} (one a lane-batched step, one evaluation)")
    params, opt_state, step = lb.params, lb.opt_state, 0
    round_losses = []
    for r in range(SWEEP_ROUNDS):
        params, opt_state, step, losses = lb.round_fn(
            params, opt_state, step, lb.round_indices(r), lb.xtr, lb.ytr,
            lb.lay)
        round_losses.append(losses.cpu())
    preds = lb.predict_fn(params, lb.xte, lb.lay).cpu().numpy()
    f1s, _ = SW._lane_metrics(preds, lb.yte.cpu().numpy(),
                              lb.ytr.cpu().numpy(), lb.lanes)
    s = len(SWEEP_SEEDS)
    check(f1s == [f for cell in cells for f in cell["f1_per_seed"]]
          and all(float(round_losses[-1][ci * s:(ci + 1) * s, -1].numpy()
                        .mean()) == cell["final_loss_mean"]
                  for ci, cell in enumerate(cells)),
          "sweep: the grid rerun is not bitwise")
    fresh = lb.fresh_state()
    _, _, _, again = lb.round_fn(*fresh, 0, lb.round_indices(0), lb.xtr,
                                 lb.ytr, lb.lay)
    check(torch.equal(again.cpu(), round_losses[0]),
          "sweep: round 1 rerun from fresh draws is not bitwise")
    vs_standalone = _lanes_vs_standalone(round_losses[0], lb.lanes)
    # the stacked launch at the step's shape (M = 64, the wave kernel)
    # and at the evaluation's (the test set, the ring kernel)
    lanes = torch.arange(n_lanes, device="cuda")[None, :]
    stacked = _stacked_launch(
        lb, lb.xtr[lanes, lb.round_indices(0)[:, 0].t()], calls=100)
    stacked_eval = _stacked_launch(lb, lb.xte.transpose(0, 1), calls=10)
    check(stacked["plan"]["kernel"] == "wave"
          and stacked_eval["plan"]["kernel"] == "ring",
          f"sweep: the stacked launches ran {stacked['plan']['kernel']} "
          f"and {stacked_eval['plan']['kernel']}, not wave and ring")

    # kernels a step at 27 lanes against one lane of the same config
    profile_27, counts_27 = _lane_step_profile(lb)
    lb_batches = lb.n_batches
    del lb, params, opt_state, fresh
    _release()
    one = SW.build_lane_batch(ds, mode, dataclasses.replace(
        scfg, client_counts=(max(SWEEP_COUNTS),), seeds=(0,)))
    profile_1, counts_1 = _lane_step_profile(one)
    del one
    _release()
    k27, k1 = profile_27["kernels_per_step"], profile_1["kernels_per_step"]
    differ = {k[:80]: [counts_1.get(k, 0), counts_27.get(k, 0)]
              for k in sorted(set(counts_1) | set(counts_27))
              if counts_1.get(k, 0) != counts_27.get(k, 0)}
    check(abs(k27 - k1) <= KERNELS_PER_STEP_RTOL * k1,
          f"sweep: {k27} kernels a step at {n_lanes} lanes against {k1} "
          f"at one (differing: {differ})")

    # two paths to cell 5: the grid's padded lanes, and a multi-seed
    # Session (run_cell: 3 unpadded lanes)
    sess = build(ExperimentSpec(dataset="mnist", n_clients=SWEEP_CELL,
                                seeds=SWEEP_SEEDS, rounds=SWEEP_ROUNDS,
                                epochs=1, n_samples=SWEEP_SAMPLES)).run()
    cell5 = grid["cells"][f"mnist/devertifl/{SWEEP_CELL}"]
    f1_diff = abs(sess.metrics["f1"] - cell5["f1_mean"])
    loss_rel = abs(sess.metrics["final_loss_mean"]
                   - cell5["final_loss_mean"]) / abs(cell5["final_loss_mean"])
    check(f1_diff <= SWEEP_F1_TOL and loss_rel <= LANE_RTOL,
          f"sweep: the Session's cell {SWEEP_CELL} (F1 "
          f"{sess.metrics['f1']}, loss {sess.metrics['final_loss_mean']}) "
          f"against the grid's "
          f"({cell5['f1_mean']}, {cell5['final_loss_mean']})")

    row_keys = ("M", "clients", "Kx", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err")
    kernel_row["sweep"] = {k: stacked[k] for k in row_keys}
    kernel_row["sweep"]["launches"] = launches
    kernel_row["sweep_eval"] = {k: stacked_eval[k] for k in row_keys}
    emit({"phase": "sweep", "grid": "fig3 --paper: mnist, clients 2..10 "
          "x seeds 0, 1, 2, n_samples 70000",
          "reduced": "2 rounds of 1 epoch (figures.py: 15 x 5 at 6,000 "
                     "samples)",
          "lanes": n_lanes, "client_axis": n_lanes * c,
          "steps": SWEEP_ROUNDS * lb_batches, "grid_s": grid_s,
          "wall_s": wall,
          "lane_steps_per_s": lane_steps_per_s,
          "cells_per_sec": len(cells) / wall,
          "train_phase_steps_per_s": train_steps_per_s,
          "vfl_matmul_launches": launches, "peak_gb": peak_gb,
          "f1": {cell["n_clients"]: cell["f1_mean"] for cell in cells},
          "f1_per_seed": {cell["n_clients"]: cell["f1_per_seed"]
                          for cell in cells},
          "rerun_bitwise": True, "lanes_vs_standalone": vs_standalone,
          "lane_rtol": LANE_RTOL, "stacked_launch": stacked,
          "stacked_launch_eval": stacked_eval,
          "kernels_per_step": {"lanes_27": k27, "lanes_1": k1,
                               "differ": differ},
          "profile_27_lanes": profile_27, "profile_1_lane": profile_1,
          "session_cell5": {"f1": sess.metrics["f1"],
                            "grid_f1": cell5["f1_mean"], "f1_diff": f1_diff,
                            "final_loss_rel": loss_rel,
                            "steps_per_s": sess.telemetry.steps_per_sec},
          "phase_s": time.perf_counter() - t_phase})


def _profiled_round(pcfg) -> dict:
    """One round of ``pcfg``'s federation under torch.profiler after a
    warm round inside the profiler's warm-up cycle (a window opened
    cold can miss its first kernels): ``_profile_rows`` and the round's
    vfl_matmul launches (the count set to 0 just before, read just
    after)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.core.protocol import (DeVertiFL, round_generator,
                                           train_generators)
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    fed = DeVertiFL(pcfg, device="cuda")
    init_gen, _ = train_generators(pcfg.seed)
    params = fed.init_params(init_gen)
    opt_state = fed.opt.init(params)
    idx = fed.perms(round_generator(pcfg.seed, 0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fed.run_round(params, opt_state, 0, idx)    # warm
        torch.cuda.synchronize()
        prof.step()
        vfl_matmul_clients.launches = 0
        t0 = time.perf_counter()
        fed.run_round(params, opt_state, 0, idx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = vfl_matmul_clients.launches
    steps = pcfg.epochs * fed.n_batches
    return {"steps": steps, "vfl_matmul_launches": launches,
            **_profile_rows(prof, wall_ms, steps),
            "kernel_names": _kernel_names(prof)}


def _kernel_names(prof) -> dict:
    """Device kernels by name: launches in the profiled window."""
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type.name == "CUDA"
            and not ev.key.startswith(_STEP_MARK)
            and getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0)) > 0}


def phase_profile(pcfg) -> dict:
    """Where a training step's time goes: one round of the same
    federation at fewer samples under torch.profiler -- device time by
    kernel, and the device's busy share of the round's wall time."""
    row = _profiled_round(pcfg)
    emit({"phase": "profile", "n_samples": pcfg.n_samples,
          **{k: v for k, v in row.items() if k != "kernel_names"}})
    return row


# ---------------------------------------------------------------------------
# the static auditor on the card
# ---------------------------------------------------------------------------
AUDIT_CLIENTS = 3
# vfl_matmul launches a trace makes: the round runs twice (make_fx, then
# the functionalized replay), and at the audit size a round is one batch,
# so one launch a run.  A combo traces its round and its padded twin (the
# deadness pass's), a lane case its two lane batches.
AUDIT_LAUNCHES_A_TRACE = 2
# the custom-op route against the raw launch on a production round: the
# rounds of each, alternating, at the adversity combination's depth
ROUTE_SAMPLES = 14000
ROUTE_ROUNDS = 5


def _audit_pcfg(**kw):
    from repro_torch.core.protocol import ProtocolConfig
    return ProtocolConfig(**{"dataset": "mnist", "n_clients": AUDIT_CLIENTS,
                             "first_layer": "kernel", **kw})


def _leaky_kernel_layer(model, pcfg, layout):
    """The kernel lane's first layer plus the whole raw batch's mean in
    every client's output: a leak outside the declared channels."""
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients

    def first(params, xb, lay):
        w, b = params["layer_0"]["kernel"], params["layer_0"]["bias"]
        y = vfl_matmul_clients(xb, w, lay.offsets, lay.offsets, lay.sizes)
        return torch.relu(y + b.unsqueeze(1)) + xb.mean()
    return first


def _unmasked_fedavg(stacked, client_mask=None):
    """FedAvg whose term leaves the client mask out: a dead slot's
    parameters enter the sum."""
    from repro_torch.analysis import tag
    from repro_torch.tree import tree_map

    def avg(leaf):
        term = tag(leaf, "term", "fedavg", client_axis=0)
        m = tag(term.sum(0, keepdim=True) / client_mask.sum(), "declass",
                "fedavg")
        return m.expand_as(leaf)
    return tree_map(avg, stacked)


class _DriftImpl:
    """A depth-0 schedule whose carried leaf comes back as float64."""

    def __init__(self, n_clients):
        self.n = n_clients

    def init_state(self, sched):
        return {"acc": torch.zeros(self.n, device=DEVICE)}

    def round_start(self, state, lay, draws, round_idx):
        return state, lay.client_mask

    def select(self, state, h_now):
        return h_now, state

    def round_end(self, state):
        return {"acc": (state["acc"] + 1.0).double()}


def _branching_lane_layer(lb):
    """The lane batch's kernel first layer plus an op where the lane
    holds more than two clients, read on the host."""
    from repro_torch.core.sweep import kernel_first_layer

    def first(params, xb, lay):
        h = kernel_first_layer(params, xb, lay)
        if int((lay.sizes > 0).sum()) > 2:
            h = h * 1.0
        return h
    return first


def _planted_audits() -> dict:
    """The five planted faults, each audited on the card; returns each
    fault's codes (unwaived errors) and, for the leak, its chain."""
    import repro_torch.core.protocol as P
    from repro_torch.analysis import retrace as RT
    from repro_torch.analysis.audit import audit
    from repro_torch.kernels.vfl_matmul import ops as vfl_ops
    from repro_torch.schedule import register_schedule

    def codes(rep):
        return sorted({f.code for f in rep.violations})
    out = {}
    if "leaky_audit" not in P.FIRST_LAYERS.names():
        P.register_first_layer("leaky_audit", _leaky_kernel_layer)
    rep = audit(_audit_pcfg(first_layer="leaky_audit"), passes=("taint",),
                device=DEVICE)
    chain = "\n".join(c for f in rep.violations for c in f.chain)
    out["leaky_first_layer"] = {"codes": codes(rep),
                                "chain_names_this_file":
                                    "chip_smoke.py" in chain}
    route = vfl_ops.auditing
    vfl_ops.auditing = lambda: False
    try:
        rep = audit(_audit_pcfg(), passes=("taint",), device=DEVICE)
    finally:
        vfl_ops.auditing = route
    out["custom_op_route_off"] = {"codes": codes(rep)}
    fedavg = P.fedavg
    P.fedavg = _unmasked_fedavg
    try:
        rep = audit(_audit_pcfg(n_clients=2, max_clients=3),
                    passes=("deadness",), device=DEVICE)
    finally:
        P.fedavg = fedavg
    out["unmasked_fedavg_term"] = {"codes": codes(rep)}
    register_schedule("drift_audit", lambda n_clients, batch_size, width,
                      args: _DriftImpl(n_clients), overwrite=True)
    rep = audit(_audit_pcfg(schedule="drift_audit"), passes=("retrace",),
                lane_check=False, device=DEVICE)
    out["float64_carry"] = {"codes": codes(rep)}
    found = RT.run_lane_check("mnist", DEVICE, cases=RT.LANE_CASES[:1],
                              first_layer_fn=_branching_lane_layer)
    out["lane_branch"] = {"codes": sorted({f.code for f in found})}
    return out


PLANTED_CODES = {"leaky_first_layer": "cross-client-flow",
                 "custom_op_route_off": "opaque-write",
                 "unmasked_fedavg_term": "unproven-dead-slot",
                 "float64_carry": "carry-aval-drift",
                 "lane_branch": "lane-retrace-divergence"}


def _traced_is_untraced(lane) -> bool:
    """A traced (audited) round from a fresh state is bitwise the same
    round untraced from a copy of that state: the first stage's run, and
    the graph the passes read (the second stage's) run anew."""
    from repro_torch.analysis.audit import _TRACE_KW, TracedRound
    from repro_torch.tree import tree_leaves, tree_map
    tr = TracedRound(_audit_pcfg(first_layer=lane).replace(**_TRACE_KW),
                     DEVICE)
    params, opt_state, _, _ = tr.args
    p, o, _, losses = tr.fed.run_round(tree_map(torch.clone, params),
                                       tree_map(torch.clone, opt_state), 0,
                                       tr.idx)
    want = tree_leaves(p) + tree_leaves(o) + [losses]
    return all(len(got) == len(want)
               and all(torch.equal(a, b) for a, b in zip(got, want))
               for got in (tr.graph.outputs, tr.graph.run(tr.args)))


def _step_reading(row) -> dict:
    return {k: row[k] for k in ("kernels_per_step", "vfl_matmul_launches")}


def _kernels_only(names) -> dict:
    """A profiled round's kernels: its device events less the copies and
    sets (the round's pageable host-to-device copy of its batch indices
    is not recorded in every window)."""
    return {k: v for k, v in names.items()
            if not k.startswith(("Memcpy", "Memset"))}


def _name_diff(a, b) -> dict:
    """Kernel names whose launches differ between two profiled rounds."""
    return {k: (a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


def _route_reading(pcfg) -> dict:
    """One federation's training round through the raw ctypes launch
    (the production route) and through the custom op (the audit's route,
    with the tags left off), alternating: steps/s of each, and the two
    rounds' losses bitwise."""
    from repro_torch.core.protocol import DeVertiFL
    from repro_torch.kernels.vfl_matmul import ops as vfl_ops
    fed = DeVertiFL(pcfg.replace(rounds=1), device=DEVICE)
    fed.train()
    raw_route = vfl_ops.auditing
    rates, losses = {"raw": [], "custom_op": []}, {}
    try:
        for _ in range(ROUTE_ROUNDS):
            for name in rates:
                vfl_ops.auditing = raw_route if name == "raw" else \
                    (lambda: True)
                _dev_sync()
                t0 = time.perf_counter()
                out = fed.train()
                _dev_sync()
                wall = time.perf_counter() - t0
                got = torch.as_tensor(out["history"][0]["round_losses"])
                rates[name].append(got.numel() / wall)
                losses.setdefault(name, got)
    finally:
        vfl_ops.auditing = raw_route
    check(torch.equal(losses["raw"], losses["custom_op"]),
          "a round through the custom op is not bitwise the raw launch's")
    med = {k: float(np.median(v)) for k, v in rates.items()}
    return {"n_samples": pcfg.n_samples, "steps": losses["raw"].numel(),
            "steps_per_s": rates, "median_steps_per_s": med,
            "custom_op_over_raw": med["custom_op"] / med["raw"]}


def phase_audit(kernel_row, profile_pcfg, profile) -> None:
    """The static auditor on the card (module doc, phase 15).  The step
    outside the audit is held to the same profiled round taken just
    before the audit: the process's first profiler session (the profile
    phase's) may record kernels of its own."""
    from repro_torch.analysis import retrace as RT
    from repro_torch.analysis.audit import audit_combos, default_combos
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    before = _profiled_round(profile_pcfg)
    t_phase = time.perf_counter()
    n_combos = len(default_combos(first_layers=("kernel",), device=DEVICE))
    stamps = []
    vfl_matmul_clients.launches = 0
    rep = audit_combos(first_layers=("kernel",), n_clients=AUDIT_CLIENTS,
                       device=DEVICE, progress=lambda msg: stamps.append(
                           (msg, time.perf_counter())))
    launches = vfl_matmul_clients.launches
    stamps.append(("", time.perf_counter()))
    rows = [{"step": msg, "s": t1 - t0}
            for (msg, t0), (_, t1) in zip(stamps, stamps[1:])]
    check(rep.ok and rep.static_round_traces == 1
          and len(rep.combos) == n_combos,
          f"the kernel-lane audit grid is not clean:\n{rep.summary()}")
    implied = AUDIT_LAUNCHES_A_TRACE * (2 * n_combos + 2 * len(RT.LANE_CASES))
    check(launches == implied,
          f"the audit launched vfl_matmul {launches} times, expected "
          f"{implied} ({n_combos} combos and {len(RT.LANE_CASES)} lane "
          f"cases, two traces each, {AUDIT_LAUNCHES_A_TRACE} launches a "
          f"trace)")
    t0 = time.perf_counter()
    bitwise = {lane: _traced_is_untraced(lane) for lane in ("kernel",
                                                             "slice")}
    check(all(bitwise.values()),
          f"a traced round is not bitwise the untraced one: {bitwise}")
    planted = _planted_audits()
    for name, code in PLANTED_CODES.items():
        check(code in planted[name]["codes"],
              f"planted fault {name} not flagged {code}: {planted[name]}")
    check(planted["leaky_first_layer"]["chain_names_this_file"],
          "the leak's chain does not name chip_smoke.py")
    checks_s = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    after = _profiled_round(profile_pcfg)
    diff = _name_diff(_kernels_only(before["kernel_names"]),
                      _kernels_only(after["kernel_names"]))
    check(after["vfl_matmul_launches"] == before["vfl_matmul_launches"]
          and not diff,
          f"outside the audit a round's kernels differ from the one before "
          f"it: {_step_reading(before)} against {_step_reading(after)}; "
          f"kernels {diff}")
    route = _route_reading(profile_pcfg.replace(n_samples=ROUTE_SAMPLES))
    kernel_row["audit_launches"] = launches
    emit({"phase": "audit", "combos": n_combos, "rows": rows,
          "channels": rep.channels,
          "static_round_traces": rep.static_round_traces,
          "traced_bitwise_untraced": bitwise, "planted": planted,
          "vfl_matmul_launches": launches,
          "vfl_matmul_launches_implied": implied, "checks_s": checks_s,
          "seconds": seconds,
          "step_before_audit": _step_reading(before),
          "step_after_audit": _step_reading(after),
          "kernels_a_round": [sum(_kernels_only(r["kernel_names"]).values())
                              for r in (before, after)],
          "profile_phase_step": _step_reading(profile),
          "vs_profile_phase": _name_diff(profile["kernel_names"],
                                         after["kernel_names"]),
          "custom_op_route": route})


# the names of the port's kernels begin so (csrc/*.cu)
PORT_KERNELS = ("vfl_matmul_", "flash_attention",
                "decode_partial_kernel", "decode_combine_kernel",
                "moe_router_kernel", "rwkv6_", "mamba_scan_")


# device time by kind of kernel, from its name: the port's kernels, the
# GEMMs (cuBLAS), PyTorch's elementwise kernels (the discretisation's exp
# and products among them), reductions, copies
KERNEL_KINDS = (("port", tuple("(anonymous namespace)::" + stem
                               for stem in PORT_KERNELS)),
                ("gemm", ("nvjet", "gemm", "gemv", "sm90_xmma", "cutlass")),
                ("elementwise", ("elementwise",)),
                ("reduce", ("reduce_kernel",)),
                ("copy", ("copy", "CatArray")))


# a profiler schedule's step annotation, which the device trace also
# holds: a span over the window, not a kernel
_STEP_MARK = "ProfilerStep"


def _profile_rows(prof, wall_ms, steps) -> dict:
    """Device time by kernel, and the device's busy share of the wall
    time, from a torch.profiler run over ``steps`` steps."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type.name == "CUDA" and \
                not ev.key.startswith(_STEP_MARK):
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3

    def listed(picked):
        return [{"kernel": k[:80], "ms_per_step": us / 1e3 / steps,
                 "calls_per_step": n / steps} for us, k, n in picked]

    def kind(name):
        for k, stems in KERNEL_KINDS:
            if any(stem in name for stem in stems):
                return k
        return "other"
    by_kind = {}
    for us, k, n in rows:
        acc = by_kind.setdefault(kind(k), [0.0, 0])
        acc[0] += us / 1e3 / steps
        acc[1] += n / steps
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps if rows else None,
            "device_busy_share": device_ms / wall_ms if rows else None,
            "kernels_per_step": sum(r[2] for r in rows) / steps,
            "by_kind": {k: {"ms_per_step": v[0], "calls_per_step": v[1]}
                        for k, v in by_kind.items()},
            "top_device_kernels": listed(rows[:10]),
            "port_kernels": listed(r for r in rows if r[1].startswith(
                tuple("void (anonymous namespace)::" + stem
                      for stem in PORT_KERNELS)))}


# ---------------------------------------------------------------------------
# the round engine's schedule, fault and wire layers at the training
# phase's configuration: one round a variant, each rerun bitwise
ADV_COMBO = {"schedule": "stale_k:2", "fault": "crash:0.2+corrupt:0.05",
             "transform": "topk:0.5+int8+dp:0.1"}
ADV_VARIANTS = (
    [{"schedule": s} for s in ("sync", "stale_k:0", "partial:1.0",
                               "stale_k:2", "partial:0.5",
                               "partial:0.5:det", "double_buffer")]
    + [{"fault": f} for f in ("crash:0.2:2", "straggle:0.3:2",
                              "corrupt:0.05", "corrupt:0.05:scale")]
    + [{"transform": t} for t in ("topk:1.0", "topk:0.5", "int8",
                                  "dp:0.1")]
    + [ADV_COMBO])
# degenerate members of their families: bitwise the sync variant
ADV_BITWISE_SYNC = ("stale_k:0", "partial:1.0", "topk:1.0")
ADV_SCHEDULES = ("sync", "stale_k:1", "stale_k:2", "partial:0.5")
ADV_GRID_SEEDS = (0, 1, 2)
ADV_LANES = (("sync", 0), ("stale_k:2", 1), ("partial:0.5", 2))
ADV_FAULTS = ("none", "crash:0.2+corrupt:0.05")
ADV_TRANSFORMS = ("none", "topk:0.5+int8+dp:0.1")
# the test plan that NaN-poisons a round on a federation-wide coin
# (tests/test_torch_faults.py's): heads on the canonical draw, tails on
# the watchdog's first reseed
ADV_POISON_TAG = 0x0BAD
# the federation the adversity phase runs its variants on: the training
# phase's at 14,000 of its 70,000 samples (175 steps a round), which
# keeps every variant, grid, check and planted fault and leaves the
# script's time to the zoo and the input shapes
ADVERSITY_SAMPLES = 14_000


def _name(plan) -> str:
    return "+".join(plan.values()) if plan else "sync"


def _dev_sync() -> None:
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


class _PoisonImpl:
    def __init__(self, inner, p):
        self.inner, self.p = inner, p

    def init_state(self, sched):
        return {"inner": self.inner.init_state(sched),
                "poison": torch.zeros((), device=self.inner.device)}

    def round_start(self, state, lay, draws, round_idx):
        inner, eff = self.inner.round_start(state["inner"], lay, draws,
                                            round_idx)
        coin = draws.coins(ADV_POISON_TAG, 0, self.p)[0]
        return {"inner": inner, "poison": coin}, eff

    def select(self, state, h_now):
        h_ref, inner = self.inner.select(state["inner"], h_now)
        h_ref = torch.where(state["poison"] > 0,
                            torch.full_like(h_ref, float("nan")), h_ref)
        return h_ref, {**state, "inner": inner}

    def round_end(self, state):
        return {**state, "inner": self.inner.round_end(state["inner"])}


def _adv_run(pcfg, plan, rerun=True) -> dict:
    """One round of ``pcfg`` under ``plan`` through ``DeVertiFL.train()``
    with the vfl_matmul count set to 0 just before and read just after,
    then (``rerun``) the same federation again, bitwise, its wall time
    the variant's (warm)."""
    from repro_torch.core.protocol import DeVertiFL
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    fed = DeVertiFL(pcfg.replace(rounds=1, **plan), device=DEVICE)
    vfl_matmul_clients.launches = 0
    out = fed.train()
    launches = vfl_matmul_clients.launches
    losses = torch.as_tensor(out["history"][0]["round_losses"])
    steps = losses.numel()
    run = {"fed": fed, "losses": losses, "final": out["final"],
           "state": out["sched_state"], "steps": steps,
           "launches": launches}
    if not rerun:
        return run
    check(launches == steps + 2,
          f"adversity {_name(plan)}: vfl_matmul launched {launches} times, "
          f"expected {steps + 2} (a step each, two evaluations)")
    _dev_sync()
    t0 = time.perf_counter()
    again = fed.train()
    _dev_sync()
    run["wall"] = time.perf_counter() - t0
    check(torch.equal(losses, torch.as_tensor(
        again["history"][0]["round_losses"])) and out["final"] == again["final"],
        f"adversity {_name(plan)}: the rerun is not bitwise")
    return run


def _corrupt_reading(run) -> dict:
    tel = {k: int(v) for k, v in
           run["fed"].fault_telemetry(run["state"]).items()}
    return {"finite": bool(torch.isfinite(run["losses"]).all()), **tel}


def _corrupt_ok(r) -> bool:
    """Under corruption: every loss finite, and every corrupted
    client-round quarantined (at least one)."""
    return r["finite"] and r["quarantined"] == r["corruptions"] > 0


def _wire_reading(run, plan) -> dict:
    """The round's bytes on the wire against ``wire_bytes``'s integers
    for its live senders: the clients the round's crash coins leave up
    (all of them without a crash plan)."""
    from repro_torch.faults import FAULT_TAG, get_fault_plan
    from repro_torch.wire import get_wire_plan, wire_bytes
    fed, steps = run["fed"], run["steps"]
    n = fed.pcfg.n_clients
    crash = get_fault_plan(plan.get("fault", "none")).crash
    down = 0 if crash is None else int(fed.draws().round(0).coins(
        FAULT_TAG, 1, crash).sum())
    wire = get_wire_plan(plan["transform"])
    raw, enc = wire_bytes(n - down, fed.bs, fed.model.n_classes,
                          topk_on=float(wire.topk is not None),
                          topk_p=wire.topk_p, int8_on=float(wire.int8))
    got = {k: int(v) for k, v in
           fed.wire_telemetry(run["state"]).items()}
    want = {"raw_bytes": int(raw) * steps, "encoded_bytes": int(enc) * steps}
    check(got == want, f"adversity {_name(plan)}: wire bytes {got}, "
          f"wire_bytes for {n - down} senders x {steps} steps: {want}")
    return {"senders": n - down, **got}


def _adv_profile(pcfg) -> dict:
    """The combination's round at fewer samples under torch.profiler:
    device busy share and kernels a step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.protocol import (DeVertiFL, round_generator,
                                           train_generators)
    fed = DeVertiFL(pcfg.replace(**ADV_COMBO), device=DEVICE)
    params, opt_state = fed.start(fed.init_params(
        train_generators(pcfg.seed)[0]))
    idx = fed.perms(round_generator(pcfg.seed, 0))
    draws = fed.draws().round(0)
    fed.run_round(params, opt_state, 0, idx, fed.init_sched_state(), draws)
    _dev_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_round(params, opt_state, 0, idx, fed.init_sched_state(),
                      draws)
        _dev_sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof, wall_ms, idx.shape[0])
    return {k: rows[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                 "device_busy_share", "kernels_per_step",
                                 "by_kind")}


def _adv_session(pcfg, first_round) -> dict:
    """The combination for two rounds through
    ``build(ExperimentSpec(...)).run()``: one vfl_matmul launch a step
    and an evaluation, finite, its first round bitwise the DeVertiFL
    variant's; then a Session round poisoned on its first attempt: one
    watchdog trip, one reseeded retry, finite, rerun bitwise."""
    from repro_torch.api import ExperimentSpec, build
    from repro_torch.core.draws import CounterDraws
    from repro_torch.faults import RetryPolicy, register_fault
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    spec = ExperimentSpec(dataset=pcfg.dataset, n_clients=pcfg.n_clients,
                          n_samples=pcfg.n_samples, rounds=2, epochs=1,
                          batch_size=pcfg.batch_size, **ADV_COMBO)
    vfl_matmul_clients.launches = 0
    rr = build(spec, device=DEVICE).run()
    launches = vfl_matmul_clients.launches
    steps = rr.telemetry.steps
    losses = torch.cat([torch.as_tensor(h["round_losses"])
                        for h in rr.history])
    check(launches == steps + 3,
          f"adversity Session: {launches} vfl_matmul launches, expected "
          f"{steps + 3}")
    check(bool(torch.isfinite(losses).all())
          and torch.equal(losses[:first_round.numel()], first_round),
          "adversity Session: round 1 is not the DeVertiFL variant's, "
          "bitwise, or a loss is not finite")
    check(set(rr.timings) >= {"fault", "wire"}, f"timings {rr.timings}")

    register_fault("test_poison", lambda inner, n_clients, batch_size,
                   width, args: _PoisonImpl(inner, float(args[0])),
                   overwrite=True)

    def coin(seed, attempt):
        draws = CounterDraws(seed, pcfg.n_clients, "cpu")
        return bool(draws.round(0, attempt).coins(ADV_POISON_TAG, 0, 0.5)[0])
    seed = next(s for s in range(64) if coin(s, 0) and not coin(s, 1))
    poison = spec.replace(rounds=1, seeds=(seed,), schedule="sync",
                          transform="none", fault="test_poison:0.5")
    runs = [build(poison, device=DEVICE).run(retry=RetryPolicy(max_retries=2))
            for _ in range(2)]
    fault = runs[0].timings["fault"]
    poisoned = torch.as_tensor(runs[0].history[0]["round_losses"])
    check(fault == {"watchdog_trips": 1, "retries": 1},
          f"adversity watchdog: timings['fault'] = {fault}")
    check(bool(torch.isfinite(poisoned).all())
          and math.isfinite(runs[0].metrics["f1"]),
          "adversity watchdog: the retried round is not finite")
    check(_same_run(runs[0], runs[1]),
          "adversity watchdog: the rerun is not bitwise")
    return {"spec_hash": rr.spec_hash, "steps": steps,
            "steps_per_s": rr.telemetry.steps_per_sec,
            "vfl_matmul_launches": launches, "timings_fault":
            rr.timings["fault"], "timings_wire": rr.timings["wire"],
            "final_f1": rr.metrics["f1"],
            "watchdog": {"seed": seed, "fault": fault,
                         "f1": runs[0].metrics["f1"],
                         "rerun_bitwise": True}}


def _adv_lanes(specs, standalone) -> dict:
    """One round of ``specs``' lane batch with the vfl_matmul count set
    to 0 just before and read just after (one launch a lane-batched
    step); the lanes ``standalone`` names ({lane index: plan}) against
    their standalone DeVertiFL rounds, bitwise."""
    from repro_torch.api.session import sweep_config_for_specs
    from repro_torch.core import sweep as SW
    from repro_torch.core.protocol import (DeVertiFL, ProtocolConfig,
                                           round_generator,
                                           train_generators)
    from repro_torch.kernels.vfl_matmul import vfl_matmul_clients
    ds, mode, scfg = sweep_config_for_specs(specs)
    lb = SW.build_lane_batch(ds, mode, scfg, device=DEVICE)
    idx, draws = lb.round_indices(0), lb.round_draws(0)
    vfl_matmul_clients.launches = 0
    _dev_sync()
    t0 = time.perf_counter()
    _, _, _, _, losses = lb.round_fn(lb.params, lb.opt_state, 0, idx,
                                     lb.xtr, lb.ytr, lb.lay,
                                     lb.sched_state, draws)
    _dev_sync()
    wall = time.perf_counter() - t0
    launches = vfl_matmul_clients.launches
    check(launches == lb.n_batches,
          f"adversity grid: {launches} vfl_matmul launches for "
          f"{lb.n_batches} lane-batched steps")
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()), "adversity grid: a loss is "
          "not finite")
    out = {}
    for li, plan in standalone.items():
        nc, s = lb.lanes[li]
        fed = DeVertiFL(ProtocolConfig(
            dataset=ds, n_clients=nc, seed=s, n_samples=scfg.n_samples,
            rounds=1, epochs=1, **plan), device=DEVICE)
        params, opt_state = fed.start(fed.init_params(
            train_generators(s)[0]))
        _, _, _, _, solo = fed.run_round(
            params, opt_state, 0, fed.perms(round_generator(s, 0)),
            fed.init_sched_state(), fed.draws().round(0))
        check(torch.equal(losses[li], solo.cpu()),
              f"adversity grid: lane {li} ({_name(plan)}, seed {s}) is not "
              "its standalone run, bitwise")
        out[f"{_name(plan)}/{s}"] = "bitwise"
    return {"lanes": lb.n_lanes, "steps": lb.n_batches, "wall_s": wall,
            "lane_steps_per_s": lb.n_lanes * lb.n_batches / wall,
            "vfl_matmul_launches": launches, "vs_standalone": out}


def phase_adversity(kernel_row, pcfg) -> None:
    """The round engine's schedule, fault and wire layers at the training
    phase's configuration at ``pcfg.n_samples`` (mnist 784 -> 3x10 -> 10,
    5 clients, kernel lane; main passes ADVERSITY_SAMPLES): one round of
    each variant through
    ``DeVertiFL.train()``, each rerun bitwise and launching vfl_matmul
    once a step and once an evaluation; the degenerate members bitwise
    sync; the screen under corruption, with a planted fault (a screen
    that lets a NaN slice through) failing that check; wire bytes
    against ``wire_bytes``; the combination's device profile; the
    combination through the Session and the watchdog's rollback; a
    schedule grid and a fault x transform grid, lanes bitwise their
    standalone runs."""
    import repro_torch.faults.engine as FE
    from repro_torch.api import run_grid, spec_grid
    t_phase = time.perf_counter()
    runs, rows = {}, {}
    for plan in ADV_VARIANTS:
        name = _name(plan)
        run = runs[name] = _adv_run(pcfg, plan)
        check(bool(torch.isfinite(run["losses"]).all()),
              f"adversity {name}: a loss is not finite")
        rows[name] = {"steps_per_s": run["steps"] / run["wall"],
                      "vfl_matmul_launches": run["launches"],
                      "final_f1": run["final"]["f1"],
                      "last_loss": float(run["losses"][-1])}
        tel = run["fed"].fault_telemetry(run["state"])
        if tel is not None:
            rows[name]["fault"] = {k: int(v) for k, v in tel.items()}
        if "transform" in plan:
            rows[name]["wire"] = _wire_reading(run, plan)
    sync = runs["sync"]
    for name in ADV_BITWISE_SYNC:
        check(torch.equal(runs[name]["losses"], sync["losses"])
              and runs[name]["final"] == sync["final"],
              f"adversity {name}: not bitwise the sync run")
    for name in ("corrupt:0.05", "corrupt:0.05:scale", _name(ADV_COMBO)):
        reading = _corrupt_reading(runs[name])
        check(_corrupt_ok(reading), f"adversity {name}: {reading}")
    # the planted fault: a screen that lets a NaN slice through
    screen = FE.screen_exchange

    def leaky(payload, last_good, max_abs):
        return payload, torch.zeros(payload.shape[0], dtype=torch.bool,
                                    device=payload.device)
    FE.screen_exchange = leaky
    try:
        planted = _corrupt_reading(_adv_run(pcfg, {"fault": "corrupt:0.05"},
                                            rerun=False))
    finally:
        FE.screen_exchange = screen
    check(not _corrupt_ok(planted),
          f"adversity: a leaky screen passed the corruption check {planted}")
    # sync once more after the others: the host clock's drift over the
    # variants, beside which their ratios to sync are read
    sync_after = _adv_run(pcfg, {})
    check(torch.equal(sync_after["losses"], sync["losses"]),
          "adversity: sync after the variants is not the sync run, bitwise")
    rows["sync"]["steps_per_s_after"] = sync_after["steps"] / \
        sync_after["wall"]
    for name, row in rows.items():
        row["vs_sync"] = row["steps_per_s"] / rows["sync"]["steps_per_s"]
    profile = _adv_profile(pcfg.replace(n_samples=4000))
    session = _adv_session(pcfg, runs[_name(ADV_COMBO)]["losses"])

    common = dict(datasets=(pcfg.dataset,), modes=("devertifl",),
                  client_counts=(pcfg.n_clients,), rounds=1, epochs=1,
                  n_samples=pcfg.n_samples, batch_size=pcfg.batch_size)
    sched_specs = spec_grid(seeds=ADV_GRID_SEEDS, schedules=ADV_SCHEDULES,
                            **common)
    n_seeds = len(ADV_GRID_SEEDS)
    sched_grid = _adv_lanes(sched_specs, {
        ADV_SCHEDULES.index(sc) * n_seeds + ADV_GRID_SEEDS.index(s):
        {"schedule": sc} for sc, s in ADV_LANES})
    grid = run_grid(sched_specs, device=DEVICE)
    check(len(grid["cells"]) == len(ADV_SCHEDULES)
          and all(math.isfinite(c["f1_mean"]) for c in grid["cells"].values()),
          f"adversity: the schedule grid's cells {sorted(grid['cells'])}")
    ft_specs = spec_grid(seeds=(0,), faults=ADV_FAULTS,
                         transforms=ADV_TRANSFORMS, **common)
    ft_grid = _adv_lanes(ft_specs, {3: {"fault": ADV_FAULTS[1],
                                        "transform": ADV_TRANSFORMS[1]}})
    kernel_row["adversity"] = {name: row["vfl_matmul_launches"]
                               for name, row in rows.items()}
    kernel_row["adversity"]["schedule_grid"] = \
        sched_grid["vfl_matmul_launches"]
    kernel_row["adversity"]["session_2_rounds"] = \
        session["vfl_matmul_launches"]
    emit({"phase": "adversity", "dataset": pcfg.dataset,
          "n_clients": pcfg.n_clients, "n_samples": pcfg.n_samples,
          "first_layer": sync["fed"].first_layer,
          "variants": rows, "bitwise_sync": list(ADV_BITWISE_SYNC),
          "corrupt": {n: _corrupt_reading(runs[n]) for n in
                      ("corrupt:0.05", "corrupt:0.05:scale",
                       _name(ADV_COMBO))},
          "planted_leaky_screen": planted,
          "combination_profile": profile, "session": session,
          "schedule_grid": {**sched_grid,
                            "cells": {k: v["f1_mean"]
                                      for k, v in grid["cells"].items()}},
          "fault_transform_grid": ft_grid,
          "phase_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
def _serve(model, params, requests, max_batch, cache_len):
    """Drain ``requests`` through a fresh ServingEngine, driving the
    admit / step loop of ``ServingEngine.run`` here so that each call is
    timed on the host (both end there, reading the sampled tokens).  A
    request's first token counts at the end of the admit call that
    prefilled it: the engine hands out tokens between its calls."""
    from repro_torch.serving import ServingEngine
    engine = ServingEngine(model, params, max_batch=max_batch,
                           cache_len=cache_len)
    for r in requests:
        engine.submit(r)
    admit_s, step_s, active, first = [], [], [], []
    torch.cuda.synchronize()
    start = time.perf_counter()
    while engine.queue or any(s.active for s in engine.slots):
        before = engine.prefills
        t0 = time.perf_counter()
        engine._admit()
        t1 = time.perf_counter()
        admit_s.append(t1 - t0)
        first += [t1 - start] * (engine.prefills - before)
        if any(s.active for s in engine.slots):
            active.append(sum(s.active for s in engine.slots))
            t0 = time.perf_counter()
            engine.step()
            step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - start
    return engine, dict(engine.done), {
        "admit_s": admit_s, "step_s": step_s, "active": active,
        "first_token_s": first, "wall_s": wall}


def _window_cuts(rows) -> dict:
    """Two planted faults of a causal prefill of ``rows`` rows, in every
    layer: the kernel with its window 1 or 32 keys short.  A layer
    without a window gets one of ``rows`` less 1 or 32 (its last row
    misses its first key, or its first 32-key tile); a windowed layer
    its own window less 1 or 32 (every row past the window misses its
    oldest key or 32 keys)."""
    from repro_torch.kernels.flash_attention import flash_attention

    def cut(keys):
        def attend(q, k, v, **kw):
            return flash_attention(q, k, v, **{
                **kw, "window": (kw["window"] or rows) - keys})
        return attend
    return {"one_key": (cut(1), None), "one_tile": (cut(32), None)}


def _plain_by_kv_head(q, k, v, **kw):
    """flash_attention_ref one kv head (and its group of query heads) at
    a time: the same function in a fraction of the memory (a llava
    prefill's scores at once are 2.6 GB a call)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    g = q.shape[1] // k.shape[1]
    return torch.cat([flash_attention_ref(q[:, i * g:(i + 1) * g],
                                          k[:, i:i + 1], v[:, i:i + 1], **kw)
                      for i in range(k.shape[1])], dim=1)


def _logit_readings(cfg, params, batch, cache_len, faults) -> dict:
    """The batch's last-token prefill logits through the kernel against
    the plain version's, |diff| over |plain| (L2 over the vocabulary);
    the same reading for each planted fault in ``faults``: name ->
    (attention function or None for the kernel, the batch it reads or
    None for the same)."""
    from repro_torch.models import build_model

    def logits(attend, b=None):
        return build_model(cfg, attend=attend).prefill(
            params, b or batch, cache_len=cache_len)[0].flatten()

    plain = logits(_plain_by_kv_head)

    def rel(x):
        return float((x - plain).norm() / plain.norm())
    kernel = logits(None)
    return {"prompt_tokens": batch["tokens"].shape[1],
            "prefix_rows": batch["prefix_emb"].shape[1]
            if "prefix_emb" in batch else 0,
            "rel_l2": rel(kernel),
            "max_abs": max_err(kernel, plain),
            "max_abs_plain": float(plain.abs().max()),
            "cosine": float(torch.nn.functional.cosine_similarity(
                kernel, plain, dim=0)),
            "same_top1": int(kernel.argmax()) == int(plain.argmax()),
            "finite": bool(torch.isfinite(kernel).all()),
            **{f"fault_{name}_rel_l2": rel(logits(attend, b))
               for name, (attend, b) in faults.items()}}


def _plain_floor(q, k, v, kw, rows=None) -> float:
    """The float32 rounding floor of an attention call: the plain version
    in float32 against float64 on its last ``rows`` (SHAPE_ROWS) query
    rows, the rows with the longest reductions; max |difference|."""
    rows = rows or SHAPE_ROWS
    S = q.shape[2]
    lo = max(0, S - rows)
    o = dict(kw)
    if lo and kw.get("q_pos") is None:      # a prefill, masked by index
        o["q_pos"] = torch.arange(lo, S, dtype=torch.int32, device=q.device)
    qs = q[:, :, lo:]
    r32 = _plain_by_kv_head(qs.float(), k.float(), v.float(), **o)
    r64 = _plain_by_kv_head(qs.double(), k.double(), v.double(), **o)
    return float((r32.double() - r64).abs().max())


def _attn_call_readings(cfg, params, batch, cache_len, faults,
                        floor=False) -> dict:
    """The batch's prefill with every attention call's kernel output held
    against the plain version on the same inputs, element by element
    (``attn_excess``, with each call's ``_plain_floor`` where ``floor``;
    the run goes on with the kernel's output), and each planted fault
    (name -> attention function) read the same way on the same calls."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    readings = {"kernel": [], **{name: [] for name in faults}}
    shapes = {}
    floors = []

    def checked(q, k, v, **kw):
        out = flash_attention(q, k, v, **kw)
        want = _plain_by_kv_head(q.float(), k.float(), v.float(), **kw)
        fl = _plain_floor(q, k, v, kw) if floor else 0.0
        floors.append(fl)
        readings["kernel"].append(attn_excess(out, want, fl))
        for name, fault in faults.items():
            readings[name].append(attn_excess(fault(q, k, v, **kw), want,
                                              fl))
        key = (f"{'causal' if kw['causal'] else 'non-causal'}, Sq "
               f"{q.shape[2]} over Skv {k.shape[2]}")
        shapes[key] = shapes.get(key, 0) + 1
        return out

    with torch.no_grad():
        build_model(cfg, attend=checked).prefill(params, batch,
                                                 cache_len=cache_len)
    return {"calls": shapes, **({"floor_max": max(floors)} if floor else {}),
            **{name: {"calls": len(rs), "max_excess": max(rs),
                      "calls_over_limit": sum(r > 1.0 for r in rs)}
               for name, rs in readings.items()}}


def _call_checks(name, calls, faults) -> None:
    check(calls["kernel"]["max_excess"] <= 1.0,
          f"{name} prefill attention calls, kernel vs plain: "
          f"{calls['kernel']}")
    for fault in faults:
        check(calls[fault]["max_excess"] > 1.0, f"planted fault '{fault}' "
              f"passed the {name} attention check: {calls[fault]}")


# every parameter of each served tree, as jax.eval_shape of the JAX
# package's Model.init counts it at the same config (matrices, norms,
# biases and vectors: more than ModelConfig.param_counts, which counts
# matrices only and simplifies rwkv6 and Mamba); (arch, layers) -> count
SERVED_PARAMS = {("qwen2-7b", 28): 7_615_616_512,
                 ("deepseek-moe-16b", 28): 16_375_728_128,
                 ("rwkv6-1.6b", 24): 1_584_091_136,
                 ("jamba-v0.1-52b", 16): 26_053_480_448,
                 ("llava-next-34b", 60): 34_388_917_248,
                 ("seamless-m4t-medium", 12): 877_260_800,
                 ("qwen1.5-0.5b", 24): 463_987_712,
                 ("deepseek-moe-16b", 2): 1_091_315_712,
                 ("rwkv6-1.6b", 2): 378_077_184,
                 ("jamba-v0.1-52b", 2): 3_742_289_920,
                 ("llava-next-34b", 4): 3_148_938_240,
                 ("gemma2-2b", 26): 2_062_146_816,
                 ("qwen1.5-4b", 40): 3_950_369_280,
                 ("qwen2-7b-swa", 28): 7_615_616_512,
                 ("mixtral-8x22b", 13): 32_955_451_392}


def _init_model(name, num_layers=None, dtype=None):
    """The architecture at full width (and depth, unless ``num_layers``
    cuts it; in its config's dtype unless ``dtype`` names another),
    random weights drawn on the card from a seeded generator; checks the
    parameter count."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    cfg = get_config(name)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    want = SERVED_PARAMS[cfg.name, cfg.num_layers]
    check(n_params == want, f"{name} at {cfg.num_layers} layers has "
          f"{n_params} parameters, not {want}")
    return cfg, model, params, {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": n_params,
        "weight_gb": sum(t.numel() * t.element_size() for t in leaves) / 1e9,
        "setup_s": setup_s,
        "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}


N_NEW, MAX_BATCH, CACHE_LEN = 32, 8, 2048
# where the serving phases run: the card (a rehearsal on the CPU, at a
# reduced size with the plain versions, sets "cpu")
DEVICE = "cuda"


# an engine's slots, cache slots a slot and new tokens a request (a
# namedtuple: the tests load this file as a module outside sys.modules,
# where a dataclass cannot be made)
Serving = collections.namedtuple("Serving", "max_batch cache_len n_new")
TEXT = Serving(MAX_BATCH, CACHE_LEN, N_NEW)


def _prompts(cfg):
    """12 prompts of 128-1536 tokens (numpy seed 0): more requests than
    slots, so slots refill."""
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = rng.integers(128, 1537, 12)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in lengths]


def _requests(prompts, n_new=N_NEW):
    from repro_torch.serving import Request
    return [Request(uid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels import (
        flash_attention, mamba_scan, mamba_scan_fused, moe_router,
        rwkv6_scan, vfl_matmul_clients)
    return {"vfl_matmul": vfl_matmul_clients,
            "flash_attention": flash_attention, "moe_router": moe_router,
            "rwkv6_scan": rwkv6_scan, "mamba_scan": mamba_scan,
            "mamba_scan_fused": mamba_scan_fused}


def _counted_serve(cfg, model, params, prompts, per_layer, run=TEXT,
                   rerun=True):
    """Serve the prompts with every launch count set to 0 just before
    and read just after; checks the tokens, that each kernel in
    ``per_layer`` (name -> its wrapper calls a prefill and a decode
    step, as one count for both or a (prefill, step) pair) launched so
    often, and that no other kernel launched.  Then (``rerun``) a rerun,
    whose tokens must be bitwise equal.  Returns (launches, engine
    counts, tokens, timings, peak bytes)."""
    wrappers = _wrappers()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    engine, out, t = _serve(model, params, _requests(prompts, run.n_new),
                            run.max_batch, run.cache_len)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    check(sorted(out) == list(range(len(prompts))), f"done: {sorted(out)}")
    check(all(len(v) == run.n_new and all(0 <= x < cfg.vocab_size
                                          for x in v)
              for v in out.values()), "a request's tokens are not "
          f"{run.n_new} in-vocab ids")
    for name in wrappers:
        n = per_layer.get(name, 0)
        pre, step = n if isinstance(n, tuple) else (n, n)
        want = pre * engine.prefills + step * engine.decode_steps
        check(launches[name] == want,
              f"{cfg.name}: {name} launched {launches[name]} times, "
              f"expected {want} = {pre} x {engine.prefills} prefills + "
              f"{step} x {engine.decode_steps} decode steps")
    counts = {"prefills": engine.prefills, "decode_steps": engine.decode_steps}
    del engine
    if rerun:
        _, again, _ = _serve(model, params, _requests(prompts, run.n_new),
                             run.max_batch, run.cache_len)
        check(again == out, f"{cfg.name} serving rerun: tokens are not "
              "bitwise equal")
    return launches, counts, out, t, peak


def _serve_metrics(prompts, t, run=TEXT, prefix_rows=0) -> dict:
    """Tokens/s, TTFT and step times of a ``_serve`` run; prefill rows/s
    also counts each request's ``prefix_rows`` (a vlm's image rows)."""
    step_ms = [x * 1e3 for x in t["step_s"]]
    rows = sum(map(len, prompts)) + prefix_rows * len(prompts)
    return {
        "max_batch": run.max_batch, "cache_len": run.cache_len,
        "requests": len(prompts),
        "prompt_lengths": [len(p) for p in prompts], "new_tokens": run.n_new,
        "wall_s": t["wall_s"],
        "prefill_tokens_per_s": sum(map(len, prompts)) / sum(t["admit_s"]),
        "prefill_rows_per_s": rows / sum(t["admit_s"]),
        "decode_tokens_per_s": sum(t["active"]) / sum(t["step_s"]),
        "ttft_s": {"first_request": t["first_token_s"][0],
                   "mean": sum(t["first_token_s"]) / len(prompts),
                   "max": max(t["first_token_s"])},
        "decode_step_ms": {"mean": sum(step_ms) / len(step_ms),
                           "median": sorted(step_ms)[len(step_ms) // 2],
                           "min": min(step_ms), "max": max(step_ms)},
        "rerun_bitwise": True}


def _serve_profiles(model, params, prompts, run=TEXT, prefix=None,
                    rows=1024) -> dict:
    """Where an engine decode step (8 slots after 8 prefills) and a
    prefill of the second prompt's first ``rows`` tokens (all of them
    for None; after ``prefix``, a vlm's image rows or an encoder's
    frames) spend their time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServingEngine
    engine = ServingEngine(model, params, max_batch=run.max_batch,
                           cache_len=run.cache_len)
    for r in _requests(prompts, run.n_new)[:run.max_batch]:
        engine.submit(r)
    engine._admit()
    engine.step()
    batch = _batch(prompts[1][:rows], prefix)
    model.prefill(params, batch, cache_len=run.cache_len)
    torch.cuda.synchronize()
    rows = batch["tokens"].shape[1]
    if prefix is not None and not model.cfg.is_encoder_decoder:
        rows = f"{prefix.shape[1]} + {rows}"
    profiles = {}
    for name, fn in ((f"decode step, B={run.max_batch}", engine.step),
                     (f"prefill, S={rows}", lambda: model.prefill(
                         params, batch, cache_len=run.cache_len))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profiles[name] = _profile_rows(prof, wall_ms, 1)
    return profiles


def _batch(prompt, prefix=None) -> dict:
    """A B = 1 prefill batch on the card: the prompt, and ``prefix``
    [1, P, D] as its ``prefix_emb`` where given."""
    batch = {"tokens": torch.tensor([prompt], device=DEVICE)}
    if prefix is not None:
        batch["prefix_emb"] = prefix
    return batch


def phase_serve(attn_row) -> None:
    cfg, model, params, info = _init_model("qwen2-7b")
    prompts = _prompts(cfg)
    launches, counts, _, t, peak = _counted_serve(
        cfg, model, params, prompts, {"flash_attention": cfg.num_layers})

    # the first prompt's logits, kernel vs plain attention, and the
    # planted faults the comparison must see
    logit = _logit_readings(cfg, params, _batch(prompts[0]), CACHE_LEN,
                            _window_cuts(len(prompts[0])))
    emit({"phase": "serve_logits", "rtol": SERVE_LOGIT_RTOL, **logit})
    check(logit["rel_l2"] <= SERVE_LOGIT_RTOL,
          f"prefill logits, kernel vs plain attention: |diff| / |plain| = "
          f"{logit['rel_l2']} > {SERVE_LOGIT_RTOL}")
    check(logit["fault_one_tile_rel_l2"] > SERVE_LOGIT_RTOL,
          f"planted fault (one 32-key tile missed) passed the logits check: "
          f"{logit['fault_one_tile_rel_l2']} <= {SERVE_LOGIT_RTOL}")

    attn_row["launches"] = launches["flash_attention"]
    emit({"phase": "serve", **info, "serve_peak_gb": peak / 1e9, **counts,
          "flash_attention_launches": launches["flash_attention"],
          **_serve_metrics(prompts, t),
          "logits_kernel_vs_plain_rel_l2": logit["rel_l2"]})
    emit({"phase": "serve_profile", **_serve_profiles(model, params,
                                                      prompts)})


def _route_readings(cfg, params, prompt, cache_len=CACHE_LEN) -> dict:
    """The prompt's prefill through the kernel router, every MoE layer's
    routes held against the plain router on the same logits (the run
    goes on with the kernel's), and two planted faults read the same
    way; then the last-token logits against a prefill routed by the
    plain version, |diff| over |plain| (L2 over the vocabulary)."""
    from repro_torch.kernels.moe_router import moe_router, moe_router_ref
    from repro_torch.models import build_model
    faults = {"first and k-th picks swapped": _swap_first_and_kth,
              "k-th pick in place of the first": _kth_for_first}
    readings = {"kernel": [], **{name: [] for name in faults}}

    def route(logits, k):
        out = moe_router(logits, k)
        plain = moe_router_ref(logits, k)
        readings["kernel"].append(route_reading(out, plain, logits))
        for name, fault in faults.items():
            readings[name].append(route_reading(fault(out), plain, logits))
        return out

    batch = {"tokens": torch.tensor([prompt], device=DEVICE)}

    def logits(router):
        return build_model(cfg, route=router).prefill(
            params, batch, cache_len=cache_len)[0].flatten()
    kernel = logits(route)
    plain = logits(moe_router_ref)
    out = {"prompt_tokens": len(prompt), "moe_layers": len(
        readings["kernel"])}
    for name, rs in readings.items():
        out[name] = {
            "routes": sum(r["routes"] for r in rs),
            "differ": sum(r["differ"] for r in rs),
            "max_margin_of_differing": max(r["max_margin_of_differing"]
                                           for r in rs),
            "repeated": sum(r["repeated"] for r in rs),
            "w_max_abs_err": max(r["w_max_abs_err"] for r in rs),
            "stats_excess": max(r["stats_excess"] for r in rs),
            "ok": all(route_ok(r) for r in rs)}
    out.update({
        "logits_rel_l2": float((kernel - plain).norm() / plain.norm()),
        "logits_max_abs": max_err(kernel, plain),
        "logits_max_abs_plain": float(plain.abs().max()),
        "same_top1": int(kernel.argmax()) == int(plain.argmax()),
        "finite": bool(torch.isfinite(kernel).all())})
    return out


def _route_checks(name, routes, n_moe) -> None:
    """The prefill's routes: every MoE layer read, each held to the
    plain router, the planted faults failing, the logits finite."""
    check(routes["moe_layers"] == n_moe, f"{name}: routes read at "
          f"{routes['moe_layers']} of {n_moe} MoE layers")
    check(routes["kernel"]["ok"], f"{name} prefill routes, kernel vs plain "
          f"router: {routes['kernel']}")
    check(routes["finite"], f"{name} prefill logits not finite")
    for fault in ("first and k-th picks swapped",
                  "k-th pick in place of the first"):
        check(not routes[fault]["ok"], f"planted fault '{fault}' passed "
              f"the route check: {routes[fault]}")


def phase_serve_moe(router_row, attn_row) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg, model, params, info = _init_model("deepseek-moe-16b")
    n_moe = sum(kind["ffn"] == "moe" for kind in model.kinds)
    check(n_moe == 27, f"deepseek-moe-16b has {n_moe} MoE layers")
    prompts = _prompts(cfg)
    launches, counts, _, t, peak = _counted_serve(
        cfg, model, params, prompts,
        {"flash_attention": cfg.num_layers, "moe_router": n_moe})

    routes = _route_readings(cfg, params, prompts[0])
    emit({"phase": "serve_moe_routes", "route_margin": ROUTE_MARGIN,
          **routes})
    _route_checks("deepseek-moe-16b", routes, n_moe)

    router_row["launches"] = launches["moe_router"]
    attn_row["launches_serve_moe"] = launches["flash_attention"]
    emit({"phase": "serve_moe", **info,
          "experts": [cfg.num_experts, cfg.num_experts_per_tok,
                      cfg.num_shared_experts],
          "moe_d_ff": cfg.moe_d_ff,
          "first_layer_dense_ff": cfg.first_layer_dense_ff,
          "allocated_before_gb": held / 1e9, "serve_peak_gb": peak / 1e9,
          **counts, "moe_router_launches": launches["moe_router"],
          "flash_attention_launches": launches["flash_attention"],
          **_serve_metrics(prompts, t),
          "routes_differ": routes["kernel"]["differ"],
          "logits_kernel_vs_plain_router_rel_l2": routes["logits_rel_l2"]})
    emit({"phase": "serve_moe_profile", **_serve_profiles(model, params,
                                                          prompts)})


def _release() -> int:
    """Frees what the previous phase's model held on the card; returns
    the bytes still allocated."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _summary(rs) -> dict:
    return {"calls": len(rs),
            "excess": max(r["excess"] for r in rs),
            "state_excess": max(r["state_excess"] for r in rs),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ok": all(_scan_ok(r) for r in rs)}


def _scan_checks(cfg, params, prompt, hook, kernel, plain, faults,
                 logit_fault) -> dict:
    """The prompt's prefill with every layer's scan held against the
    plain version on the same inputs (the run goes on with the kernel's
    output), and each planted fault read the same way; then its
    last-token logits against a prefill through the plain version,
    |diff| over |plain| (L2 over the vocabulary), and the same reading
    for the prefill through the fault named ``logit_fault``."""
    from repro_torch.models import build_model
    readings = {"kernel": [], **{name: [] for name in faults}}

    def checked(*args, **kw):
        out = kernel(*args, **kw)
        want = plain(*args)
        readings["kernel"].append(_scan_reading(out, want))
        for name, fault in faults.items():
            readings[name].append(_scan_reading(fault(*args), want))
        return out

    batch = {"tokens": torch.tensor([prompt], device=DEVICE)}

    def logits(fn):
        with torch.no_grad():
            return build_model(cfg, **{hook: fn}).prefill(
                params, batch, cache_len=CACHE_LEN)[0].flatten()
    got = logits(checked)
    want = logits(plain)
    bad = logits(faults[logit_fault])

    def rel(x):
        return float((x - want).norm() / want.norm())
    return {"prompt_tokens": len(prompt),
            **{name: _summary(rs) for name, rs in readings.items()},
            "logits_rel_l2": rel(got), "logits_max_abs": max_err(got, want),
            "logits_max_abs_plain": float(want.abs().max()),
            "same_top1": int(got.argmax()) == int(want.argmax()),
            "finite": bool(torch.isfinite(got).all()),
            "logit_fault": logit_fault, "fault_logits_rel_l2": rel(bad)}


def _carry_readings(model, params, prompt, mixer, leaf) -> dict:
    """The state carry: prefill(prompt[:n]) then one decode step of
    prompt[n] against prefill(prompt[:n + 1]), |diff| over |plain| (L2)
    on the last logits and on every recurrent layer's state (the
    largest); then the same with the decode starting from a zeroed
    recurrent state."""
    n = len(prompt) - 1
    toks = torch.tensor([prompt], device=DEVICE)

    def states(st):
        return [t[g] for sub in st["cache"]["scanned"].values()
                if mixer in sub for t in (sub[mixer][leaf],)
                for g in range(t.shape[0])]
    with torch.no_grad():
        want, want_st = model.prefill(params, {"tokens": toks},
                                      cache_len=CACHE_LEN)
        out = {"prompt_tokens": n + 1, "state": f"{mixer}.{leaf}"}
        for name, zero in (("carried", False), ("zeroed state", True)):
            _, st = model.prefill(params, {"tokens": toks[:, :n]},
                                  cache_len=CACHE_LEN)
            if zero:
                for t in states(st):
                    t.zero_()
            logits, st = model.decode_step(params, st, toks[:, n:n + 1])
            out[name] = {
                "logits_rel_l2": float((logits - want).norm() /
                                       want.norm()),
                "state_rel_l2": max(float((a - b).norm() / b.norm())
                                    for a, b in zip(states(st),
                                                    states(want_st))),
                "layers": len(states(st))}
    return out


def carry_ok(r) -> bool:
    return r["logits_rel_l2"] <= CARRY_LOGIT_RTOL and \
        r["state_rel_l2"] <= CARRY_STATE_RTOL


def _ssm_checks(name, scans, carry, faults) -> None:
    check(scans["kernel"]["ok"], f"{name} prefill scans, kernel vs plain: "
          f"{scans['kernel']}")
    check(scans["finite"], f"{name} prefill logits not finite")
    for fault in faults:
        check(not scans[fault]["ok"], f"planted fault '{fault}' passed the "
              f"{name} scan check: {scans[fault]}")
    check(scans["logits_rel_l2"] <= SSM_LOGIT_RTOL,
          f"{name} prefill logits, kernel vs plain scan: |diff| / |plain| "
          f"= {scans['logits_rel_l2']} > {SSM_LOGIT_RTOL}")
    check(scans["fault_logits_rel_l2"] > SSM_LOGIT_RTOL,
          f"planted fault '{scans['logit_fault']}' passed the {name} logits "
          f"check: {scans['fault_logits_rel_l2']} <= {SSM_LOGIT_RTOL}")
    check(carry_ok(carry["carried"]), f"{name} state carry: "
          f"{carry['carried']}")
    check(not carry_ok(carry["zeroed state"]), f"planted fault (decode "
          f"from a zeroed state) passed the {name} carry check: "
          f"{carry['zeroed state']}")


def phase_serve_rwkv(rwkv_row) -> None:
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_ref
    held = _release()
    cfg, model, params, info = _init_model("rwkv6-1.6b")
    n_rwkv = sum(kind["mixer"] == "rwkv" for kind in model.kinds)
    check(n_rwkv == 24, f"rwkv6-1.6b has {n_rwkv} RWKV layers")
    prompts = _prompts(cfg)
    launches, counts, _, t, peak = _counted_serve(
        cfg, model, params, prompts, {"rwkv6_scan": n_rwkv})

    def no_bonus(r, k, v, w, u, state=None, *, state_out=None):
        return rwkv6_scan(r, k, v, w, torch.zeros_like(u), state,
                          state_out=state_out)
    faults = {"bonus u dropped": no_bonus}
    scans = _scan_checks(cfg, params, prompts[0], "wkv", rwkv6_scan,
                         rwkv6_scan_ref, faults, "bonus u dropped")
    carry = _carry_readings(model, params, prompts[0], "rwkv", "wkv")
    emit({"phase": "serve_rwkv_checks", "logits_rtol": SSM_LOGIT_RTOL,
          "carry_rtol": {"logits": CARRY_LOGIT_RTOL,
                         "state": CARRY_STATE_RTOL},
          "scans": scans, "carry": carry})
    _ssm_checks("rwkv6-1.6b", scans, carry, faults)

    rwkv_row["launches"] = launches["rwkv6_scan"]
    emit({"phase": "serve_rwkv", **info, "rwkv_layers": n_rwkv,
          "allocated_before_gb": held / 1e9, "serve_peak_gb": peak / 1e9,
          **counts, "rwkv6_scan_launches": launches["rwkv6_scan"],
          **_serve_metrics(prompts, t),
          "logits_kernel_vs_plain_rel_l2": scans["logits_rel_l2"],
          "carry_logits_rel_l2": carry["carried"]["logits_rel_l2"]})
    emit({"phase": "serve_rwkv_profile", **_serve_profiles(model, params,
                                                           prompts)})


# jamba-v0.1-52b at 16 of its 32 layers: the full depth holds
# 51,570,085,888 parameters, 103.15 GB in bf16, over the card's 80 GB;
# 16 layers are two of its four 8-layer periods (26,053,480,448
# parameters, 52.11 GB), so every layer kind keeps its share
JAMBA_LAYERS = 16


def phase_serve_hybrid(mamba_row, attn_row, router_row) -> None:
    from repro_torch.kernels.mamba_scan import (
        mamba_scan_fused, mamba_scan_fused_ref)
    held = _release()
    cfg, model, params, info = _init_model("jamba-v0.1-52b", JAMBA_LAYERS)
    kinds = model.kinds
    n_mamba = sum(kind["mixer"] == "mamba" for kind in kinds)
    n_attn = sum(kind["mixer"] == "attn" for kind in kinds)
    n_moe = sum(kind["ffn"] == "moe" for kind in kinds)
    check((n_mamba, n_attn, n_moe) == (14, 2, 8),
          f"jamba at {JAMBA_LAYERS} layers: {n_mamba} Mamba, {n_attn} "
          f"attention, {n_moe} MoE layers")
    prompts = _prompts(cfg)
    # the fused scan at every Mamba layer; the unfused kernel not at all
    launches, counts, _, t, peak = _counted_serve(
        cfg, model, params, prompts,
        {"mamba_scan_fused": n_mamba, "flash_attention": n_attn,
         "moe_router": n_moe})

    routes = _route_readings(cfg, params, prompts[0])
    emit({"phase": "serve_hybrid_routes", "route_margin": ROUTE_MARGIN,
          **routes})
    _route_checks("jamba-v0.1-52b", routes, n_moe)

    faults = {"y read from h_{t-1}": _fused_y_from_previous,
              "dt one step late": _fused_dt_late,
              "last channel tile short one channel": _fused_short}
    scans = _scan_checks(cfg, params, prompts[0], "sscan", mamba_scan_fused,
                         mamba_scan_fused_ref, faults, "y read from h_{t-1}")
    carry = _carry_readings(model, params, prompts[0], "mamba", "h")
    emit({"phase": "serve_hybrid_checks", "logits_rtol": SSM_LOGIT_RTOL,
          "carry_rtol": {"logits": CARRY_LOGIT_RTOL,
                         "state": CARRY_STATE_RTOL},
          "scans": scans, "carry": carry})
    _ssm_checks("jamba-v0.1-52b", scans, carry, faults)

    mamba_row["launches"] = launches["mamba_scan_fused"]
    mamba_row["routes"]["fused"]["launches"] = launches["mamba_scan_fused"]
    mamba_row["routes"]["unfused"]["launches"] = launches["mamba_scan"]
    attn_row["launches_serve_hybrid"] = launches["flash_attention"]
    router_row["launches_serve_hybrid"] = launches["moe_router"]
    emit({"phase": "serve_hybrid", **info,
          "cut": f"{JAMBA_LAYERS} of 32 layers (103.15 GB of bf16 weights "
                 "at full depth do not fit 80 GB)",
          "layers_by_kind": {"mamba": n_mamba, "attention": n_attn,
                             "moe": n_moe},
          "allocated_before_gb": held / 1e9, "serve_peak_gb": peak / 1e9,
          **counts,
          "mamba_scan_fused_launches": launches["mamba_scan_fused"],
          "mamba_scan_launches": launches["mamba_scan"],
          "flash_attention_launches": launches["flash_attention"],
          "moe_router_launches": launches["moe_router"],
          **_serve_metrics(prompts, t),
          "routes_differ": routes["kernel"]["differ"],
          "logits_kernel_vs_plain_rel_l2": scans["logits_rel_l2"],
          "carry_logits_rel_l2": carry["carried"]["logits_rel_l2"]})
    emit({"phase": "serve_hybrid_profile", **_serve_profiles(model, params,
                                                             prompts)})


# ---------------------------------------------------------------------------
# the vlm and audio families: llava-next-34b's 2,880 image rows before
# the prompt in the decoder's cache (32 new tokens), seamless-m4t-medium's
# 1,024 frames through its encoder (64 new)
VLM = Serving(max_batch=8, cache_len=3456, n_new=32)
AUDIO = Serving(max_batch=8, cache_len=128, n_new=64)


def _random_prefix(cfg, seed):
    """[1, P, D] image rows or frames (numpy seed), in the model's
    dtype on the card: what the logit readings feed in place of the
    engine's zeros, so that the prefix carries information."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, cfg.num_prefix_embeddings, cfg.d_model),
                            np.float32)
    return torch.from_numpy(x).to(DEVICE, getattr(torch, cfg.dtype))


def phase_serve_vlm(attn_row) -> None:
    """llava-next-34b at full width and depth through ServingEngine: 12
    requests of 32-512 text tokens (numpy seed 0), each after the
    engine's 2,880 zero image rows."""
    t_phase = time.perf_counter()
    held = _release()
    cfg, model, params, info = _init_model("llava-next-34b")
    P = cfg.num_prefix_embeddings
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(32, 513, 12)]
    launches, counts, _, t, peak = _counted_serve(
        cfg, model, params, prompts, {"flash_attention": cfg.num_layers},
        VLM)

    # the first prompt after random image rows: every attention call held
    # to the plain version, the logits against the plain attention's, and
    # the faults those checks must see: a tile cut from every layer's
    # last row, and the first image row changed (the image reaches the
    # logits)
    prefix = _random_prefix(cfg, 1)
    batch = _batch(prompts[0], prefix)
    other = prefix.clone()
    other[:, 0] = _random_prefix(cfg, 2)[:, 0]
    rows = P + len(prompts[0])
    cuts = _window_cuts(rows)
    calls = _attn_call_readings(
        cfg, params, batch, VLM.cache_len,
        {"one_tile": cuts["one_tile"][0]})
    logit = _logit_readings(cfg, params, batch, VLM.cache_len,
                            {**cuts, "first_image_row": (
                                None, _batch(prompts[0], other))})
    emit({"phase": "serve_vlm_checks", "rtol": SERVE_LOGIT_RTOL,
          "attention_calls": calls, "logits": logit})
    _call_checks(cfg.name, calls, ["one_tile"])
    check(calls["calls"] == {f"causal, Sq {rows} over Skv {rows}":
                             cfg.num_layers},
          f"{cfg.name}: {calls['calls']} attention calls in a prefill")
    check(logit["finite"], f"{cfg.name} prefill logits not finite")
    check(logit["rel_l2"] <= SERVE_LOGIT_RTOL,
          f"{cfg.name} prefill logits, kernel vs plain attention: |diff| / "
          f"|plain| = {logit['rel_l2']} > {SERVE_LOGIT_RTOL}")
    for fault in ("one_tile", "first_image_row"):
        check(logit[f"fault_{fault}_rel_l2"] > SERVE_LOGIT_RTOL,
              f"planted fault '{fault}' passed the {cfg.name} logits check: "
              f"{logit[f'fault_{fault}_rel_l2']} <= {SERVE_LOGIT_RTOL}")

    attn_row["launches_serve_vlm"] = launches["flash_attention"]
    emit({"phase": "serve_vlm", **info, "image_rows": P,
          "allocated_before_gb": held / 1e9, "serve_peak_gb": peak / 1e9,
          **counts, "flash_attention_launches": launches["flash_attention"],
          **_serve_metrics(prompts, t, VLM, prefix_rows=P),
          "logits_kernel_vs_plain_rel_l2": logit["rel_l2"],
          "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "serve_vlm_profile", **_serve_profiles(
        model, params, prompts, VLM, torch.zeros_like(prefix))})


def _is_cross(q, k, causal):
    """A cross attention call: non-causal, its queries not its keys (Sq
    != Skv at these prompts; the encoder's calls are Sq = Skv)."""
    return not causal and q.shape[2] != k.shape[2]


def _one_frame_fewer(q, k, v, **kw):
    """A planted fault: the kernel with every cross attention reading
    one frame fewer."""
    from repro_torch.kernels.flash_attention import flash_attention
    if _is_cross(q, k, kw["causal"]):
        k, v = k[:, :, :-1], v[:, :, :-1]
    return flash_attention(q, k, v, **kw)


def _cross_skipped(q, k, v, **kw):
    """A planted fault: every cross attention's output zero, which is the
    block without its cross attention (the path a state without its
    encoder memory takes)."""
    from repro_torch.kernels.flash_attention import flash_attention
    if _is_cross(q, k, kw["causal"]):
        return torch.zeros_like(q)
    return flash_attention(q, k, v, **kw)


def phase_serve_audio(attn_row) -> None:
    """seamless-m4t-medium at full size through ServingEngine: 12
    requests of 2-16 tokens (a target-language tag, then text; numpy
    seed 0), each over the engine's 1,024 zero frames."""
    t_phase = time.perf_counter()
    held = _release()
    cfg, model, params, info = _init_model("seamless-m4t-medium")
    L, E, P = cfg.num_layers, cfg.num_encoder_layers, \
        cfg.num_prefix_embeddings
    rng = np.random.default_rng(0)
    # 4 tag ids at the vocabulary's end (the weights are random: any id
    # would do; the length and position are what the path sees)
    tags = cfg.vocab_size - 1 - np.arange(4)
    prompts = [[int(rng.choice(tags))] +
               rng.integers(0, cfg.vocab_size - 4, int(n) - 1).tolist()
               for n in rng.integers(2, 17, 12)]
    # a prefill: the encoder's self-attention, and the decoder's self and
    # cross attention, each layer; a decode step the decoder's two
    launches, counts, _, t, peak = _counted_serve(
        cfg, model, params, prompts, {"flash_attention": (E + 2 * L, 2 * L)},
        AUDIO)

    # the first prompt over random frames (the engine's zero frames make
    # a zero encoder memory, over which every cross attention gives 0):
    # every attention call held to the plain version, where one frame
    # fewer in every cross attention must fail; the logits against the
    # plain attention's, where the cross attention skipped must fail
    # (one frame of 1,024 moves them less than the bf16 roundings do:
    # the reading is recorded, PERF.md §6)
    batch = _batch(prompts[0], _random_prefix(cfg, 1))
    calls = _attn_call_readings(cfg, params, batch, AUDIO.cache_len,
                                {"cross_one_frame_fewer": _one_frame_fewer})
    logit = _logit_readings(cfg, params, batch, AUDIO.cache_len,
                            {"cross_one_frame_fewer": (_one_frame_fewer,
                                                       None),
                             "cross_skipped": (_cross_skipped, None)})
    emit({"phase": "serve_audio_checks", "rtol": SERVE_LOGIT_RTOL,
          "attention_calls": calls, "logits": logit})
    _call_checks(cfg.name, calls, ["cross_one_frame_fewer"])
    check(calls["calls"] == {
        f"non-causal, Sq {P} over Skv {P}": E,
        f"causal, Sq {len(prompts[0])} over Skv {len(prompts[0])}": L,
        f"non-causal, Sq {len(prompts[0])} over Skv {P}": L},
        f"{cfg.name}: {calls['calls']} attention calls in a prefill")
    check(logit["finite"], f"{cfg.name} prefill logits not finite")
    check(logit["rel_l2"] <= SERVE_LOGIT_RTOL,
          f"{cfg.name} prefill logits, kernel vs plain attention: |diff| / "
          f"|plain| = {logit['rel_l2']} > {SERVE_LOGIT_RTOL}")
    check(logit["fault_cross_skipped_rel_l2"] > SERVE_LOGIT_RTOL,
          f"planted fault 'cross_skipped' passed the {cfg.name} logits "
          f"check: {logit['fault_cross_skipped_rel_l2']} <= "
          f"{SERVE_LOGIT_RTOL}")

    attn_row["launches_serve_audio"] = launches["flash_attention"]
    emit({"phase": "serve_audio", **info, "encoder_layers": E,
          "frames": P,
          "allocated_before_gb": held / 1e9, "serve_peak_gb": peak / 1e9,
          **counts, "flash_attention_launches": launches["flash_attention"],
          **_serve_metrics(prompts, t, AUDIO),
          "logits_kernel_vs_plain_rel_l2": logit["rel_l2"],
          "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "serve_audio_profile", **_serve_profiles(
        model, params, prompts, AUDIO, torch.zeros_like(batch[
            "prefix_emb"]))})


# ---------------------------------------------------------------------------
# the zoo's configurations never served before, at full width: gemma2-2b
# (hd 256: the CUDA-core route; alternating 4,096-key local and global
# layers; softcaps), qwen1.5-4b (MHA with QKV bias) and qwen1.5-4b-swa
# on its weights, qwen2-7b-swa, mixtral-8x22b cut in depth; the windowed
# ones serve prompts past their 4,096-key window, so every ring wraps in
# the prefill's fill and again in decode
ZOO = Serving(max_batch=8, cache_len=8192, n_new=32)
ZOO_PROMPT_TOKENS = (4200, 6000)
# the decode steps of one request held to a prefill of its prompt and
# the tokens before each (CARRY_LOGIT_RTOL)
ZOO_DECODE_CHECKS = (0, 8, 15, 23, 31)
# mixtral-8x22b at 13 of its 56 layers: a layer holds 2,504,060,928
# weights (5.01 GB in bf16), the embedding, head and final norm
# 402,659,328 (0.81 GB), so the full depth's 140.6 B (281 GB) do not fit
# 80 GB; 13 layers hold 32,955,451,392 (65.91 GB) and leave room for the
# 8 slots' rings, a 6,000-token prefill's activations and the plain
# attention the checks run beside it (the phase peaked at 75.45 GB, in
# the weights' init, on an NVIDIA H100 80GB HBM3; 14 layers would add
# 5.01 GB)
MIXTRAL_LAYERS = 13
# gemma2's final softcap (30) made to bite: the checks read the logits
# of a copy of the weights whose final norm scale is this many times
# larger (random weights give logits of |x| < 5, which the cap leaves
# almost as they are)
SOFTCAP_PROBE_SCALE = 20.0


def _zoo_lengths(rng=None) -> list:
    """The zoo prompts' lengths: 12 of 4,200-6,000 tokens (numpy seed
    0, or ``rng``)."""
    rng = rng or np.random.default_rng(0)
    return [int(n) for n in rng.integers(ZOO_PROMPT_TOKENS[0],
                                         ZOO_PROMPT_TOKENS[1] + 1, 12)]


def _zoo_prompts(cfg):
    """12 prompts of 4,200-6,000 tokens (numpy seed 0), each past a
    4,096-key window."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in _zoo_lengths(rng)]


def _rings(state, cache_len):
    """Every windowed layer's cache in a decode state: the attention
    caches whose slots are fewer than ``cache_len`` (a ring of its
    window; every attention cache for ``math.inf``)."""
    found = []

    def walk(t):
        if isinstance(t, dict):
            if "pos" in t and "k" in t:
                if t["k"].shape[-3] < cache_len:
                    found.append(t)
                return
            for v in t.values():
                walk(v)
    walk(state["cache"])
    return found


def _stale_rings(state, cache_len):
    """A planted fault: every ring holding the positions of one ring
    earlier (a fill that kept the wrong ``size`` positions), so that no
    key it holds lies inside its window."""
    for c in _rings(state, cache_len):
        p = c["pos"]
        p[p >= 0] -= c["k"].shape[-3]


def _route_flips(dec, fwd) -> dict:
    """The MoE layers where a decode step's last token took other routes
    than the same token in a forward: ``dec`` and ``fwd`` are each
    layer's (router logits, picks) of that token.  A flip is a near-tie
    where the forward's logits of the experts that swapped lie closer
    than twice the largest logit drift between the two paths (the bf16
    activations of a one-row and a long GEMM round differently)."""
    flips = []
    for layer, ((l_d, i_d), (l_f, i_f)) in enumerate(zip(dec, fwd)):
        a = set(i_f.tolist()) - set(i_d.tolist())
        b = set(i_d.tolist()) - set(i_f.tolist())
        if not a:
            continue
        drift = float((l_d - l_f).abs().max())
        gap = max(abs(float(l_f[x] - l_f[y])) for x in a for y in b)
        flips.append({"layer": layer, "gap": gap, "drift": drift,
                      "near_tie": gap <= 2 * drift})
    return flips


def _decode_vs_forward(model, params, prompt, generated, cache_len,
                       fault=_stale_rings) -> dict:
    """One request's decode steps (its generated tokens fed one by one
    after a prefill of its prompt) against a prefill of the prompt and
    the tokens so far, |diff| over |plain| (L2 over the vocabulary) at
    ZOO_DECODE_CHECKS; then the same decode from the prefill's state
    edited by ``fault`` (state, cache_len) to the first of them.  In an
    MoE model each step also records its last token's routes in both
    paths: a step whose routes flipped at a near-tie (``_route_flips``)
    is reported, not held to the limit."""
    from repro_torch.kernels.moe_router import moe_router
    from repro_torch.models import build_model
    seen = []

    def recorded(logits, k):
        out = moe_router(logits, k)
        seen.append((logits[-1].float().clone(), out[1][-1].clone()))
        return out
    model = build_model(model.cfg, route=recorded)

    def decode(edit, last):
        out, routes = {}, {}
        with torch.no_grad():
            _, st = model.prefill(params, _batch(prompt),
                                  cache_len=cache_len)
            if edit is not None:
                edit(st, cache_len)
            for j in range(last + 1):
                seen.clear()
                logits, st = model.decode_step(params, st, torch.tensor(
                    [[generated[j]]], dtype=torch.int32, device=DEVICE))
                if j in ZOO_DECODE_CHECKS:
                    out[j], routes[j] = logits.flatten(), list(seen)
        return out, routes
    (got, dec_routes) = decode(None, max(ZOO_DECODE_CHECKS))
    bad = decode(fault, ZOO_DECODE_CHECKS[0])[0]    # off from its first step
    rel, top1, rel_bad, flips = [], [], [], {}
    for j in ZOO_DECODE_CHECKS:
        seen.clear()
        with torch.no_grad():
            want = model.prefill(params, _batch(prompt + generated[:j + 1]),
                                 cache_len=cache_len)[0].flatten()
        if seen:
            flips[j] = _route_flips(dec_routes[j], seen)
        rel.append(float((got[j] - want).norm() / want.norm()))
        if j in bad:
            rel_bad.append(float((bad[j] - want).norm() / want.norm()))
        top1.append(int(got[j].argmax()) == int(want.argmax()))
    return {"prompt_tokens": len(prompt), "steps": list(ZOO_DECODE_CHECKS),
            "logits_rel_l2": rel, "same_top1": top1,
            "route_flips": {j: f for j, f in flips.items() if f},
            "held": [r for j, r in zip(ZOO_DECODE_CHECKS, rel)
                     if not flips.get(j)],
            "fault": fault.__name__.strip("_"), "fault_logits_rel_l2": rel_bad}


def _softcap_readings(cfg, params, prompt) -> dict:
    """gemma2's final softcap: the prompt's last logits (prefill) and a
    decode step's, on a copy of the weights whose final norm scale is
    SOFTCAP_PROBE_SCALE larger, must stay within the cap while the same
    model without its cap (the planted fault) goes past it."""
    from repro_torch.models import build_model
    probe = dict(params)
    probe["final_norm"] = {k: v * SOFTCAP_PROBE_SCALE
                           for k, v in params["final_norm"].items()}
    out = {"cap": cfg.final_logit_softcap, "probe_scale":
           SOFTCAP_PROBE_SCALE}
    for name, c in (("kernel", cfg),
                    ("fault_cap_off", cfg.replace(final_logit_softcap=None))):
        model = build_model(c)
        with torch.no_grad():
            logits, st = model.prefill(probe, _batch(prompt),
                                       cache_len=ZOO.cache_len)
            step, _ = model.decode_step(probe, st, torch.tensor(
                [[1]], dtype=torch.int32, device=DEVICE))
        out[name] = {"prefill_max_abs": float(logits.abs().max()),
                     "decode_max_abs": float(step.abs().max())}
    return out


def _window_ignored(q, k, v, **kw):
    """A planted fault: the kernel with the layer's window left out."""
    from repro_torch.kernels.flash_attention import flash_attention
    return flash_attention(q, k, v, **{**kw, "window": None})


def _zoo_serve(cfg, model, params, info, prompts, run, per_layer,
               attn_row, routes=None) -> dict:
    """One configuration of the zoo through ServingEngine (launches
    counted, rerun bitwise) and its checks: the first prompt's logits
    against the plain attention's, which the one-tile window cut must
    fail on a full-attention model; on a windowed one (where a window 32
    keys short moves the last logits less than the bf16 roundings do:
    PERF.md) the window cuts and the window left out are read there, and
    every attention call of that prefill is held to the plain version
    (both window cuts must fail), decode against forward for that
    request (stale rings must fail), every prompt past the window;
    ``routes``: the MoE layers whose routes are held to the plain
    router.  Emits the serve_zoo lines; returns the launches."""
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    name = cfg.name
    # no rerun: the earlier serving phases show these kernels' serving
    # bitwise, and the zoo's time goes to its checks
    launches, counts, out, t, peak = _counted_serve(
        cfg, model, params, prompts, per_layer, run, rerun=False)
    n_attn = per_layer["flash_attention"]
    attn_row.setdefault("launches_serve_zoo", {})[name] = \
        launches["flash_attention"]
    windowed = cfg.window_size if cfg.attn_type in ("swa", "local_global") \
        else None
    batch = _batch(prompts[0])
    cuts = _window_cuts(len(prompts[0]))
    faults = {**cuts, "window_ignored": (_window_ignored, None)} \
        if windowed else cuts
    logit = _logit_readings(cfg, params, batch, run.cache_len, faults)
    line = {"phase": "serve_zoo_checks", "arch": name,
            "rtol": SERVE_LOGIT_RTOL, "logits": logit}
    if windowed:
        line["attention_calls"] = _attn_call_readings(
            cfg, params, batch, run.cache_len,
            {k: f for k, (f, _) in cuts.items()}, floor=True)
        # a capacity-routed MoE prefill drops routes a one-token decode
        # step keeps (mixtral at capacity factor 1.25 read 0.50-0.58):
        # held at a capacity factor of E / k, where no route is dropped
        moe = cfg.family == "moe"
        line["decode_vs_forward"] = _decode_vs_forward(
            build_model(cfg.replace(expert_capacity_factor=cfg.num_experts /
                                    cfg.num_experts_per_tok)) if moe
            else model, params, prompts[0], out[0], run.cache_len)
        line["decode_vs_forward"]["capacity_factor"] = \
            cfg.num_experts / cfg.num_experts_per_tok if moe else None
        line["carry_rtol"] = CARRY_LOGIT_RTOL
    if routes is not None:
        line["routes"] = _route_readings(cfg, params, prompts[0],
                                         run.cache_len)
    emit(line)
    check(logit["finite"], f"{name} prefill logits not finite")
    check(logit["rel_l2"] <= SERVE_LOGIT_RTOL,
          f"{name} prefill logits, kernel vs plain attention: |diff| / "
          f"|plain| = {logit['rel_l2']} > {SERVE_LOGIT_RTOL}")
    if not windowed:
        check(logit["fault_one_tile_rel_l2"] > SERVE_LOGIT_RTOL,
              f"planted fault (one 32-key tile cut) passed the {name} "
              f"logits check: {logit['fault_one_tile_rel_l2']} <= "
              f"{SERVE_LOGIT_RTOL}")
    else:
        check(min(map(len, prompts)) > windowed, f"{name}: a prompt within "
              f"the {windowed}-key window")
        calls, dvf = line["attention_calls"], line["decode_vs_forward"]
        _call_checks(name, calls, list(cuts))
        check(sum(calls["calls"].values()) == n_attn,
              f"{name}: {calls['calls']} attention calls in a prefill")
        check(dvf["held"] and max(dvf["held"]) <= CARRY_LOGIT_RTOL and all(
            f["near_tie"] for fl in dvf["route_flips"].values() for f in fl),
            f"{name} decode vs forward past the window: {dvf}")
        check(min(dvf["fault_logits_rel_l2"]) > CARRY_LOGIT_RTOL,
              f"planted fault (stale rings) passed the {name} decode vs "
              f"forward check: {dvf}")
    if routes is not None:
        _route_checks(name, line["routes"], routes)
    emit({"phase": "serve_zoo", **info, **counts,
          "serve_peak_gb": peak / 1e9,
          "launches": {k: v for k, v in launches.items() if v},
          "window": windowed, "ring_slots": windowed and min(
              windowed, run.cache_len),
          **_serve_metrics(prompts, t, run), "rerun_bitwise": None,
          "logits_kernel_vs_plain_rel_l2": logit["rel_l2"],
          "profile": _serve_profiles(model, params, prompts, run,
                                     rows=None),
          "phase_s": time.perf_counter() - t_phase})
    return launches


def _serve_cli(arch) -> dict:
    """python -m repro_torch.launch.serve --arch ``arch`` at its
    defaults, in this process (its main), with every count set to 0 just
    before and read just after: flash_attention once a layer a step."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out, wall, launches, _ = _counted(lambda: serve_main(["--arch",
                                                              arch]))
    layers = get_config(arch).num_layers
    check(launches == {"flash_attention": out.shape[0] * layers},
          f"serve CLI --arch {arch}: launches {launches} for {out.shape[0]} "
          f"steps of {layers} layers")
    check(bool(((out >= 0) & (out < get_config(arch).vocab_size)).all()),
          f"serve CLI --arch {arch}: tokens out of the vocabulary")
    return {"argv": ["--arch", arch], "steps": out.shape[0],
            "batch": out.shape[1], "wall_s": wall, "launches": launches,
            "printed": text.getvalue().splitlines()}


def phase_serve_zoo(attn_row, router_row, shapes) -> None:
    """Part of the zoo never served (module doc): gemma2-2b, qwen1.5-4b
    and qwen1.5-4b-swa on one tree, qwen2-7b-swa, mixtral-8x22b at
    MIXTRAL_LAYERS; the input shapes that reuse a served tree run
    between them (``shapes`` collects their lines)."""
    _release()
    cfg, model, params, info = _init_model("gemma2-2b")
    prompts = _zoo_prompts(cfg)
    _zoo_serve(cfg, model, params, info, prompts, ZOO,
               {"flash_attention": cfg.num_layers}, attn_row)
    cap = _softcap_readings(cfg, params, prompts[0])
    emit({"phase": "serve_zoo_softcap", "arch": cfg.name, **cap})
    for key in ("prefill_max_abs", "decode_max_abs"):
        check(cap["kernel"][key] <= cfg.final_logit_softcap,
              f"gemma2 logits past the final softcap: {cap}")
        check(cap["fault_cap_off"][key] > cfg.final_logit_softcap,
              f"planted fault (the final softcap off) passed the softcap "
              f"check: {cap}")
    cli = _serve_cli(cfg.name)
    attn_row["launches_serve_cli"] = cli["launches"].get("flash_attention")
    emit({"phase": "serve_zoo_cli", "arch": cfg.name, **cli})
    del model, params

    _release()
    cfg, model, params, info = _init_model("qwen1.5-4b")
    _zoo_serve(cfg, model, params, info, _prompts(cfg), TEXT,
               {"flash_attention": cfg.num_layers}, attn_row)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen1.5-4b-swa")
    model = build_model(cfg)
    _zoo_serve(cfg, model, params, {**info, "arch": cfg.name,
                                    "same_tree_as": "qwen1.5-4b"},
               _zoo_prompts(cfg), ZOO, {"flash_attention": cfg.num_layers},
               attn_row)
    shapes["long_500k qwen1.5-4b-swa"] = _shape_long_attn(
        cfg, model, params, attn_row)
    del model, params

    _release()
    cfg, model, params, info = _init_model("qwen2-7b-swa")
    _zoo_serve(cfg, model, params, info, _zoo_prompts(cfg), ZOO,
               {"flash_attention": cfg.num_layers}, attn_row)
    cfg = get_config("qwen2-7b")
    model = build_model(cfg)
    shapes.update(_shape_32k(cfg, model, params, attn_row))
    del model, params

    _release()
    cfg, model, params, info = _init_model("mixtral-8x22b", MIXTRAL_LAYERS)
    n_moe = sum(kind["ffn"] == "moe" for kind in model.kinds)
    check(n_moe == MIXTRAL_LAYERS, f"mixtral: {n_moe} MoE layers")
    launches = _zoo_serve(
        cfg, model, params, {**info, "cut": f"{MIXTRAL_LAYERS} of 56 layers "
                             "(140.6 B weights, 281 GB in bf16, at full "
                             "depth)"},
        _zoo_prompts(cfg), ZOO, {"flash_attention": cfg.num_layers,
                                 "moe_router": n_moe}, attn_row,
        routes=n_moe)
    router_row["launches_serve_zoo"] = launches["moe_router"]
    del model, params
    _release()


# ---------------------------------------------------------------------------
# the reference's INPUT_SHAPES on one card (configs/base.py): the batch
# one card holds
SHAPE_ROWS = 256               # query rows held to the plain version
SHAPE_DECODE_STEPS = 32
TRAIN_4K_BATCHES = (1, 2, 4, 8)
TRAIN_4K_PEAK = 72e9           # the largest batch whose peak stays under
TRAIN_4K_STEPS = 3
TRAIN_4K_SEQ = 4096
PREFILL_32K = (32_768, 32_800)  # prefill_32k's rows and cache slots
DECODE_32K_SLOTS = 8           # decode_32k's batch: 8 of the reference's 128
LONG_T = 524_288               # long_500k's positions
WINDOW_CHECK = 4096            # rwkv6's plain window (64 chunks)


def _tokens(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(
        DEVICE)


def _row_slices(S, window, rows=SHAPE_ROWS):
    """The first and last ``rows`` query rows of an S-row prefill, each
    with the first key its mask reaches: [(lo, hi, first key)]."""
    return [(lo, lo + rows, max(0, lo - window + 1) if window else 0)
            for lo in (0, S - rows)]


def _sliced_call_readings(cfg, params, batch, cache_len) -> dict:
    """A prefill with every attention call's kernel output held to the
    plain version on its first and last SHAPE_ROWS query rows (the
    plain version of the whole call does not fit the card), each slice
    with the keys its mask reaches and their positions, within a limit
    that adds the slice's float32 floor (the plain version in float32
    against float64; ``attn_excess``); the one-tile cut (``_window_cuts``:
    the window, or the rows, less 32) read the same way, by the kernel
    on the slice."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    kern, fault, floors = [], [], []

    def checked(q, k, v, **kw):
        out = flash_attention(q, k, v, **kw)
        S, w = q.shape[2], kw["window"]
        for lo, hi, k_lo in _row_slices(S, w):
            o = {**kw, "q_pos": torch.arange(lo, hi, dtype=torch.int32,
                                             device=q.device),
                 "k_pos": torch.arange(k_lo, hi, dtype=torch.int32,
                                       device=q.device)}
            qs, ks, vs = q[:, :, lo:hi], k[:, :, k_lo:hi], v[:, :, k_lo:hi]
            want = _plain_by_kv_head(qs.float(), ks.float(), vs.float(), **o)
            wide = _plain_by_kv_head(qs.double(), ks.double(), vs.double(),
                                     **o)
            fl = float((want.double() - wide).abs().max())
            floors.append(fl)
            kern.append(attn_excess(out[:, :, lo:hi], want, fl))
            fault.append(attn_excess(flash_attention(
                qs, ks, vs, **{**o, "window": (w or S) - 32}), want, fl))
        return out

    with torch.no_grad():
        build_model(cfg, attend=checked).prefill(params, batch,
                                                 cache_len=cache_len)
    return {"rows": SHAPE_ROWS, "slices": len(kern),
            "floor_max": max(floors), "floor_factor": ATTN_FLOOR_FACTOR,
            "kernel": {"max_excess": max(kern),
                       "over_limit": sum(e > 1.0 for e in kern)},
            "one_tile": {"max_excess": max(fault),
                         "over_limit": sum(e > 1.0 for e in fault)}}


def _sliced_checks(name, calls, layers) -> None:
    check(calls["slices"] == 2 * layers, f"{name}: {calls['slices']} row "
          f"slices for {layers} layers")
    check(calls["kernel"]["max_excess"] <= 1.0, f"{name} attention rows, "
          f"kernel vs plain: {calls['kernel']}")
    check(calls["one_tile"]["max_excess"] > 1.0, f"planted fault (one "
          f"32-key tile cut) passed the {name} row check: {calls}")


def _counted(fn):
    """``fn()`` with every launch count set to 0 just before and read
    just after, timed on the host (ending in a synchronize), with the
    peak device memory: (result, seconds, launches, peak bytes)."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        {k: w.launches for k, w in wrappers.items() if w.launches}, \
        torch.cuda.max_memory_allocated()


def _decode_steps(model, params, state, first, steps):
    """``steps`` greedy steps of launch.serve's step function from
    ``state`` and the first tokens [B, 1]; returns the tokens."""
    from repro_torch.launch.serve import make_serve_step
    step = make_serve_step(model)
    toks, out = first, []
    with torch.no_grad():
        for _ in range(steps):
            toks, state = step(params, state, toks)
            out.append(toks)
    return torch.cat(out, 1)


def _shape_long_attn(cfg, model, params, attn_row) -> dict:
    """long_500k on a windowed attention model: a 524,288-token prefill
    at B = 1 (the key loop stops at the window: every row reads 4,096
    keys), then SHAPE_DECODE_STEPS decode steps; the rings hold the
    last 4,096 positions; the attention rows held to the plain version
    on slices, with the one-tile cut."""
    L, S, w = cfg.num_layers, LONG_T, cfg.window_size
    toks = _tokens(cfg, S)
    cache_len = S + SHAPE_DECODE_STEPS

    def run():
        with torch.no_grad():
            logits, st = model.prefill(params, {"tokens": toks},
                                       cache_len=cache_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen = _decode_steps(model, params, st, logits[:, -1:].argmax(-1).to(
            torch.int32), SHAPE_DECODE_STEPS)
        torch.cuda.synchronize()
        return logits, st, gen, time.perf_counter() - t1
    (logits, st, gen, decode_s), wall, launches, peak = _counted(run)
    check(launches == {"flash_attention": L * (1 + SHAPE_DECODE_STEPS)},
          f"long_500k {cfg.name}: launches {launches}")
    check(bool(torch.isfinite(logits).all()), f"long_500k {cfg.name}: "
          "logits not finite")
    rings = _rings(st, cache_len)
    end = S + SHAPE_DECODE_STEPS - 1
    want = torch.arange(end - w + 1, end + 1, dtype=torch.int32,
                        device=DEVICE)
    check(len(rings) == 1 and all(
        torch.equal(p.sort().values, want)
        for p in rings[0]["pos"].reshape(-1, w)),
        f"long_500k {cfg.name}: the rings do not hold positions "
        f"{end - w + 1}-{end}")
    del st
    _release()
    calls = _sliced_call_readings(cfg, params, {"tokens": toks}, cache_len)
    _sliced_checks(f"long_500k {cfg.name}", calls, L)

    # one layer's windowed call timed alone: its key loop stops at the
    # window, so it must run well under the bound of the causal call
    # without a window (64 times the pairs)
    g = torch.Generator(DEVICE).manual_seed(5)
    q, k, v = (torch.randn(1, S, n, cfg.head_dim, generator=g, device=DEVICE,
                           dtype=torch.bfloat16).transpose(1, 2)
               for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    times = _attn_times(q, k, v, {"window": w}, None, calls=1, replays=1,
                        eager=False)
    meta_q, meta_k = (torch.empty(t.shape, dtype=t.dtype, device="meta")
                      for t in (q, k))
    full_flops, _ = W.attention_work(meta_q, meta_k, True, None, None, None)
    unwindowed_ms = full_flops / BF16_FLOP_PER_S * 1e3
    check(times["ms"] < unwindowed_ms / 4, f"long_500k {cfg.name}: the "
          f"windowed call took {times['ms']} ms, the unwindowed one's "
          f"bound is {unwindowed_ms} ms: the key loop did not stop at "
          "the window")
    del q, k, v
    attn_row.setdefault("shapes", {})[f"long_500k {cfg.name} prefill"] = {
        k_: times[k_] for k_ in ("ms", "bound_ms", "bound_by", "library_ms",
                                 "plain_ms", "tflops_per_s")}
    line = {"phase": "shape", "shape": "long_500k", "arch": cfg.name,
            "batch": 1, "seq": S, "window": w, "cache_len": cache_len,
            "launches": launches, "peak_gb": peak / 1e9,
            "prefill_s": wall - decode_s,
            "prefill_tokens_per_s": S / (wall - decode_s),
            "decode_steps": SHAPE_DECODE_STEPS,
            "decode_tokens_per_s": SHAPE_DECODE_STEPS / decode_s,
            "ring_positions": [end - w + 1, end], "attention_rows": calls,
            "attention_call": {**times,
                               "unwindowed_bound_ms": unwindowed_ms}}
    emit(line)
    return line


def _shape_32k(cfg, model, params, attn_row) -> dict:
    """prefill_32k (B = 1, S = 32,768 into a cache of 32,800) and
    decode_32k (that cache spliced into 8 slots, SHAPE_DECODE_STEPS
    steps) on a full-attention model."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    L, B = cfg.num_layers, DECODE_32K_SLOTS
    S, cache_len = PREFILL_32K
    toks = _tokens(cfg, S)

    def prefill():
        with torch.no_grad():
            return model.prefill(params, {"tokens": toks},
                                 cache_len=cache_len)
    (logits, st), wall, launches, peak = _counted(prefill)
    check(launches == {"flash_attention": L}, f"prefill_32k: {launches}")
    check(bool(torch.isfinite(logits).all()), "prefill_32k: logits not "
          "finite")
    calls = _sliced_call_readings(cfg, params, {"tokens": toks}, cache_len)
    # one layer's call timed alone (its plain version does not fit the
    # card: 30 GB of float32 scores a kv head)
    g = torch.Generator(DEVICE).manual_seed(7)
    q, k, v = (torch.randn(1, S, n, cfg.head_dim, generator=g, device=DEVICE,
                           dtype=torch.bfloat16).transpose(1, 2)
               for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    ptimes = _attn_times(q, k, v, {}, None, calls=2, replays=1, eager=False)
    del q, k, v
    attn_row.setdefault("shapes", {})["prefill_32k wgmma"] = {
        k_: ptimes[k_] for k_ in ("ms", "bound_ms", "bound_by", "library_ms",
                                  "plain_ms", "tflops_per_s")}
    out = {"prefill_32k": {
        "phase": "shape", "shape": "prefill_32k", "arch": cfg.name,
        "batch": 1, "seq": S, "cache_len": cache_len, "launches": launches,
        "peak_gb": peak / 1e9, "prefill_s": wall,
        "prefill_tokens_per_s": S / wall, "attention_rows": calls,
        "attention_call": ptimes}}
    emit(out["prefill_32k"])
    _sliced_checks("prefill_32k", calls, L)

    # decode_32k: 8 slots of the prefill's cache, each with its own first
    # token (slot 0 the prefill's greedy pick)
    engine = ServingEngine(model, params, max_batch=B, cache_len=cache_len)
    first = torch.cat([logits[0, -1:].argmax(-1).cpu(), torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, B - 1))])

    def splice():
        for i in range(B):
            engine._insert_state(i, st, int(first[i]))
    splice()
    toks0 = engine._last_tok.to(DEVICE)
    # one checked step: each layer's split-K call held to the plain
    # version over the 32,768 slots, a dropped 32-slot tile as the
    # planted fault; its logits against a 32,769-row prefill, a cache
    # not spliced (every slot unwritten) as the planted fault
    readings = {"kernel": [], "tile_dropped": [], "floor": []}

    def checked(q, k, v, **kw):
        out_ = flash_attention(q, k, v, **kw)
        want = _plain_by_kv_head(q.float(), k.float(), v.float(), **kw)
        fl = _plain_floor(q, k, v, kw)
        readings["floor"].append(fl)
        readings["kernel"].append(attn_excess(out_, want, fl))
        kp = kw["k_pos"].clone()
        kp[:, S // 2:S // 2 + 32] = -1     # live in every row
        readings["tile_dropped"].append(attn_excess(
            flash_attention(q, k, v, **{**kw, "k_pos": kp}), want, fl))
        return out_
    with torch.no_grad():
        step_logits, _ = build_model(cfg, attend=checked).decode_step(
            params, engine.state, toks0)
        splice()
        for c in _rings(engine.state, math.inf):
            c["pos"].fill_(-1)
        bad_logits, _ = model.decode_step(params, engine.state, toks0)
        splice()
    del st
    _, wall_d, launches_d, peak_d = _counted(lambda: _decode_steps(
        model, params, engine.state, toks0, SHAPE_DECODE_STEPS))
    check(launches_d == {"flash_attention": L * SHAPE_DECODE_STEPS},
          f"decode_32k: {launches_d}")
    # the split-K call timed on layer 0's cache after the steps
    layer0 = _rings(engine.state, math.inf)[0]
    kpos = layer0["pos"][0]
    gen_ = torch.Generator().manual_seed(6)
    q = torch.randn(B, cfg.num_heads, 1, cfg.head_dim, generator=gen_).to(
        DEVICE, layer0["k"].dtype)
    k_c, v_c = (layer0[x][0].transpose(1, 2) for x in ("k", "v"))
    opts = {"q_pos": (kpos.max(1).values + 1)[:, None].to(torch.int32),
            "k_pos": kpos}
    want = _plain_by_kv_head(q.float(), k_c.float(), v_c.float(), **opts)
    times = _attn_times(q, k_c, v_c, opts, want, calls=20)
    attn_row.setdefault("shapes", {})["decode_32k split-K"] = {
        k_: times[k_] for k_ in ("ms", "bound_ms", "bound_by", "library_ms",
                                 "plain_ms", "gb_per_s")}
    del engine
    _release()
    with torch.no_grad():
        want_logits = model.prefill(params, {"tokens": torch.cat(
            [toks, toks0[:1]], 1)}, cache_len=cache_len)[0].flatten()

    def rel(x):
        return float((x.flatten() - want_logits).norm() / want_logits.norm())
    dvf = {"rows": S + 1, "logits_rel_l2": rel(step_logits[0]),
           "same_top1": int(step_logits[0].argmax()) ==
           int(want_logits.argmax()),
           "fault_cache_not_spliced_rel_l2": rel(bad_logits[0])}
    check(max(readings["kernel"]) <= 1.0, f"decode_32k attention, kernel "
          f"vs plain: {max(readings['kernel'])}")
    check(min(readings["tile_dropped"]) > 1.0, f"planted fault (a 32-slot "
          f"tile dropped) passed the decode_32k check: "
          f"{min(readings['tile_dropped'])}")
    check(dvf["logits_rel_l2"] <= CARRY_LOGIT_RTOL, f"decode_32k decode vs "
          f"forward: {dvf}")
    check(dvf["fault_cache_not_spliced_rel_l2"] > CARRY_LOGIT_RTOL,
          f"planted fault (the cache not spliced) passed the decode_32k "
          f"decode vs forward check: {dvf}")
    out["decode_32k"] = {
        "phase": "shape", "shape": "decode_32k", "arch": cfg.name,
        "batch": B, "slots": cache_len, "steps": SHAPE_DECODE_STEPS,
        "launches": launches_d, "peak_gb": peak_d / 1e9,
        "decode_s": wall_d,
        "decode_tokens_per_s": B * SHAPE_DECODE_STEPS / wall_d,
        "step_ms": wall_d / SHAPE_DECODE_STEPS * 1e3,
        "attention": {"calls": len(readings["kernel"]),
                      "floor_max": max(readings["floor"]),
                      "max_excess": max(readings["kernel"]),
                      "fault_tile_dropped_min_excess":
                          min(readings["tile_dropped"])},
        "decode_vs_forward": dvf, "split_k": times}
    emit(out["decode_32k"])
    return out


class _Captured(Exception):
    """Raised by a hook to stop a forward once it holds its inputs."""


def _first_call_inputs(cfg, params, batch, hook):
    """The arguments of the first call of the model's ``hook`` in a
    prefill of ``batch``; the prefill stops there."""
    from repro_torch.models import build_model
    got = []

    def capture(*args, **kw):
        got.extend(args)
        raise _Captured
    try:
        with torch.no_grad():
            build_model(cfg, **{hook: capture}).prefill(params, batch)
    except _Captured:
        pass
    return got


def _shape_long_rwkv(rwkv_row) -> dict:
    """long_500k on rwkv6-1.6b: a 524,288-token prefill at B = 1 (the
    chunked route: 8,192 chunks of 64, a 4.3 GB float32 buffer of chunk
    states), then SHAPE_DECODE_STEPS decode steps; layer 0's scan held
    to the sequential kernel on the same inputs (output and state) and,
    on the last WINDOW_CHECK steps from the chunked route's state at that
    chunk boundary, to the plain version, where the same steps from a
    dropped (zero) state must fail; both routes timed on those inputs."""
    from repro_torch.kernels.rwkv6_scan import ops, rwkv6_scan_ref
    cfg, model, params, info = _init_model("rwkv6-1.6b")
    L, S = cfg.num_layers, LONG_T
    toks = _tokens(cfg, S)

    def run():
        with torch.no_grad():
            logits, st = model.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _decode_steps(model, params, st, logits[:, -1:].argmax(-1).to(
            torch.int32), SHAPE_DECODE_STEPS)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t1
    (logits, decode_s), wall, launches, peak = _counted(run)
    check(launches == {"rwkv6_scan": L * (1 + SHAPE_DECODE_STEPS)},
          f"long_500k rwkv6: launches {launches}")
    check(bool(torch.isfinite(logits).all()), "long_500k rwkv6: logits "
          "not finite")
    _release()

    r, k, v, w, u = _first_call_inputs(cfg, params, {"tokens": toks},
                                       "wkv")[:5]
    del model, params
    _release()
    with torch.no_grad():
        full = ops._launch("chunked", r, k, v, w, u, None, None)
        seq = ops._launch("sequential", r, k, v, w, u, None, None)
        vs_seq = _scan_reading(full, (seq[0].float(), seq[1]))
        del seq
        t0 = S - WINDOW_CHECK
        tail = [t[:, t0:] for t in (r, k, v, w)]
        _, s0 = ops._launch("chunked", *(t[:, :t0] for t in (r, k, v, w)),
                            u, None, None)
        plain = rwkv6_scan_ref(*tail, u, s0)
        window = _scan_reading((full[0][:, t0:], full[1]), plain)
        dropped = _scan_reading(ops._launch("chunked", *tail, u, None, None),
                                plain)
        del full, plain
    emit({"phase": "shape_rwkv_checks", "steps": S, "window": WINDOW_CHECK,
          "chunked_vs_sequential": vs_seq, "window_vs_plain": window,
          "fault_state_dropped": dropped})
    check(_scan_ok(vs_seq), f"long_500k rwkv6: chunked vs sequential "
          f"kernel over {S} steps: {vs_seq}")
    check(_scan_ok(window), f"long_500k rwkv6: the last {WINDOW_CHECK} "
          f"steps vs the plain version: {window}")
    check(not _scan_ok(dropped), f"planted fault (the chunk state dropped) "
          f"passed the long_500k rwkv6 check: {dropped}")
    nbytes, flops = W.rwkv6_scan_work(r, u, False)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    times = {"ms": device_ms(lambda: ops._launch(
                 "chunked", r, k, v, w, u, None, None), calls=2, replays=1),
             "sequential_ms": device_ms(lambda: ops._launch(
                 "sequential", r, k, v, w, u, None, None), calls=1,
                 replays=1),
             "plain_ms": None, "library_ms": None,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "flops": flops}
    del r, k, v, w
    rwkv_row.setdefault("shapes", {})["long_500k prefill"] = times
    line = {"phase": "shape", "shape": "long_500k", "arch": cfg.name,
            "batch": 1, "seq": S, "launches": launches,
            "peak_gb": peak / 1e9, "prefill_s": wall - decode_s,
            "prefill_tokens_per_s": S / (wall - decode_s),
            "decode_steps": SHAPE_DECODE_STEPS,
            "decode_tokens_per_s": SHAPE_DECODE_STEPS / decode_s,
            "scan_times": times}
    emit(line)
    return line


def _shape_train_4k(attn_row) -> dict:
    """train_4k on qwen1.5-0.5b: make_train_step at S = 4,096 and the
    largest batch of TRAIN_4K_BATCHES whose predicted peak stays under
    TRAIN_4K_PEAK: the dry run's resident bytes (weights, Adam moments,
    batch) plus, a sample, the measured peak of a B = 1 step over its
    resident bytes; TRAIN_4K_STEPS steps run twice from the same
    weights, bitwise; the first loss against the plain attention's."""
    from repro_torch.configs import InputShape
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adam, linear_warmup_cosine
    S = TRAIN_4K_SEQ
    resident = {B: run_one(TRAIN_ARCH, InputShape("train_4k", S, B, "train"),
                           clients=1)["resident"]["total"]
                for B in TRAIN_4K_BATCHES}
    _release()
    cfg, model, params, info = _init_model(TRAIN_ARCH)
    opt = adam(linear_warmup_cosine(3e-4, 10, LEARN_STEPS), per_client=False)
    step = make_train_step(model, opt)

    p, s = _clone(params), opt.init(params)
    b1 = _lm_batch(cfg, 1, S, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(p, s, 0, b1)
    torch.cuda.synchronize()
    sample = torch.cuda.max_memory_allocated() - resident[1]
    del p, s, b1
    _release()
    predicted = {B: resident[B] + B * sample for B in TRAIN_4K_BATCHES}
    fits = [B for B in TRAIN_4K_BATCHES if predicted[B] < TRAIN_4K_PEAK]
    check(fits, f"train_4k: no batch fits {TRAIN_4K_PEAK / 1e9} GB: "
          f"{predicted}")
    B = max(fits)
    batches = [_lm_batch(cfg, B, S, seed=i) for i in range(TRAIN_4K_STEPS)]
    with torch.no_grad():
        plain_loss = float(build_model(cfg, attend=flash_attention_ref).loss(
            params, batches[0])[0])
    runs = []
    for _ in range(2):
        p, s = _clone(params), opt.init(params)

        def steps():
            nonlocal p, s
            out = []
            for i, b in enumerate(batches):
                p, s, _, m = step(p, s, i, b)
                out.append(m["loss"])
            return torch.stack(out)
        losses, wall, launches, peak = _counted(steps)
        runs.append({"params": p, "losses": losses, "wall": wall,
                     "launches": launches, "peak": peak})
        del p, s
    same = _same(runs[0]["params"], runs[1]["params"]) and torch.equal(
        runs[0]["losses"], runs[1]["losses"])
    losses = runs[0]["losses"].tolist()
    want = {"flash_attention": TRAIN_4K_STEPS * cfg.num_layers *
            (2 if cfg.remat else 1)}
    line = {"phase": "shape", "shape": "train_4k", "arch": cfg.name,
            "batch": B, "seq": S, "steps": TRAIN_4K_STEPS,
            "resident_gb": {b: r / 1e9 for b, r in resident.items()},
            "sample_gb": sample / 1e9,
            "predicted_peak_gb": {b: x / 1e9 for b, x in predicted.items()},
            "peak_gb": runs[0]["peak"] / 1e9, "losses": losses,
            "plain_attention_first_loss": plain_loss,
            "rerun_bitwise": same, "launches": runs[0]["launches"],
            "steps_per_s": TRAIN_4K_STEPS / runs[1]["wall"],
            "tokens_per_s": TRAIN_4K_STEPS * B * S / runs[1]["wall"],
            "step_ms": runs[1]["wall"] / TRAIN_4K_STEPS * 1e3}
    emit(line)
    check(runs[0]["launches"] == want, f"train_4k: launches "
          f"{runs[0]['launches']}, expected {want}")
    check(all(math.isfinite(x) for x in losses), f"train_4k losses {losses}")
    check(abs(losses[0] - plain_loss) <= TRAIN_LOSS_RTOL * abs(plain_loss),
          f"train_4k: first loss {losses[0]} against the plain attention's "
          f"{plain_loss}")
    check(same, "train_4k: the rerun is not bitwise")
    check(runs[0]["peak"] < TRAIN_4K_PEAK, f"train_4k at B = {B}: peak "
          f"{runs[0]['peak'] / 1e9} GB, predicted {predicted[B] / 1e9}")
    attn_row["launches_train_4k"] = runs[0]["launches"].get("flash_attention")
    return line


def phase_shapes(attn_row, rwkv_row, shapes) -> None:
    """The input shapes that need a tree of their own (long_500k on
    rwkv6-1.6b, train_4k); the others ran in serve_zoo.  Emits the
    shapes' summary."""
    t_phase = time.perf_counter()
    shapes["long_500k rwkv6-1.6b"] = _shape_long_rwkv(rwkv_row)
    _release()
    shapes["train_4k"] = _shape_train_4k(attn_row)
    _release()
    emit({"phase": "shapes", "shapes": sorted(shapes),
          "phase_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# the examples' twins (src/repro_torch/examples) at their smoke sizes
EXAMPLES = (("quickstart", ()), ("federated_training", ("--smoke",)),
            ("serving", ("--smoke",)), ("staleness_sweep", ()),
            ("wire_tradeoff", ("--smoke",)), ("quickstart_lm", ()),
            ("train_lm_e2e", ()))
EXAMPLES_CKPT = ROOT / "build" / "chip_smoke_examples"


def _n_batches(spec) -> int:
    """A spec's batches an epoch (its federation's, on the CPU)."""
    from repro_torch.api import build
    return build(spec.replace(seeds=spec.seeds[:1]),
                 device="cpu").federation.n_batches


def _example_launches(name, out) -> dict:
    """The launches each twin's run implies: vfl_matmul once a training
    step (a lane-batched one in a grid or a multi-seed cell), once an
    evaluation (each round's, where the spec evaluates, and the final
    one; a grid's and a cell's one) and once a serving step or predict
    call; flash_attention once a layer a forward (no remat: the
    backwards launch nothing) and a decode step."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.examples import train_lm_e2e

    def steps(spec):
        return spec.rounds * spec.epochs * _n_batches(spec)
    if name in ("quickstart", "serving"):
        rr = out if name == "quickstart" else out["result"]
        n = steps(rr.spec) + len(rr.history) + 1
        if name == "serving":
            n += out["waves"][-1].counters["steps"] + 1
        return {"vfl_matmul": n}
    if name == "federated_training":
        return {"vfl_matmul": sum(steps(rr.spec) + 1 for rr in out.values())}
    if name in ("staleness_sweep", "wire_tradeoff"):
        return {"vfl_matmul": steps(out["specs"][0]) + 1}
    if name == "quickstart_lm":
        layers = reduced_config("qwen1.5-0.5b").num_layers
        return {"flash_attention": layers * (len(out["losses"]) +
                                             len(out["decoded"]))}
    layers = train_lm_e2e.PRESETS["20m"]["num_layers"]
    return {"flash_attention": layers * len(out["losses"])}


def phase_examples(kernel_row, attn_row) -> None:
    """Each twin's main at its smoke size on the card, its printed lines
    kept, with every count set to 0 just before and read just after,
    held to the launches its run implies."""
    import contextlib
    import importlib
    import io
    import shutil
    shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    t_phase = time.perf_counter()
    rows = {}
    for name, argv in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        if name == "train_lm_e2e":
            argv = argv + ("--ckpt-dir", str(EXAMPLES_CKPT))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out, wall, launches, _ = _counted(lambda: mod.main(list(argv)))
        want = _example_launches(name, out)
        rows[name] = {"argv": list(argv), "wall_s": wall,
                      "launches": launches, "expected": want,
                      "printed": text.getvalue().splitlines()}
        check(launches == want, f"example {name}: launches {launches}, "
              f"expected {want}")
    shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    kernel_row["launches_examples"] = {
        k: r["launches"].get("vfl_matmul") for k, r in rows.items()
        if "vfl_matmul" in r["launches"]}
    attn_row["launches_examples"] = {
        k: r["launches"].get("flash_attention") for k, r in rows.items()
        if "flash_attention" in r["launches"]}
    emit({"phase": "examples", "examples": rows,
          "phase_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# LM training: qwen1.5-0.5b at full width and depth through the reference
# CLI's entry point and flags (repro/launch/train.py: batch 8, seq 256, lr
# 3e-4 with 10 warmup steps), and one forward and backward of each other
# family's kernels at full width
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ = 8, 256
# the learning check: the CLI's --vocab knob at 512, its default 50 steps
# at its default lr 3e-4; the final loss at least 0.5 below the first
# (tests/test_system.py::test_lm_training_learns)
LEARN_VOCAB, LEARN_STEPS, LEARN_DROP = 512, 50, 0.5
TRAIN_TIMED_STEPS = 10
# a loss through the kernels against the same through the plain version:
# bf16 activations rounded in another order, 1% relative
TRAIN_LOSS_RTOL = 0.01
# a gradient leaf through the kernels against the same leaf through the
# plain hook, relative L2, held to the floor that rounding alone sets in
# the same run: the same leaf through the plain function computed in
# float64 (its outputs cast back), a second correct version.  The model
# rounds every activation to bf16, and an output that lands on the other
# side of a rounding, however small its change, moves the backward of
# every layer below; a leaf whose gradient is a sum of many cancelling
# terms (rwkv6's bonus) reads large in both.  A correct kernel reads
# about its floor (0.95-1.1x in the first chip runs); a leaf's limit is
# GRAD_FLOOR_FACTOR x its floor, and at least GRAD_RTOL_MIN (about 9x
# one bf16 rounding of a gradient, 2^-9 / sqrt(3) in L2).  A detached
# kernel output reads 1.0 on every leaf that feeds the kernel; a planted
# fault fails where any leaf exceeds its limit
GRAD_FLOOR_FACTOR = 3
GRAD_RTOL_MIN = 0.01
# (arch, layers, batch, seq, the hook the check swaps, kernel calls a
# forward, planted faults, the model's dtype (None: its config's), the
# leaves each planted fault must exceed on their own): full width, depth
# cut to the layers that hold the family's kernels.  In a bf16 model
# rounding alone puts rwkv6's bonus leaf at a floor of 0.757 (a limit
# of 2.27, above the detached output's 1.0) and seamless's leaves at
# 0.0623; the float32 cases, at the same layers and batch, hold the
# fault to the bonus leaf's own limit and to the cross attention's
# input projections' (the leaves whose gradient runs through the
# kernel's output)
GRAD_FAMILIES = (
    ("deepseek-moe-16b", 2, 8, 256, "route", {"flash_attention": 2,
                                              "moe_router": 1},
     ("router_weights_detached",), None, ()),
    ("rwkv6-1.6b", 2, 8, 256, "wkv", {"rwkv6_scan": 2},
     ("scan_output_detached",), None, ()),
    ("jamba-v0.1-52b", 2, 2, 256, "sscan", {"mamba_scan_fused": 2,
                                            "moe_router": 1},
     ("scan_output_detached",), None, ()),
    ("seamless-m4t-medium", None, 2, 64, "attend", {"flash_attention": 36},
     ("attention_detached",), None, ()),
    ("rwkv6-1.6b", 2, 8, 256, "wkv", {"rwkv6_scan": 2},
     ("scan_output_detached",), "float32", ("rwkv/bonus",)),
    ("seamless-m4t-medium", None, 2, 64, "attend", {"flash_attention": 36},
     ("attention_detached",), "float32",
     ("cross/wq/", "cross/wk/", "cross/wv/")))


def _plain_hook(hook):
    from repro_torch.kernels import (
        flash_attention_ref, mamba_scan_fused_ref, moe_router_ref,
        rwkv6_scan_ref)
    return {"attend": flash_attention_ref, "route": moe_router_ref,
            "wkv": rwkv6_scan_ref, "sscan": mamba_scan_fused_ref}[hook]


def _float64_hook(hook):
    """The plain version of ``hook`` computed in float64, its floating
    outputs cast back to the dtypes the plain version gives (module
    constants: the gradient check's floor)."""
    plain = _plain_hook(hook)

    def run(*args, **kw):
        out = plain(*(a.double() if isinstance(a, torch.Tensor)
                      and a.is_floating_point() else a for a in args), **kw)
        if isinstance(out, tuple):
            return tuple(o.float() if o.is_floating_point() else o
                         for o in out)
        return out.to(args[0].dtype)
    return run


def _detached(hook):
    """A planted fault: the kernel on detached inputs, so its output has
    no gradient (what every kernel gave before the Functions)."""
    from repro_torch.kernels import (
        flash_attention, mamba_scan_fused, moe_router, rwkv6_scan)
    fn = {"attend": flash_attention, "route": moe_router,
          "wkv": rwkv6_scan, "sscan": mamba_scan_fused}[hook]

    def run(*args, **kw):
        return fn(*(a.detach() if isinstance(a, torch.Tensor) else a
                    for a in args), **kw)
    return run


def _wrong_mask_backward(q, k, v, **kw):
    """A planted fault: the kernel's forward, its backward recomputed
    with the causal mask flipped."""
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops

    class Flipped(ops.FlashAttentionFunction):
        @staticmethod
        def plain(q, k, v, **o):
            return flash_attention_ref(q, k, v,
                                       **{**o, "causal": not o["causal"]})
    return Flipped.apply(q, k, v, kw["causal"], kw["window"], kw["softcap"],
                         kw["scale"], kw["q_pos"], kw["k_pos"])


def _lm_batch(cfg, B, S, seed, prefix=False) -> dict:
    """A next-token batch of the Markov stream (numpy seed) on the card,
    and random frames as ``prefix_emb`` where asked."""
    from repro_torch.data import markov_lm_batches
    b = next(markov_lm_batches(cfg.vocab_size, B, S, seed=seed))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
    if prefix:
        batch["prefix_emb"] = _random_prefix(cfg, seed).expand(
            B, -1, -1).contiguous()
    return batch


def _grads(cfg, params, batch, hooks, clients=1):
    """(loss, gradient leaves, launches) of one forward and backward of
    ``Model.loss`` with ``hooks`` (and ``clients`` in the input block),
    every count set to 0 just before."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map
    wrappers = _wrappers()
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    for fn in wrappers.values():
        fn.launches = 0
    loss, _ = build_model(cfg, clients=clients, **hooks).loss(live, batch)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, leaves)], \
        {name: fn.launches for name, fn in wrappers.items()}


def _leaf_paths(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _grad_rel(got, plain) -> list:
    """Per leaf ||got - plain|| / ||plain|| in float32."""
    out = []
    for a, b in zip(got, plain):
        nb = float(b.float().norm())
        d = float((a.float() - b.float()).norm())
        out.append(d / nb if nb > 0 else (0.0 if d == 0 else math.inf))
    return out


def _grad_check(name, cfg, params, batch, hook, calls, faults,
                watch=()) -> dict:
    """One forward and backward through the kernels against the same
    through the plain ``hook`` (the other kernels in both), leaf by leaf,
    each leaf within its limit (module constants); each planted fault
    (name -> hooks) must exceed some leaf's limit, and the limit of
    every leaf whose path holds a string of ``watch`` (their readings
    are recorded); the kernel run's launches must be ``calls`` (a
    forward) x 2 with remat (the recompute runs the forward again; the
    backwards launch nothing)."""
    plain_loss, plain, _ = _grads(cfg, params, batch,
                                  {hook: _plain_hook(hook)})
    _, wide, _ = _grads(cfg, params, batch, {hook: _float64_hook(hook)})
    floor = _grad_rel(wide, plain)
    del wide
    limit = [max(GRAD_RTOL_MIN, GRAD_FLOOR_FACTOR * f) for f in floor]
    loss, got, launches = _grads(cfg, params, batch, {})
    rel = _grad_rel(got, plain)
    del got
    paths = _leaf_paths(params)
    for w in watch:
        check(any(w in p for p in paths), f"{name}: no leaf of the tree "
              f"holds {w!r}")
    watched = [i for i, p in enumerate(paths) if any(w in p for w in watch)]
    fault_over, fault_watched = {}, {}
    for fault, hooks in faults.items():
        _, g, _ = _grads(cfg, params, batch, hooks)
        over_f = [r / lim for r, lim in zip(_grad_rel(g, plain), limit)]
        fault_over[fault] = max(over_f)
        fault_watched[fault] = [over_f[i] for i in watched]
        del g
    del plain
    per = 2 if cfg.remat else 1
    want = {k: n * per for k, n in calls.items()}
    over = [r / lim for r, lim in zip(rel, limit)]
    worst = sorted(range(len(rel)), key=lambda i: -over[i])[:3]
    reading = {"arch": cfg.name, "layers": cfg.num_layers,
               "batch": list(batch["tokens"].shape), "hook": hook,
               "remat": cfg.remat, "loss": loss, "plain_loss": plain_loss,
               "grad_rel_l2_max": max(rel),
               "grad_rel_l2_median": sorted(rel)[len(rel) // 2],
               "floor_rel_l2_max": max(floor),
               "floor_rel_l2_median": sorted(floor)[len(floor) // 2],
               "max_over_limit": max(over), "leaves": len(rel),
               "worst_leaves": [{"leaf": paths[i], "rel_l2": rel[i],
                                 "floor": floor[i], "limit": limit[i]}
                                for i in worst],
               "launches": {k: v for k, v in launches.items() if v},
               "expected_launches": want,
               **{f"fault_{f}_over_limit": r for f, r in fault_over.items()},
               "watched_leaves": [
                   {"leaf": paths[i], "rel_l2": rel[i], "floor": floor[i],
                    "limit": limit[i], **{f"fault_{f}_over_limit": r[j]
                                          for f, r in fault_watched.items()}}
                   for j, i in enumerate(watched)]}
    check(math.isfinite(loss) and abs(loss - plain_loss) <= TRAIN_LOSS_RTOL
          * abs(plain_loss), f"{name}: loss {loss} against the plain "
          f"{plain_loss}")
    check(max(over) <= 1.0, f"{name} gradients, kernels vs plain {hook}: "
          f"a leaf at {max(over)} x its limit: {reading['worst_leaves']}")
    for fault, r in fault_over.items():
        check(r > 1.0, f"planted fault '{fault}' passed the {name} "
              f"gradient check: at most {r} x a leaf's limit")
        for j, i in enumerate(watched):
            check(fault_watched[fault][j] > 1.0, f"planted fault '{fault}' "
                  f"passed the {name} gradient check on {paths[i]}: "
                  f"{fault_watched[fault][j]} x its limit")
    for kname, n in launches.items():
        check(n == want.get(kname, 0), f"{name}: {kname} launched {n} "
              f"times in a forward and backward, expected "
              f"{want.get(kname, 0)}")
    return reading


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _same(a, b) -> bool:
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _spread(a, b) -> float:
    from repro_torch.tree import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _stack_pods(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_pods([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _pod_readings(cfg, model, params, opt) -> dict:
    """make_federated_train_step, 2 pods (weights from seeds 0 and 1),
    FedAvg every 2 steps, 4 steps of the CLI's batch split in two: the
    replicas bitwise equal after each FedAvg and apart before it; pod
    0's first step bitwise make_train_step on its slice."""
    from repro_torch.launch.train import (
        make_federated_train_step, make_train_step)
    from repro_torch.tree import tree_map
    other = model.init(torch.Generator(DEVICE).manual_seed(1))
    pf = _stack_pods([params, other])
    del other
    sf = opt.init(pf)
    pod0 = _clone(tree_map(lambda t: t[0], pf))
    state0 = opt.init(pod0)
    fed = make_federated_train_step(model, opt, 2, 2)
    plain = make_train_step(model, opt)
    equal, step = [], 0
    for i in range(4):
        batch = _lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=20 + i)
        split = {k: v.reshape((2, TRAIN_BATCH // 2) + v.shape[1:])
                 for k, v in batch.items()}
        pf, sf, step, m = fed(pf, sf, step, split)
        equal.append(_same(tree_map(lambda t: t[0], pf),
                           tree_map(lambda t: t[1], pf)))
        if i == 0:
            pod0, state0, _, _ = plain(pod0, state0, 0, {
                k: v[0] for k, v in split.items()})
            first = {"params": _same(tree_map(lambda t: t[0], pf), pod0),
                     "state": _same(tree_map(lambda t: t[0], sf), state0),
                     "spread": _spread(tree_map(lambda t: t[0], pf), pod0)}
            del pod0, state0
    loss = float(m["loss"])
    del pf, sf
    r = {"pods": 2, "fedavg_every": 2, "steps": 4,
         "replicas_equal_after_step": equal,
         "pod_step_vs_plain_step": first, "last_loss": loss}
    check(equal == [False, True, False, True], f"pods: replicas equal "
          f"after steps {equal}, expected after each FedAvg (1, 3) only")
    check(first["params"] and first["state"], f"pods: pod 0's first step "
          f"is not bitwise make_train_step on its slice: {first}")
    check(math.isfinite(loss), f"pods: loss {loss}")
    return r


def _train_timings(cfg, model, params, opt) -> dict:
    """Steps/s and tokens/s over the host clock (TRAIN_TIMED_STEPS steps
    after 2 warm ones, ending in a synchronize), peak device memory, and
    one step under torch.profiler; and a rerun of 2 steps from the same
    weights, state and batches: bitwise, or its spread."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import make_train_step
    fn = make_train_step(model, opt)
    batches = [_lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=s)
               for s in range(2)]
    start_p, start_s = _clone(params), opt.init(params)
    runs = []
    for _ in range(2):
        p, s = _clone(start_p), _clone(start_s)
        for i, b in enumerate(batches):
            p, s, _, m = fn(p, s, i, b)
        runs.append(({"params": p, "state": s}, float(m["loss"])))
    rerun = {"bitwise": _same(runs[0][0], runs[1][0]),
             "spread": _spread(runs[0][0], runs[1][0]),
             "losses": [r[1] for r in runs]}
    del runs
    p, s = start_p, start_s
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = 0
    for _ in range(2):
        p, s, step, m = fn(p, s, step, batches[step % 2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        p, s, step, m = fn(p, s, step, batches[step % 2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, s, step, m = fn(p, s, step, batches[step % 2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del p, s
    check(rerun["bitwise"], f"{cfg.name} training rerun: not bitwise "
          f"equal: {rerun}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"steps_per_s": TRAIN_TIMED_STEPS / wall,
            "tokens_per_s": TRAIN_TIMED_STEPS * tokens / wall,
            "step_ms": wall / TRAIN_TIMED_STEPS * 1e3,
            "timed_steps": TRAIN_TIMED_STEPS, "peak_gb": peak / 1e9,
            "rerun": rerun, "profile": _profile_rows(prof, wall_ms, 1)}


def phase_train_lm(attn_row, router_row, rwkv_row, mamba_row) -> dict:
    """LM training on the card (module doc, phase 24)."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim import adam, linear_warmup_cosine
    t_phase = time.perf_counter()
    held = _release()
    cfg, model, params, info = _init_model(TRAIN_ARCH)
    check(cfg.remat, f"{TRAIN_ARCH} trains with remat")
    batch = _lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    grads = _grad_check(TRAIN_ARCH, cfg, params, batch, "attend",
                        {"flash_attention": cfg.num_layers},
                        {"attention_detached": {"attend": _detached(
                            "attend")},
                         "wrong_mask_backward": {
                             "attend": _wrong_mask_backward}})
    emit({"phase": "train_lm_grads", **grads})
    opt = adam(linear_warmup_cosine(3e-4, 10, LEARN_STEPS), per_client=False)
    timing = _train_timings(cfg, model, params, opt)
    emit({"phase": "train_lm_timing", "arch": TRAIN_ARCH,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, **timing})
    pods = _pod_readings(cfg, model, params, opt)
    emit({"phase": "train_lm_pods", "arch": TRAIN_ARCH, **pods})
    del params, model, batch
    _release()

    # the main path: the CLI as a user runs it, every count set to 0 just
    # before and read just after
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = train_main(["--vocab", str(LEARN_VOCAB), "--steps",
                         str(LEARN_STEPS)])
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    want = LEARN_STEPS * cfg.num_layers * 2
    check(launches["flash_attention"] == want, f"train_lm: flash_attention "
          f"launched {launches['flash_attention']} times in {LEARN_STEPS} "
          f"steps, expected {want} = {LEARN_STEPS} x {cfg.num_layers} "
          "layers x 2 (the remat recompute)")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          f"train_lm: other kernels launched {launches}")
    check(all(math.isfinite(x) for x in losses), f"train_lm losses {losses}")
    check(losses[-1] <= losses[0] - LEARN_DROP, f"train_lm did not learn: "
          f"{losses[0]} -> {losses[-1]} (a drop of {LEARN_DROP} wanted)")
    emit({"phase": "train_lm", **info, "vocab": LEARN_VOCAB,
          "steps": LEARN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "lr": 3e-4, "warmup": 10, "main_s": main_s,
          "losses": losses[::5] + [losses[-1]],
          "loss_drop": losses[0] - losses[-1],
          "flash_attention_launches": launches["flash_attention"],
          "allocated_before_gb": held / 1e9})

    # each other family's kernels, one forward and backward at full
    # width; the kernel under test against its plain version
    family = {}
    for arch, layers, B, S, hook, calls, faults, dtype, watch in \
            GRAD_FAMILIES:
        _release()
        fcfg, _, fparams, finfo = _init_model(arch, layers, dtype)
        fbatch = _lm_batch(fcfg, B, S, seed=1,
                           prefix=fcfg.is_encoder_decoder)
        key = arch if dtype is None else f"{arch} {dtype}"
        family[key] = _grad_check(
            key, fcfg, fparams, fbatch, hook, calls,
            {f: {hook: _detached(hook)} for f in faults}, watch)
        family[key].update(params=finfo["params"], dtype=fcfg.dtype)
        emit({"phase": "train_lm_family", **family[key]})
        del fparams, fbatch

    def count(kernel):
        return {a: r["launches"].get(kernel, 0) for a, r in family.items()
                if r["launches"].get(kernel)}
    attn_row["launches_train_lm"] = launches["flash_attention"]
    attn_row["launches_train_lm_checks"] = {
        TRAIN_ARCH: grads["launches"].get("flash_attention", 0),
        **count("flash_attention")}
    router_row["launches_train_lm_checks"] = count("moe_router")
    rwkv_row["launches_train_lm_checks"] = count("rwkv6_scan")
    mamba_row["launches_train_lm_checks"] = count("mamba_scan_fused")
    emit({"phase": "train_lm_summary",
          "phase_s": time.perf_counter() - t_phase})
    return {"step_ms": timing["step_ms"],
            "device_ms": timing["profile"]["device_ms_per_step"]}


# ---------------------------------------------------------------------------
# The De-VertiFL input block's exchange: qwen1.5-0.5b trained and served,
# and llava-next-34b's image prefix prefilled, with the embedding's
# d_model split among EXCHANGE_CLIENTS emulated clients (the production
# mesh's model axis), under both exchange modes, against one client
EXCHANGE_CLIENTS = 16
EXCHANGE_MODES = ("zeropad_psum", "allgather")
EXCHANGE_VLM_LAYERS = 4
EXCHANGE_SERVE = Serving(max_batch=4, cache_len=512, n_new=16)


def _exchange_cfg(cfg, mode):
    return cfg.replace(vfl=dataclasses.replace(cfg.vfl, enabled=True,
                                               exchange=mode))


def _padded_at_next_offset(x_slices, mode):
    """A planted fault: client i's slice padded at client i + 1's
    offset (the last at client 0's)."""
    n, d = len(x_slices), x_slices[0].shape[-1]
    return sum(torch.nn.functional.pad(
        x, (((i + 1) % n) * d, (n - 1 - (i + 1) % n) * d))
        for i, x in enumerate(x_slices))


def _gathered_reversed(x_slices, mode):
    """A planted fault: the slices gathered in reversed client order."""
    return torch.cat(x_slices[::-1], dim=-1)


def _prefix_not_sliced(table, ids, prefix_emb, clients):
    """A planted fault: every client puts the prefix's first column
    slice before its text (the prefix not sliced by client)."""
    d = table.shape[-1] // clients
    return [torch.cat([prefix_emb[..., :d].to(table.dtype),
                       table[:, i * d:(i + 1) * d][ids]], dim=1)
            for i in range(clients)]


class _Swapped:
    """Within the block, ``repro_torch.models.transformer``'s function
    ``name`` is ``fn`` (a planted fault)."""

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __enter__(self):
        from repro_torch.models import transformer as T
        self.saved = getattr(T, self.name)
        setattr(T, self.name, self.fn)

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T
        setattr(T, self.name, self.saved)


@torch.no_grad()
def _logits(model, params, batch):
    logits, _ = model.forward_logits(params, batch)
    torch.cuda.synchronize()
    return logits


def _fault_reading(bad, good) -> dict:
    return {"bitwise": torch.equal(bad, good),
            "rel_l2": float((bad - good).norm() / good.norm())}


def _exchange_steps(cfg, model, params, opt, batches, profiled=True):
    """2 steps from the same weights and state, twice: bitwise, and the
    final weights; then TRAIN_TIMED_STEPS timed steps after 2 warm ones
    (host clock, ending in a synchronize), and one under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import make_train_step
    fn = make_train_step(model, opt)
    runs = []
    for _ in range(2):
        p, s = _clone(params), opt.init(params)
        for i, b in enumerate(batches):
            p, s, _, m = fn(p, s, i, b)
        runs.append(p)
    rerun = _same(runs[0], runs[1])
    p, s, step = runs.pop(), opt.init(params), 0
    for _ in range(2):
        p, s, step, m = fn(p, s, step, batches[step % 2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        p, s, step, m = fn(p, s, step, batches[step % 2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"rerun_bitwise": rerun, "two_steps": runs[0],
           "steps_per_s": TRAIN_TIMED_STEPS / wall,
           "step_ms": wall / TRAIN_TIMED_STEPS * 1e3}
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p, s, step, m = fn(p, s, step, batches[step % 2])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _profile_rows(prof, wall_ms, 1)
        out["profile"] = {k: rows[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
            "kernels_per_step", "by_kind")}
    del p, s
    return out


def _exchange_train(cfg, model, params) -> dict:
    """qwen1.5-0.5b at the CLI's batch: loss, logits and every gradient
    leaf of each mode at EXCHANGE_CLIENTS clients against one client,
    the launches of a forward and backward, 2 steps rerun and timed
    steps; the two exchange faults on the logits."""
    from repro_torch.models import build_model
    from repro_torch.optim import adam, linear_warmup_cosine
    batch = _lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    base_loss, base_grads, _ = _grads(cfg, params, batch, {})
    base_logits = _logits(model, params, batch)
    paths = _leaf_paths(params)
    opt = adam(linear_warmup_cosine(3e-4, 10, LEARN_STEPS), per_client=False)
    batches = [_lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=s)
               for s in range(2)]
    timed = {"clients=1": _exchange_steps(cfg, model, params, opt, batches)}
    base_steps = timed["clients=1"].pop("two_steps")
    modes = {}
    for mode in EXCHANGE_MODES:
        mcfg = _exchange_cfg(cfg, mode)
        mmodel = build_model(mcfg, clients=EXCHANGE_CLIENTS)
        loss, grads, launches = _grads(mcfg, params, batch, {},
                                       EXCHANGE_CLIENTS)
        unequal = [paths[i] for i, (a, b) in
                   enumerate(zip(grads, base_grads)) if not torch.equal(a, b)]
        rel = {paths[i]: _grad_rel([a], [b])[0] for i, (a, b) in
               enumerate(zip(grads, base_grads)) if paths[i] in unequal}
        del grads
        logits_equal = torch.equal(_logits(mmodel, params, batch),
                                   base_logits)
        steps = _exchange_steps(mcfg, mmodel, params, opt, batches)
        steps_equal = _same(steps.pop("two_steps"), base_steps)
        modes[mode] = {"loss": loss, "loss_bitwise": loss == base_loss,
                       "logits_bitwise": logits_equal,
                       "grad_leaves_not_bitwise": rel,
                       "launches": {k: v for k, v in launches.items() if v},
                       "two_steps_bitwise_clients_1": steps_equal,
                       "exchange_bytes": mmodel.exchange_bytes(
                           (TRAIN_BATCH, TRAIN_SEQ)), **steps}
    timed["clients=1 again"] = _exchange_steps(cfg, model, params, opt,
                                               batches, profiled=False)
    timed["clients=1 again"].pop("two_steps")
    del base_grads, base_steps
    zcfg = _exchange_cfg(cfg, "zeropad_psum")
    zmodel = build_model(zcfg, clients=EXCHANGE_CLIENTS)
    with _Swapped("exchange_features", _padded_at_next_offset):
        shifted = _fault_reading(_logits(zmodel, params, batch), base_logits)
    amodel = build_model(_exchange_cfg(cfg, "allgather"),
                         clients=EXCHANGE_CLIENTS)
    with _Swapped("exchange_features", _gathered_reversed):
        reversed_ = _fault_reading(_logits(amodel, params, batch),
                                   base_logits)
    del base_logits
    return {"modes": modes, "clients_1": timed, "faults": {
        "slice padded at the next client's offset": shifted,
        "allgather in reversed client order": reversed_}}


def _exchange_serve(cfg, params) -> dict:
    """A few greedy requests through ServingEngine at EXCHANGE_CLIENTS
    clients in each mode: the tokens of one client."""
    from repro_torch.models import build_model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 257, 6)]
    reqs = lambda: _requests(prompts, EXCHANGE_SERVE.n_new)  # noqa: E731
    run = EXCHANGE_SERVE
    _, base, _ = _serve(build_model(cfg), params, reqs(), run.max_batch,
                        run.cache_len)
    out = {}
    for mode in EXCHANGE_MODES:
        model = build_model(_exchange_cfg(cfg, mode),
                            clients=EXCHANGE_CLIENTS)
        _, done, t = _serve(model, params, reqs(), run.max_batch,
                            run.cache_len)
        out[mode] = {"tokens_equal": done == base,
                     "requests": len(done), "wall_s": t["wall_s"]}
    return out


def _exchange_vlm() -> dict:
    """llava-next-34b at full width, EXCHANGE_VLM_LAYERS layers: one
    prefill of a prompt after 2,880 random image rows in each mode at
    EXCHANGE_CLIENTS clients, logits and the decode state against one
    client's; the prefix not sliced must fail."""
    from repro_torch.models import build_model
    cfg, model, params, info = _init_model("llava-next-34b",
                                           EXCHANGE_VLM_LAYERS)
    rng = np.random.default_rng(4)
    batch = _batch(rng.integers(0, cfg.vocab_size, 64).tolist(),
                   _random_prefix(cfg, 1))
    with torch.no_grad():
        base, base_state = model.prefill(params, batch)
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model,
           "columns_a_client": cfg.d_model // EXCHANGE_CLIENTS,
           "image_rows": batch["prefix_emb"].shape[1],
           "text_tokens": batch["tokens"].shape[1], "params": info["params"]}
    for mode in EXCHANGE_MODES:
        mmodel = build_model(_exchange_cfg(cfg, mode),
                             clients=EXCHANGE_CLIENTS)
        with torch.no_grad():
            logits, state = mmodel.prefill(params, batch)
        out[mode] = {"logits_bitwise": torch.equal(logits, base),
                     "state_bitwise": _same(state["cache"],
                                            base_state["cache"]),
                     "exchange_bytes": mmodel.exchange_bytes(
                         tuple(batch["tokens"].shape),
                         batch["prefix_emb"].shape[1])}
    with _Swapped("client_inputs", _prefix_not_sliced), torch.no_grad():
        bad, _ = build_model(_exchange_cfg(cfg, "zeropad_psum"),
                             clients=EXCHANGE_CLIENTS).prefill(params, batch)
    out["fault_prefix_not_sliced"] = _fault_reading(bad, base)
    return out


def phase_exchange(attn_row) -> dict:
    """The input block's exchange on the card (module doc, phase 25);
    returns each mode's step and device ms for the dry run's bound
    check."""
    t_phase = time.perf_counter()
    held = _release()
    cfg, model, params, info = _init_model(TRAIN_ARCH)
    train = _exchange_train(cfg, model, params)
    serve = _exchange_serve(cfg, params)
    del params, model
    _release()
    vlm = _exchange_vlm()
    _release()
    emit({"phase": "exchange", **info, "clients": EXCHANGE_CLIENTS,
          "columns_a_client": cfg.d_model // EXCHANGE_CLIENTS,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "allocated_before_gb": held / 1e9, "train": train,
          "serve": serve, "vlm": vlm,
          "phase_s": time.perf_counter() - t_phase})
    want = {"flash_attention": 2 * cfg.num_layers}
    for mode, r in train["modes"].items():
        check(r["loss_bitwise"] and r["logits_bitwise"], f"exchange "
              f"{mode}: loss or logits differ from one client's: {r}")
        check(not r["grad_leaves_not_bitwise"], f"exchange {mode}: "
              f"gradient leaves differ from one client's: "
              f"{r['grad_leaves_not_bitwise']}")
        check(r["launches"] == want, f"exchange {mode}: launches "
              f"{r['launches']} in a forward and backward, expected {want}")
        check(r["rerun_bitwise"], f"exchange {mode}: 2 steps rerun not "
              "bitwise")
        check(r["two_steps_bitwise_clients_1"], f"exchange {mode}: 2 steps "
              "differ from one client's")
        check(serve[mode]["tokens_equal"], f"exchange {mode}: served tokens "
              "differ from one client's")
        check(vlm[mode]["logits_bitwise"] and vlm[mode]["state_bitwise"],
              f"exchange {mode}: llava prefill differs from one client's")
    for fault, r in {**train["faults"], "prefix not sliced":
                     vlm["fault_prefix_not_sliced"]}.items():
        check(not r["bitwise"], f"planted fault '{fault}' passed the "
              f"exchange check: {r}")
    attn_row["launches_exchange_step"] = {
        mode: r["launches"].get("flash_attention", 0)
        for mode, r in train["modes"].items()}
    return {mode: {"step_ms": r["step_ms"],
                   "device_ms": r["profile"]["device_ms_per_step"]}
            for mode, r in train["modes"].items()}


# ---------------------------------------------------------------------------
# The one-card dry run: every ARCHS x SHAPES step built on the meta device
# by `python -m repro_torch.launch.dryrun` in a process of its own
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT_S = 600


def phase_dryrun(measured) -> None:
    """The dry run's records (module doc, phase 26): the CLI over every
    (arch, shape) at EXCHANGE_CLIENTS clients under zeropad_psum, its
    records to DRYRUN_OUT.  ``measured``: the 8 x 256 step's host and
    device ms with one client ("clients=1", from train_lm) and in each
    exchange mode at EXCHANGE_CLIENTS clients."""
    import os
    import shutil
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, dryrun_federated
    from repro_torch.roofline.analysis import HBM_BYTES
    t_phase = time.perf_counter()
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--exchange", "zeropad_psum", "--clients", str(EXCHANGE_CLIENTS),
         "--force", "--out", str(DRYRUN_OUT)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=DRYRUN_TIMEOUT_S)
    check(cli.returncode == 0,
          f"dry run exited {cli.returncode}: {cli.stdout[-2000:]}")
    cli_s = time.perf_counter() - t_phase
    counts = collections.Counter()
    for arch in dryrun.ARCHS:
        for shape in dryrun.SHAPES:
            path = dryrun.result_path({"arch": arch, "shape": shape,
                                       "mesh": dryrun.MESH,
                                       "exchange": "zeropad_psum"},
                                      DRYRUN_OUT)
            r = json.loads(Path(path).read_text())
            reason = dryrun.skip_reason(get_config(arch), shape)
            counts[r["status"]] += 1
            if reason:
                check(r["status"] == "skipped" and r["reason"] == reason,
                      f"dry run {arch} {shape}: {r['status']}, expected "
                      f"skipped: {reason}")
                emit({"phase": "dryrun_record", "arch": arch,
                      "shape": shape, "status": "skipped"})
                continue
            check(r["status"] == "ok", f"dry run {arch} {shape}: {r}")
            rl = r["roofline"]
            emit({"phase": "dryrun_record", "arch": arch, "shape": shape,
                  "status": "ok", "kind": r["kind"],
                  "flops": r["per_chip_flops"], "bytes": r["per_chip_bytes"],
                  "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
                  "bound_s": rl["bound_s"], "bottleneck": rl["bottleneck"],
                  "useful_flop_frac": rl["useful_flop_frac"],
                  "exchange_gb": r["collective_wire_bytes"]
                  ["exchange_bytes"] / 1e9,
                  "resident_gb": r["resident"]["total"] / 1e9,
                  "fits_80GB": r["fits_80GB"],
                  "kernel_calls": {k: v["calls"] for k, v in
                                   r["kernels"].items()},
                  "build_s": r["build_s"]})
    # the shape the card trained at, counted in this process: the bound
    # cannot exceed the step's device time measured in train_lm and
    # exchange
    card = InputShape("train_8x256", TRAIN_SEQ, TRAIN_BATCH, "train")
    bounds = {}
    for name, times in measured.items():
        ms = times["step_ms"]
        mode = None if name == "clients=1" else name
        r = dryrun.run_one(TRAIN_ARCH, card, exchange=mode,
                           clients=1 if mode is None else EXCHANGE_CLIENTS)
        bound_ms = r["roofline"]["bound_s"] * 1e3
        bounds[name] = {
            "bound_ms": bound_ms, "measured_step_ms": ms,
            "compute_ms": r["roofline"]["compute_s"] * 1e3,
            "memory_ms": r["roofline"]["memory_s"] * 1e3,
            "bottleneck": r["roofline"]["bottleneck"],
            "flops": r["per_chip_flops"], "bytes": r["per_chip_bytes"],
            "kernel_calls": {k: v["calls"] for k, v in r["kernels"].items()},
            "achieved_tflop_per_s": r["per_chip_flops"] / ms / 1e9,
            "bound_over_measured": bound_ms / ms,
            "device_ms": times["device_ms"],
            "bound_over_device": bound_ms / times["device_ms"],
            "resident_gb": r["resident"]["total"] / 1e9}
        check(bound_ms <= times["device_ms"], f"dry run {TRAIN_ARCH} at "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} ({name}): a counted bound of "
              f"{bound_ms} ms above the step's measured device time of "
              f"{times['device_ms']} ms: a wrong count")
    fed = dryrun_federated.run(TRAIN_ARCH)
    check(set(fed["standard"]) == {"collective_total_GB", "crosspod_GB"}
          and set(fed["federated"]) == {
              "collective_total_GB", "crosspod_sync_GB",
              "crosspod_amortized_GB_per_step"}
          and math.isclose(fed["dci_reduction"], fed["fedavg_every"]),
          f"dryrun_federated {TRAIN_ARCH}: {fed}")
    emit({"phase": "dryrun", "clients": EXCHANGE_CLIENTS,
          "exchange": "zeropad_psum", "records": dict(counts),
          "hbm_bytes": HBM_BYTES, "train_8x256": bounds,
          "federated": fed, "cli_s": cli_s,
          "phase_s": time.perf_counter() - t_phase})


def main() -> None:
    info = phase_device()
    reuse_dataset_draws()
    phase_build()
    kernel_row = phase_kernel()
    attn_row = phase_attn_kernel()
    router_row = phase_moe_router()
    rwkv_row = phase_rwkv6_scan()
    mamba_row = phase_mamba_scan()
    from repro_torch.core.protocol import ProtocolConfig
    pcfg = ProtocolConfig(dataset="mnist", n_clients=5, n_samples=70000,
                          rounds=2, epochs=1, batch_size=64)
    train_out = phase_train(kernel_row, pcfg)
    sess, rr = phase_api(train_out, pcfg)
    phase_obs(kernel_row, sess, rr)
    phase_serve_fed(kernel_row, sess)
    phase_sweep(kernel_row, train_out["steps_per_s"])
    phase_adversity(kernel_row, pcfg.replace(n_samples=ADVERSITY_SAMPLES))
    profile_pcfg = pcfg.replace(n_samples=4000)
    profile = phase_profile(profile_pcfg)
    phase_audit(kernel_row, profile_pcfg, profile)
    phase_serve(attn_row)
    phase_serve_moe(router_row, attn_row)
    phase_serve_rwkv(rwkv_row)
    phase_serve_hybrid(mamba_row, attn_row, router_row)
    phase_serve_audio(attn_row)
    phase_serve_vlm(attn_row)
    shapes = {}
    phase_serve_zoo(attn_row, router_row, shapes)
    phase_shapes(attn_row, rwkv_row, shapes)
    measured = {"clients=1": phase_train_lm(attn_row, router_row,
                                            rwkv_row, mamba_row)}
    measured.update(phase_exchange(attn_row))
    phase_dryrun(measured)
    phase_examples(kernel_row, attn_row)
    emit({"phase": "datasets", **_DRAWS})
    emit({"kernels": [kernel_row, attn_row, router_row, rwkv_row,
                      mamba_row]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
