"""The card's published peaks, what ``nvidia-smi`` says of the card, and
the names of the kernels by kind: the yardstick's fixed numbers.

Peaks: NVIDIA's data sheet for the H100 SXM part, dense, at its full
700 W: bf16 in the tensor cores 989 TFLOP/s, float32 outside them 67
TFLOP/s (TF32 stays off), HBM3 3.35 TB/s.  Exponentials: 16 base-2
exponentials (MUFU.EX2) a clock on each SM at compute capability 9.0
(the CUDA C++ Programming Guide's throughput table), times the SMs and
the card's maximum SM clock.  A card set below 700 W runs slower under
load; every traced result carries its power limit beside these peaks.
"""
from __future__ import annotations

import subprocess

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_EXP_PER_SM_CLOCK = 16

# the names of the port's kernels contain these (csrc/*.cu); the
# profiler shows them as "void (anonymous namespace)::<name><...>(...)"
ATTENTION_KERNELS = ("flash_attention", "decode_partial_kernel",
                     "decode_combine_kernel")
MAMBA_KERNELS = ("mamba_scan",)
PORT_KERNELS = ("vfl_matmul_", *ATTENTION_KERNELS, "moe_router_kernel",
                "rwkv6_", *MAMBA_KERNELS)

# device time by kind of kernel, from its name: the port's kernels, the
# GEMMs (cuBLAS), PyTorch's elementwise kernels, reductions, copies
KERNEL_KINDS = (("port", PORT_KERNELS),
                ("gemm", ("nvjet", "gemm", "gemv", "sm90_xmma", "cutlass")),
                ("elementwise", ("elementwise",)),
                ("reduce", ("reduce_kernel",)),
                ("copy", ("copy", "CatArray")))


def kind_of(name: str) -> str:
    for kind, stems in KERNEL_KINDS:
        if any(stem in name for stem in stems):
            return kind
    return "other"


def smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of card 0, or "" where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else ""


def card():
    """(power limit in W or None, exponentials a second or None)."""
    import torch
    power = smi("power.limit")
    clock = smi("clocks.max.sm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        exp_rate = SFU_EXP_PER_SM_CLOCK * sms * float(clock) * 1e6
    except ValueError:
        exp_rate = None
    try:
        power_w = float(power)
    except ValueError:
        power_w = None
    return power_w, exp_rate
