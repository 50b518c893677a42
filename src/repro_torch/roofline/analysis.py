"""Roofline terms on one NVIDIA H100 (the port of
``repro.roofline.analysis``):

  compute term    = FLOPs / peak FLOP/s of their type
  memory term     = HBM bytes / HBM bandwidth
  collective term = wire bytes / NVLink bandwidth

The peaks are NVIDIA's data sheet for the SXM part, dense, at its full
700 W: HBM3 at 3.35 TB/s and 80 GB, float32 outside the tensor cores at
67 TFLOP/s (the port keeps TF32 off) and bf16 in the tensor cores at
989 TFLOP/s; NVLink 4 at 450 GB/s a direction.  The reference's
``collective_bytes_from_hlo`` parses the collectives of a partitioned
HLO program, which one card does not have, and is not ported.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
NVLINK_BYTES_PER_S = 450e9


def roofline_terms(per_chip_flops, per_chip_bytes, per_chip_wire_bytes,
                   model_flops_per_chip=None, fp32_flops=0.0):
    """The three terms in seconds and the dominant bottleneck, with the
    reference's keys.  ``fp32_flops`` of ``per_chip_flops`` run at the
    float32 peak, the rest at bf16's; on one card the collective term is
    0 unless the caller passes wire bytes."""
    t_c = (per_chip_flops - fp32_flops) / BF16_FLOP_PER_S + \
        fp32_flops / FP32_FLOP_PER_S
    t_m = per_chip_bytes / HBM_BYTES_PER_S
    t_x = per_chip_wire_bytes / NVLINK_BYTES_PER_S
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    out = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
           "bottleneck": dom, "bound_s": max(t_c, t_m, t_x)}
    if model_flops_per_chip is not None:
        out["model_flops_per_chip"] = model_flops_per_chip
        out["useful_flop_frac"] = (model_flops_per_chip / per_chip_flops
                                   if per_chip_flops else 0.0)
    return out


def summarize(record: dict) -> str:
    r = record
    t = r["roofline"]
    return (f"{r['arch']:22s} {r['shape']:12s} mesh={r['mesh']:9s} "
            f"compute={t['compute_s']*1e3:9.3f}ms "
            f"memory={t['memory_s']*1e3:9.3f}ms "
            f"coll={t['collective_s']*1e3:9.3f}ms "
            f"-> {t['bottleneck']}")
