"""The metrics that read the program's own spans, from a whole traced run
of the harness on the card at a tiny size: a float32 jamba cell, whose
decode steps and prefills both pass MoE layers.  The run is the one
``test_perfbench_cuda`` makes, in a process of its own.  Skips without a
card (run on the GPU with ``-m cuda``)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from test_perfbench_cuda import ROOT, RUN

SPAN_METRICS = ("decode_dispatch_ms.chat", "idle_dispatch_share.chat",
                "queue_wait_p95_ms.chat", "moe_dispatch_share.chat",
                "moe_dispatch_share.longdoc")


@pytest.mark.cuda
def test_traced_run_prints_the_metrics_of_the_program_spans():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), family="jamba")],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    code, result = json.loads(out.stdout.strip().splitlines()[-1])
    assert code == 0 and result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPAN_METRICS) <= set(m), sorted(m)
    assert 0 < m["decode_dispatch_ms.chat"]
    assert 0 <= m["idle_dispatch_share.chat"] < 100
    assert 0 <= m["queue_wait_p95_ms.chat"]
    assert 0 < m["moe_dispatch_share.chat"] < 100
    assert 0 < m["moe_dispatch_share.longdoc"] < 100
