"""A whole traced run of the harness on the card at a tiny size: the
port's kernels, the device trace read and tied to the host's clock, the
check.  Float32 models (TF32 off): the kernels then agree with the
reference to summation order, where a tiny bf16 model's few slots let
one flipped route move the median slot.  Each run in a process of its
own, as the benchmark runs (a second profiler session in one process
has lost its closing marker).  Skips without a card (run on the GPU
with ``-m cuda``)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import copy, json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src", {root!r} + "/perfbench/tests"]
import conftest
from perfbench import run
# widths the port's kernels take: head dim 64, state dim 16, E / 4 lanes
conftest.TINY[{family!r}].update(d_model=256, head_dim=64,
    **({{"ssm_state_dim": 16, "num_experts": 8}} if {family!r} == "jamba"
       else {{"num_experts": 16}}))
conf = conftest.tiny_conf({family!r}, dtype="float32")
bench = json.loads(open({root!r} + "/BENCHMARK.json").read())
layer = [m["name"] for m in bench["per_layer"]]
spec = conftest.tiny_spec({family!r}, limit=1e-3)
run.load_cell = lambda name: ({{"name": "t", "chips": 1}}, conf,
    copy.deepcopy(conftest.TINY_MIX), spec, [], layer)
code, result = run.main(["--workload", "t", "--seed", "9", "--seconds",
                         "2", "--trace", "1"])
print(json.dumps([code, result]))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["jamba", "deepseek"])
def test_traced_run_on_the_card(family):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), family=family)],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    code, result = json.loads(out.stdout.strip().splitlines()[-1])
    assert code == 0
    assert result["correct"], result["checks"]
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    # both markers recorded; the opening one's launch can wait on the
    # tracer's start (13 ms seen), so only the closing one ties the clocks
    assert dev["clock_drift_s"] is not None
    assert abs(dev["clock_drift_s"]) < 0.03
    assert result["breakdown"]["device_ops"]
    m = result["metrics"]
    assert 0 < m["attn_roofline.chat"]["value"] <= 100
    assert 0 < m["mfu.chat"]["value"] <= 100
    assert 0 <= m["idle_share.chat"]["value"] < 100
    if family == "jamba":
        assert 0 < m["mamba_scan_roofline.longdoc"]["value"] <= 100
