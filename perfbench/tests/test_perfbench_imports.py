"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (names compared whole: ``repro_torch``
is the system under test), and the reference nothing of the port."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import copy, json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src", {root!r} + "/perfbench/tests"]
import conftest
from perfbench import run
conf = conftest.tiny_conf("jamba")
run.load_cell = lambda name: ({{"name": "t", "chips": 1}}, conf,
    copy.deepcopy(conftest.TINY_MIX), conftest.tiny_spec(),
    ["output_tok_s"], [])
code, result = run.main(["--workload", "t", "--seed", "5", "--seconds",
                         "0.5"], device="cpu")
print(json.dumps([code, sorted({{m.split(".")[0] for m in sys.modules}})]))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import perfbench.reference.model, perfbench.work, perfbench.stats
import perfbench.loadgen, perfbench.check, perfbench.readers
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _names(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code, names = _names(RUN)
    assert code == 0
    assert "repro_torch" in names
    assert not {"jax", "jaxlib", "flax", "repro"} & set(names)


def test_the_reference_loads_nothing_of_the_port():
    names = _names(REFERENCE)
    assert "torch" in names
    assert not {"repro_torch", "repro", "jax"} & set(names)


def test_harness_forbids_by_whole_top_level_name(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in run.loaded_forbidden()
