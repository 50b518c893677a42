"""The control at a size a test run holds: the reference put in the
program's place in float8 e4m3, read by ``control.py`` beside bf16 runs
of the program on the same requests and states, must fail the
comparison that the program passes."""
from __future__ import annotations

import copy
import json

import pytest

import conftest
from perfbench import check, control


@pytest.mark.parametrize("family", ["jamba", "deepseek"])
def test_control_fails_where_the_program_passes(monkeypatch, tmp_path,
                                                family):
    from perfbench import run
    conf = conftest.tiny_conf(family)
    monkeypatch.setattr(run, "load_cell", lambda name: (
        {"name": "t", "chips": 1}, conf, copy.deepcopy(conftest.TINY_MIX),
        conftest.tiny_spec(family), ["output_tok_s"], []))
    out = tmp_path / "readings.jsonl"
    assert control.main(["--workload", "t", "--seeds", "3,4",
                         "--seconds", "1.5", "--device", "cpu",
                         "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 2
    names = [k for k, v in rows[0]["program"][0].items() if v is not None]
    # limits three times the program's highest reading of each number
    limits = {k: 3 * max(r["program"][0][k] or 0 for r in rows) + 1e-6
              for k in names}
    for r in rows:
        assert check.verdict(r["program"][0], limits, [])[0]
        assert not check.verdict(r["control"][0], limits, [])[0]
