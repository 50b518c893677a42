"""The port's twins of the paper benchmarks (``repro_torch.bench``)
against ``benchmarks/table2.py`` and ``benchmarks/figures.py``: the same
specs, letter for letter, and rows that are the Sessions they wrap, at
a tiny size on the CPU.  Neither writes ``benchmarks/results/``."""
import importlib
import json
import sys
import types
from pathlib import Path

import pytest

from repro_torch.api import ExperimentSpec, build
from repro_torch.bench import RESULTS, figures, table2
from test_torch_support import reference

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        sys.path.insert(0, str(ROOT))
        try:
            ns.table2 = importlib.import_module("benchmarks.table2")
            ns.figures = importlib.import_module("benchmarks.figures")
            yield ns
        finally:
            sys.path.remove(str(ROOT))
            for name in [m for m in sys.modules
                         if m == "benchmarks" or m.startswith("benchmarks.")]:
                del sys.modules[name]


class _Recorder:
    """Stands in for ``build``: records each spec and returns metrics
    that name it, so a twin's rows can be traced to their specs."""

    def __init__(self):
        self.specs = []

    def __call__(self, spec, **kw):
        self.specs.append(spec)
        metrics = {"f1": 0.5, "acc": 0.25}
        if len(spec.seeds) > 1:
            metrics["f1_std"] = 0.0
        return types.SimpleNamespace(run=lambda: types.SimpleNamespace(
            metrics=metrics, spec_hash=spec.spec_hash))


def test_results_go_under_build_not_benchmarks():
    assert RESULTS == ROOT / "build" / "torch_results"
    assert "benchmarks" not in RESULTS.parts


def test_table2_builds_the_references_specs(ref, monkeypatch, tmp_path):
    ours, theirs = _Recorder(), _Recorder()
    monkeypatch.setattr(table2, "build", ours)
    monkeypatch.setattr(ref.table2, "build", theirs)
    monkeypatch.setattr(ref.table2, "RESULTS", str(tmp_path / "ref"))
    rows = table2.run(seeds=(0, 1, 2), out=tmp_path / "t2.json")
    ref_rows = ref.table2.run(seeds=(0, 1, 2))
    assert [s.spec_hash for s in ours.specs] == \
        [s.spec_hash for s in theirs.specs]
    assert len(ours.specs) == 6
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    mine = json.loads((tmp_path / "t2.json").read_text())
    their = json.loads((tmp_path / "ref" / "table2.json").read_text())
    assert mine == their


@pytest.mark.parametrize("paper", [False, True])
def test_figures_build_the_references_specs(ref, monkeypatch, tmp_path,
                                            paper):
    ours, theirs = _Recorder(), _Recorder()
    monkeypatch.setattr(figures, "build", ours)
    monkeypatch.setattr(ref.figures, "build", theirs)
    monkeypatch.setattr(ref.figures, "RESULTS", str(tmp_path / "ref"))
    rows = figures.main(paper=paper, out_dir=tmp_path / "ours")
    ref_rows = ref.figures.main(paper=paper)
    assert [s.spec_hash for s in ours.specs] == \
        [s.spec_hash for s in theirs.specs]
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    for path in sorted((tmp_path / "ref").glob("*.json")):
        mine = json.loads((tmp_path / "ours" / path.name).read_text())
        their = json.loads(path.read_text())
        mine.pop("wall_s"), their.pop("wall_s")
        assert mine == their, path.name


TINY_CASES = (("titanic_vs_flower", "titanic", 3, 2, 1, "acc"),
              ("bank_vs_splitnn", "bank", 2, 1, 1, "f1"))


def test_table2_rows_are_the_sessions_they_wrap(tmp_path):
    out = tmp_path / "table2.json"
    rows = table2.run(seeds=(0, 1), device="cpu", out=out,
                      cases=TINY_CASES)
    table = json.loads(out.read_text())
    assert list(table) == ["titanic_vs_flower", "bank_vs_splitnn"]
    assert len(rows) == 4
    for name, ds, nc, rounds, epochs, metric in TINY_CASES:
        spec = ExperimentSpec(dataset=ds, n_clients=nc, rounds=rounds,
                              epochs=epochs, seeds=(0, 1), eval_every=0)
        fed = build(spec, device="cpu").run()
        base = build(spec.replace(mode="splitnn", seeds=(0,)),
                     device="cpu").run()
        row = table[name]
        assert row["metric"] == metric
        assert row["devertifl"] == {
            "f1": fed.metrics["f1"], "acc": fed.metrics["acc"],
            "f1_std": fed.metrics["f1_std"], "seeds": [0, 1],
            "spec_hash": fed.spec_hash}
        assert row["split_baseline"] == dict(base.metrics,
                                             spec_hash=base.spec_hash)


def test_figure_points_are_the_sessions_they_wrap(tmp_path):
    rows = figures.run_figure("fig5_titanic", "titanic", [2, 3],
                              ("devertifl", "non_federated"), (0, 1),
                              out_dir=tmp_path, device="cpu",
                              settings=dict(rounds=2))
    assert [r[0] for r in rows] == [
        "fig5_titanic/devertifl/n2", "fig5_titanic/devertifl/n3",
        "fig5_titanic/non_federated/n2", "fig5_titanic/non_federated/n3"]
    fig = json.loads((tmp_path / "fig5_titanic.json").read_text())
    assert fig["dataset"] == "titanic"
    for mode, points in fig["curves"].items():
        for p, nc in zip(points, (2, 3), strict=True):
            spec = ExperimentSpec(dataset="titanic", n_clients=nc,
                                  mode=mode, seeds=(0, 1), eval_every=0,
                                  fedavg=mode != "non_federated",
                                  rounds=2, epochs=1)
            m = build(spec, device="cpu").run().metrics
            assert p == {"n_clients": nc, "f1_mean": m["f1"],
                         "f1_std": m["f1_std"], "n_seeds": 2,
                         "spec_hash": spec.spec_hash}
