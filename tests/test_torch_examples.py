"""The examples' twins (``src/repro_torch/examples``) against the scripts
in ``examples/``: each twin and its counterpart run on the CPU at the
counterpart's smoke size (the reference's under the jax 0.9 shim of
``test_torch_support.reference``), and the twin must exit cleanly and
print the same lines with the same fields: every number may differ (the
port's generators are not threefry, so losses and F1 are not compared),
every word and every spec hash must not.  A twin's ``--device cpu``
runs on the CPU; without it each runs on CUDA.
"""
import ast
import contextlib
import importlib
import io
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_support import reference

ROOT = Path(__file__).resolve().parents[1]
# (twin, the smoke size's flags): the counterpart's own --smoke where it
# has one; the LM scripts at fewer steps than their defaults
CASES = [("quickstart", []), ("federated_training", ["--smoke"]),
         ("serving", ["--smoke"]), ("staleness_sweep", []),
         ("wire_tradeoff", ["--smoke"]), ("quickstart_lm", ["--steps", "6"]),
         ("train_lm_e2e", ["--steps", "25"])]
# what a twin may import of the port: its public API
PUBLIC = ("repro_torch.api", "repro_torch.launch.train", "repro_torch.models",
          "repro_torch.optim", "repro_torch.data", "repro_torch.checkpoint",
          "repro_torch.configs")
_NUMBER = re.compile(r"-?\d[\d,]*(\.\d+)?(e[-+]?\d+)?")
_HASH = re.compile(r"spec[ =]([0-9a-f]{16})")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _fields(text):
    """Each printed line with its numbers blanked."""
    return [_NUMBER.sub("#", line) for line in text.splitlines()]


def _argv(name, argv, tmp, side):
    if name == "train_lm_e2e":
        return argv + ["--ckpt-dir", str(tmp / side)]
    return argv


def _counterpart(name, argv, tmp):
    """examples/<name>.py run as a script; its printed text."""
    old = sys.argv
    sys.argv = [name] + _argv(name, argv, tmp, "theirs")
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                           run_name="__main__")
    finally:
        sys.argv = old
    return text.getvalue()


def _twin(name, argv, tmp):
    """The twin's main on the CPU: (printed text, what it returned)."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = mod.main(_argv(name, argv, tmp, "ours") + ["--device", "cpu"])
    return text.getvalue(), out


@pytest.mark.parametrize("name,argv", CASES, ids=[c[0] for c in CASES])
def test_twin_prints_its_counterparts_fields(ref, name, argv, tmp_path):
    theirs = _counterpart(name, argv, tmp_path)
    ours, out = _twin(name, argv, tmp_path)
    assert out is not None
    assert _fields(ours) == _fields(theirs), (ours, theirs)
    assert _HASH.findall(ours) == _HASH.findall(theirs)


def test_spec_hashes_are_the_references(ref):
    """The specs the federated twins print hash as the reference's
    (first_layer "auto" resolves to "slice" without a card in both)."""
    from repro_torch.api import ExperimentSpec, spec_grid
    ours = ExperimentSpec(dataset="titanic", mode="devertifl", n_clients=3,
                          rounds=3, epochs=2, seeds=(0,))
    theirs = ref.api.ExperimentSpec(dataset="titanic", mode="devertifl",
                                    n_clients=3, rounds=3, epochs=2,
                                    seeds=(0,))
    assert ours.spec_hash == theirs.spec_hash
    kw = dict(datasets=("titanic",), modes=("devertifl",),
              client_counts=(3,), transforms=("none", "int8"), seeds=(0,),
              rounds=1, epochs=2)
    assert [s.spec_hash for s in spec_grid(**kw)] == \
        [s.spec_hash for s in ref.api.spec_grid(**kw)]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_twin_imports_only_the_public_api(name):
    """A twin is what a user writes: it reaches the port through its
    public modules only."""
    path = ROOT / "src" / "repro_torch" / "examples" / f"{name}.py"
    tree = ast.parse(path.read_text())
    mods = [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module] + \
        [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
         for a in n.names]
    ours = [m for m in mods if m.startswith("repro_torch")]
    assert ours and all(m.startswith(PUBLIC) for m in ours), ours
    assert not any(m.split(".")[0] in ("repro", "jax") for m in mods)


def test_twin_runs_as_a_module():
    """``python -m repro_torch.examples.quickstart --device cpu`` exits 0
    and prints its final metrics."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("final: F1=")


def test_twin_wants_the_card_without_device():
    """Without ``--device`` a twin runs on CUDA, as every entry point of
    the port does: here, without a card, that raises."""
    from repro_torch.examples import quickstart
    if sys.modules["torch"].cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        quickstart.main([])
