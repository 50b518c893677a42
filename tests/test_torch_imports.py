"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package, and nothing on its
path falls back to the CPU when CUDA is missing."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core.protocol import DeVertiFL, ProtocolConfig
from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = _port_modules()
    assert "repro_torch.core.protocol" in mods and len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_names_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_default_device_is_cuda_and_never_falls_back():
    pcfg = ProtocolConfig(dataset="titanic", n_clients=3, rounds=1,
                          epochs=1)
    if torch.cuda.is_available():
        fed = DeVertiFL(pcfg)
        assert fed.device.type == "cuda" and fed.first_layer == "kernel"
        assert not torch.backends.cuda.matmul.allow_tf32
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeVertiFL(pcfg)
    assert DeVertiFL(pcfg, device="cpu").first_layer == "slice"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("this machine has a card: python3 chip_smoke.py is "
                    "the GPU run itself")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_goes_to_an_ignored_directory():
    assert build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    for name, src in build.SOURCES.items():
        assert (build._PKG / src).is_file(), name
        assert build.library_path(name).parent == build.BUILD_DIR
    if shutil.which("nvcc") is None and \
            not os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.nvcc()
