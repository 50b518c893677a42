"""Builds the port's CUDA kernels with ``nvcc`` at first use.

Each library is one ``csrc/*.cu`` file with plain ``extern "C"``
launchers (flash_attention's tensor-core route is a library of its own),
compiled for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout and loaded with
``ctypes``.  A library's file name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs at import: the CPU tests import every module, and
only a launch on a CUDA tensor asks for a library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "torch_kernels"

# library name -> source, relative to this package
SOURCES = {"vfl_matmul": "vfl_matmul/csrc/vfl_matmul.cu",
           "flash_attention": "flash_attention/csrc/flash_attention.cu",
           "flash_attention_wgmma":
               "flash_attention/csrc/flash_attention_wgmma.cu",
           "moe_router": "moe_router/csrc/moe_router.cu",
           "rwkv6_scan": "rwkv6_scan/csrc/rwkv6_scan.cu",
           "mamba_scan": "mamba_scan/csrc/mamba_scan.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    src = (_PKG / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all) whose library is
    missing, one ``nvcc`` process per source, all started together.
    Returns ``{name: {"path", "seconds", "log"}}`` where ``log`` is the
    compiler's report (``-Xptxas -v``: registers, shared memory,
    spills); ``seconds`` is 0 and ``log`` empty for a cached library.
    Raises RuntimeError naming the kernel and the compiler's output if
    a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    start = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[name])]
        running[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, (path, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build kernel {name!r} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": time.perf_counter() - start,
                     "log": log}
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if it is missing."""
    return ctypes.CDLL(str(build([name])[name]["path"]))
