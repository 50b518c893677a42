"""Shared pieces of the benchmark's CPU tests: the checkout on the path,
and tiny cells of the two families (a few layers, narrow widths, a
handful of slots) that run the whole harness on the CPU, where the
port's kernels run their plain versions."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "jamba": {"name": "tiny-jamba", "family": "hybrid", "ssm_type": "mamba",
              "num_layers": 8, "d_model": 64, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 16, "d_ff": 96,
              "vocab_size": 256, "attn_layer_period": 8,
              "attn_layer_offset": 4, "num_experts": 4,
              "num_experts_per_tok": 2, "moe_every": 2, "moe_offset": 1,
              "moe_d_ff": 96, "ssm_state_dim": 8},
    "deepseek": {"name": "tiny-deepseek", "family": "moe", "num_layers": 3,
                 "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
                 "head_dim": 16, "d_ff": 32, "vocab_size": 256,
                 "num_experts": 8, "num_experts_per_tok": 3,
                 "num_shared_experts": 2, "moe_d_ff": 32,
                 "first_layer_dense_ff": 128},
}

TINY_MIX = {"loop": "closed", "clients": 4, "slots": 4, "cache_len": 96,
            "pool": 16, "strata": 4,
            "prompt": {"dist": "loguniform", "min": 8, "max": 48},
            "output": {"dist": "uniform", "min": 4, "max": 24}}


def tiny_conf(family, dtype="bfloat16"):
    """A configuration file's contents for a tiny model of ``family``."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build_model
    cfg = ModelConfig(**TINY[family], dtype=dtype)
    model = dataclasses.asdict(cfg)
    params = sum(t.numel() for t in _leaves(
        build_model(cfg, clients=4).init_meta()))
    return {"name": cfg.name, "clients": 4, "params": params, "model": model}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def tiny_spec(family="jamba", limit=0.05, **over):
    """A check spec with every number ``family``'s cells compare (the
    Mamba state a prefill leaves only where there is one) at ``limit``."""
    names = ["prefill_kv", "decode_gap", "decode_state"]
    if TINY[family].get("ssm_type") == "mamba":
        names.append("prefill_state")
    spec = {"prefill_sample": 3, "decode_steps": 3, "admit_sample": 3,
            "limits": {k: limit for k in names}}
    spec.update(over)
    return spec


@pytest.fixture
def tiny_cell(monkeypatch):
    """Makes ``run.main`` serve a tiny cell: call with the family (and a
    check spec); returns the run module."""
    from perfbench import run

    def use(family, spec=None, dtype="bfloat16"):
        conf = tiny_conf(family, dtype)
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        e2e = [m["name"] for m in bench["end_to_end"]]
        layer = [m["name"] for m in bench["per_layer"]]
        cell = {"name": f"{conf['name']}.tiny", "chips": 1}
        monkeypatch.setattr(run, "load_cell", lambda name: (
            cell, conf, copy.deepcopy(TINY_MIX), spec or tiny_spec(family), e2e,
            layer))
        return run
    return use
