"""The one-card dry run (``launch/specs.py``, ``launch/dryrun.py``,
``launch/dryrun_federated.py``) and the ``roofline`` package it reads,
against the JAX package, on the CPU and the meta device.

``ARCHS``, ``SHAPES``, ``skip_reason``, ``model_step_flops`` and
``input_specs`` must equal the reference's for all 40 pairs; the
records must carry the reference's keys where they mean something on
one card; ``roofline_terms`` must keep the reference's keys and
bottleneck logic at the H100's peaks; the cost counter must count a
reduced train step's FLOPs within 5% of the reference's loop-aware HLO
count (``hlo_costs.analyze``) of the same step, jitted on the CPU.
Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``; ``reference()``
imports it after the backend is up and restores the variable.
"""
import ast
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.launch import dryrun, dryrun_federated
from repro_torch.launch import specs as SP
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adam
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import work as W
from repro_torch.roofline.costs import CostCounter, meta_hooks
from repro_torch.tree import tree_leaves
from test_torch_support import reference

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(a, s) for a in dryrun.ARCHS for s in dryrun.SHAPES]
# the reference's record keys that mean something on one card (the
# compiled program's memory_analysis, xla_cost_analysis_raw, lower_s
# and compile_s do not)
KEPT = {"arch", "shape", "mesh", "exchange", "kind", "status", "n_chips",
        "per_chip_flops", "per_chip_bytes", "collective_wire_bytes",
        "roofline", "params_total", "params_active"}


@pytest.fixture(scope="module")
def ref():
    flags = os.environ.get("XLA_FLAGS")
    with reference() as ns:
        assert os.environ.get("XLA_FLAGS") == flags
        yield ns


def _dict_keys(fn, target):
    """The string keys of the dict literals ``fn``'s source assigns to,
    or updates, ``target`` with (e.g. ``record`` or ``out["standard"]``)."""
    tree = ast.parse(inspect.getsource(fn))
    target = ast.unparse(ast.parse(target, mode="eval").body)
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict):
            if any(ast.unparse(t) == target for t in node.targets):
                keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Subscript) and ast.unparse(t.value) ==
                target for t in node.targets):
            keys |= {t.slice.value for t in node.targets}
        if isinstance(node, ast.Call) and \
                ast.unparse(node.func) == f"{target}.update":
            keys |= {k.value for k in node.args[0].keys}
    return keys


def _tree_bytes(arch):
    """The parameter tree's bytes (bf16 weights, float32 norms)."""
    return sum(t.numel() * t.element_size() for t in
               tree_leaves(build_model(get_config(arch)).init_meta()))


def test_archs_shapes_skips_and_model_flops_equal_the_reference(ref):
    assert dryrun.ARCHS == ref.dryrun.ARCHS
    assert dryrun.SHAPES == ref.dryrun.SHAPES
    skipped = 0
    for arch, shape in PAIRS:
        ours, theirs = get_config(arch), ref.configs.get_config(arch)
        assert dryrun.skip_reason(ours, shape) == \
            ref.dryrun.skip_reason(theirs, shape)
        skipped += dryrun.skip_reason(ours, shape) is not None
        mf = dryrun.model_step_flops(ours, shape)
        assert isinstance(mf, int)
        assert mf == ref.dryrun.model_step_flops(theirs, shape)
    assert skipped == 6
    assert dryrun.model_step_flops(get_config("qwen1.5-0.5b"),
                                   "train_4k") == 2_918_378_738_024_448


def test_input_specs_equal_the_reference(ref):
    """Every pair that is not skipped: the reference's ShapeDtypeStructs,
    as meta tensors; what tests/test_system.py::
    test_input_specs_cover_all_pairs checks of them holds."""
    n = 0
    for arch, shape in PAIRS:
        cfg = get_config(arch)
        if dryrun.skip_reason(cfg, shape):
            continue
        ours = SP.input_specs(cfg, shape)
        theirs = ref.specs.input_specs(ref.configs.get_config(arch), shape)
        assert sorted(ours) == sorted(theirs)
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(theirs[k].shape)
            assert str(t.dtype).split(".")[-1] == str(theirs[k].dtype)
        s = INPUT_SHAPES[shape]
        if s.kind == "decode":
            assert ours["tokens"].shape == (s.global_batch, 1)
        else:
            total = ours["tokens"].shape[1] + (
                ours["prefix_emb"].shape[1] if "prefix_emb" in ours and
                cfg.modality == "vision_text" else 0)
            assert total == s.seq_len
        n += 1
    assert n == 34
    # concretize: zeros of the same shapes on a real device
    spec = SP.input_specs(get_config("llava-next-34b"), "decode_32k")
    real = SP.concretize(spec, device="cpu")
    assert real["tokens"].shape == (128, 1) and not real["tokens"].any()
    theirs = ref.specs.concretize(ref.specs.input_specs(
        ref.configs.get_config("llava-next-34b"), "decode_32k"))
    np.testing.assert_array_equal(real["tokens"].numpy(),
                                  np.asarray(theirs["tokens"]))


@pytest.mark.parametrize("terms", [
    (989e12, 0.0, 0.0), (0.0, 3.35e12, 0.0), (0.0, 1e9, 450e9 * 3),
    (1e15, 5e12, 2e11), (0.0, 0.0, 0.0)])
@pytest.mark.parametrize("mf", [None, 5e14])
def test_roofline_terms_are_the_reference_logic_at_the_h100(ref, terms,
                                                            mf):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref.roofline_analysis, "PEAK_FLOPS_BF16",
                   RA.BF16_FLOP_PER_S)
        mp.setattr(ref.roofline_analysis, "HBM_BW", RA.HBM_BYTES_PER_S)
        mp.setattr(ref.roofline_analysis, "ICI_BW", RA.NVLINK_BYTES_PER_S)
        theirs = ref.roofline_analysis.roofline_terms(
            *terms, model_flops_per_chip=mf)
    ours = RA.roofline_terms(*terms, model_flops_per_chip=mf)
    assert ours == theirs
    rec = {"arch": "a", "shape": "s", "mesh": "1xH100", "roofline": ours}
    assert RA.summarize(rec) == ref.roofline_analysis.summarize(rec)


def test_roofline_terms_fp32_share_runs_at_the_float32_peak():
    t = RA.roofline_terms(989e12 + 67e12, 0.0, 0.0, fp32_flops=67e12)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["bottleneck"] == "compute" and t["collective_s"] == 0.0


def test_counter_counts_a_matmul_and_each_loop_iteration():
    a = torch.empty((128, 256), device="meta")
    b = torch.empty((256, 64), device="meta")
    with CostCounter() as c:
        a @ b
    assert c.flops == 2 * 128 * 256 * 64 and c.fp32_flops == c.flops
    assert c.bytes == 4 * (128 * 256 + 256 * 64 + 128 * 64)
    x = torch.empty((64, 64), dtype=torch.bfloat16, device="meta")
    with CostCounter() as one:
        x @ x
    with CostCounter() as ten:
        y = x
        for _ in range(10):
            y = y @ x
    assert ten.flops == 10 * one.flops and one.fp32_flops == 0
    assert ten.bytes == 10 * one.bytes
    with CostCounter() as views:
        x.t().unsqueeze(0)
        x.reshape(-1)[:5]
    assert views.bytes == 0


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (37, 37, True, None), (37, 37, True, 8), (16, 100, False, None),
    (1, 50, True, None), (1, 50, True, 7), (64, 64, False, 5)])
def test_attention_work_on_meta_is_the_mask_count(Sq, Skv, causal, window):
    """On the meta device the pairs are counted in closed form with the
    queries at the newest positions; on real tensors from the mask: the
    two agree where the positions are those."""
    q = torch.zeros(2, 4, Sq, 8)
    k = torch.zeros(2, 2, Skv, 8)
    qpos = torch.arange(Skv - Sq, Skv, dtype=torch.int32)
    kpos = torch.arange(Skv, dtype=torch.int32)
    real = W.attention_work(q, k, causal, window, qpos, kpos)
    meta = W.attention_work(q.to("meta"), k.to("meta"), causal, window,
                            qpos.to("meta"), kpos.to("meta"))
    assert real == meta
    if Sq == Skv:
        none = W.attention_work(q, k, causal, window, None, None)
        meta_none = W.attention_work(q.to("meta"), k.to("meta"), causal,
                                     window, None, None)
        assert none == meta_none


def test_meta_hooks_give_the_kernels_shapes_and_count_backward():
    from repro_torch.kernels import (flash_attention_ref, moe_router_ref,
                                     mamba_scan_fused_ref, rwkv6_scan_ref)
    c = CostCounter()
    hooks = meta_hooks(c)
    g = torch.Generator().manual_seed(0)
    cases = {
        "attend": ((torch.randn(2, 4, 6, 8, generator=g),
                    torch.randn(2, 2, 6, 8, generator=g),
                    torch.randn(2, 2, 6, 8, generator=g)),
                   dict(causal=True, window=None, softcap=0.0, scale=0.3,
                        q_pos=None, k_pos=None), flash_attention_ref),
        "route": ((torch.randn(10, 8, generator=g), 2), {}, moe_router_ref),
        "wkv": ((torch.randn(1, 5, 2, 4, generator=g),) * 3 +
                (torch.rand(1, 5, 2, 4, generator=g),
                 torch.randn(2, 4, generator=g)), {}, rwkv6_scan_ref),
        "sscan": ((torch.rand(1, 5, 6, generator=g),
                   torch.randn(1, 5, 6, generator=g),
                   torch.randn(1, 5, 3, generator=g),
                   torch.randn(1, 5, 3, generator=g),
                   -torch.rand(6, 3, generator=g)), {},
                  mamba_scan_fused_ref)}
    for name, (args, kw, plain) in cases.items():
        want = plain(*args, **kw)
        meta = [a.to("meta").requires_grad_(a.is_floating_point())
                if isinstance(a, torch.Tensor) else a for a in args]
        got = hooks[name](*meta, **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in want], name
        floats = [t for t in got if t.is_floating_point()]
        grads = torch.autograd.grad(floats, [a for a in meta if isinstance(
            a, torch.Tensor)], [torch.empty_like(t) for t in floats])
        assert all(gr.shape == a.shape for gr, a in zip(
            grads, [a for a in meta if isinstance(a, torch.Tensor)]))
    names = dict(c.kernels)
    for k in ("flash_attention", "moe_router", "rwkv6_scan",
              "mamba_scan_fused"):
        assert names[k]["calls"] == names[k + " backward"]["calls"] == 1
        assert names[k + " backward"]["flops"] == 2 * names[k]["flops"]


def test_counted_flops_of_a_reduced_step_match_the_reference_hlo(ref):
    """The reduced qwen1.5-0.5b train step (float32, 2 x 64 tokens): the
    counter over the port's step on CPU tensors (the plain attention,
    whose matmuls flop_counter counts) against hlo_costs.analyze of the
    reference's jitted step (2 M N K for every dot, loop-aware)."""
    jax, jnp = ref.jax, ref.jnp
    rmodel = ref.lm.build_model(ref.reduced.reduced_config("qwen1.5-0.5b"))
    ropt = ref.optim.adam(1e-3)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    B, S = 2, 64
    batch = {"tokens": np.zeros((B, S), np.int32),
             "labels": np.zeros((B, S), np.int32)}
    txt = jax.jit(ref.train.make_train_step(rmodel, ropt)).lower(
        rparams, ropt.init(rparams), jnp.int32(0),
        {k: jnp.asarray(v) for k, v in batch.items()}).compile().as_text()
    theirs = ref.hlo_costs.analyze(txt)["flops"]

    model = build_model(reduced_config("qwen1.5-0.5b"))
    opt = adam(1e-3, per_client=False)
    params = model.init(torch.Generator().manual_seed(0))
    with CostCounter() as c:
        make_train_step(model, opt)(params, opt.init(params), 0, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(c.op_flops) <= {"aten.mm", "aten.bmm", "aten.addmm"}
    assert abs(c.flops - theirs) <= 0.05 * theirs, (c.flops, theirs)


def test_run_one_records_carry_the_reference_keys(ref):
    ref_keys = _dict_keys(ref.dryrun.run_one, "record")
    assert KEPT <= ref_keys
    card = InputShape("train_2x32", 32, 2, "train")
    rec = dryrun.run_one("qwen1.5-0.5b", card, exchange="allgather",
                         clients=4)
    assert KEPT <= set(rec) and rec["status"] == "ok"
    assert rec["mesh"] == "1xH100" and rec["n_chips"] == 1
    assert rec["exchange"] == "allgather" and rec["shape"] == "train_2x32"
    assert set(rec["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "bottleneck", "bound_s",
        "model_flops_per_chip", "useful_flop_frac"}
    assert rec["collective_wire_bytes"] == {"total": 0.0,
                                            "exchange_bytes": 2 * 32 * 1024 * 2}
    assert rec["kernels"]["flash_attention"]["calls"] == 48   # remat
    assert rec["kernels"]["flash_attention backward"]["calls"] == 24
    # a skipped pair: the reference's keys and reason
    skip = dryrun.run_one("qwen2-7b", "long_500k")
    assert skip["status"] == "skipped" and skip["reason"] == \
        ref.dryrun.skip_reason(ref.configs.get_config("qwen2-7b"),
                               "long_500k")
    json.dumps(rec)


def test_run_one_at_full_size_builds_on_meta_without_memory(tmp_path):
    """qwen1.5-0.5b train_4k and rwkv6-1.6b prefill_32k at full size in
    a process of their own: ok, in seconds, and the process's peak
    resident memory far under the weights it describes (nothing
    allocated); the CLI writes its records under --out."""
    # the peak resident set of this process alone: VmHWM (ru_maxrss
    # keeps the forking test worker's peak across exec)
    code = (
        "import json, re\n"
        "from repro_torch.launch.dryrun import run_one\n"
        "recs = [run_one('qwen1.5-0.5b', 'train_4k', "
        "exchange='zeropad_psum'), run_one('rwkv6-1.6b', 'prefill_32k')]\n"
        "hwm = re.search(r'VmHWM:\\s+(\\d+) kB', "
        "open('/proc/self/status').read()).group(1)\n"
        "print(json.dumps({'recs': recs, 'maxrss_kb': int(hwm)}, "
        "default=str))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for rec in got["recs"]:
        assert rec["status"] == "ok" and KEPT <= set(rec)
        assert rec["build_s"] < 60
        assert rec["fits_80GB"] is True
    qwen, rwkv = got["recs"]
    assert qwen["resident"]["weights"] == _tree_bytes("qwen1.5-0.5b")
    assert qwen["resident"]["adam_moments"] == 463_987_712 * 8
    assert qwen["collective_wire_bytes"]["exchange_bytes"] == \
        16 * 256 * 4096 * 1024 * 2
    assert rwkv["exchange"] == "zeropad_psum"
    assert rwkv["resident"]["weights"] > 3e9
    assert got["maxrss_kb"] * 1024 < 1.5e9
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-2b", "--shape", "decode_32k,long_500k", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, check=True)
    assert "done; 0 failures" in out.stdout
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["gemma2-2b__decode_32k__1xH100__zeropad_psum.json",
                     "gemma2-2b__long_500k__1xH100__zeropad_psum.json"]


@pytest.mark.parametrize("every", [50, 7])
def test_dryrun_federated_keys_and_closed_form(ref, every):
    out = dryrun_federated.run("qwen1.5-0.5b", every)
    src = ref.dryrun_federated.run
    assert set(out["standard"]) == _dict_keys(src, 'out["standard"]')
    assert set(out["federated"]) == _dict_keys(src, 'out["federated"]')
    assert {"arch", "fedavg_every", "standard", "federated",
            "dci_reduction"} <= set(out)
    assert out["method"] == "tree"
    P = _tree_bytes("qwen1.5-0.5b")
    assert out["tree_bytes"] == P
    assert out["standard"]["crosspod_GB"] == 2 * P * (2 - 1) / 2 / 1e9
    assert out["federated"]["crosspod_amortized_GB_per_step"] == \
        pytest.approx(P / 1e9 / every)
    assert out["dci_reduction"] == pytest.approx(every)
