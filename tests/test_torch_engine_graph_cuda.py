"""The serving engine's decode step as a CUDA graph, on the card: tiny
bfloat16 jamba (Mamba + attention + MoE), deepseek (fine-grained MoE),
rwkv6 and the audio family (an encoder, cross attention over the
state's ``"enc"``), each behind the 4-client input block.

The engine's first step runs eagerly and captures the step; every later
one replays it.  Each step, replayed or not, is held bitwise to
``Model.decode_step`` run eagerly on a clone of the state before it
(the served tokens, the logits, every cache, the positions), over 16
and more steps with admissions between them; the kernels' launch
counters read what the eager step launches.  Then a traced tiny chat
run of the benchmark's harness reads a number for every chat per-layer
metric, the share of replayed steps at 100%.  Skips without a card (run
on the GPU with ``-m cuda``)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.reduced import reduced_config
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import KERNELS
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
CLIENTS = 4
FAMILIES = {"jamba": "jamba-v0.1-52b", "deepseek": "deepseek-moe-16b",
            "rwkv6": "rwkv6-1.6b", "audio": "seamless-m4t-medium"}
SLOTS, CACHE_LEN = 4, 96


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def served(request):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg = reduced_config(FAMILIES[request.param], dtype="bfloat16")
    model = build_model(cfg, clients=CLIENTS)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    return model, params


def _requests(vocab):
    g = torch.Generator().manual_seed(3)
    out = []
    for uid in range(7):
        n = int(torch.randint(4, 40, (1,), generator=g))
        out.append(Request(uid, torch.randint(0, vocab, (n,), generator=g)
                           .tolist(), max_new_tokens=6 + 3 * uid))
    return out


def _launches():
    return [fn.launches for fn in KERNELS]


def _counted(fn):
    """(fn(), the launches each kernel wrapper counted in it)."""
    torch.cuda.synchronize()
    before = _launches()
    out = fn()
    torch.cuda.synchronize()
    return out, [b - a for a, b in zip(before, _launches())]


def test_graph_replay_is_the_eager_step_bitwise(served):
    model, params = served
    eng = ServingEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN)
    for r in _requests(model.cfg.vocab_size):
        eng.submit(r)
    steps = admitted = 0
    with torch.no_grad():
        while eng.queue or any(s.active for s in eng.slots):
            before = eng.prefills
            eng.admit()
            admitted += eng.prefills > before and steps > 0
            if not any(s.active for s in eng.slots):
                continue
            state = tree_map(lambda t: t.clone(), eng.state)
            fed = eng._last_tok.clone().cuda()
            held = {i: (s.uid, len(s.generated))
                    for i, s in enumerate(eng.slots) if s.active}
            _, got_n = _counted(eng.step)
            (logits, want), want_n = _counted(
                lambda: model.decode_step(params, state, fed))
            assert got_n == want_n and sum(want_n) > 0, (got_n, want_n)
            greedy = logits[:, -1, :].argmax(-1).cpu()
            for i, (uid, n) in held.items():
                slot = eng.slots[i]
                toks = slot.generated if slot.active and slot.uid == uid \
                    else eng.done[uid]
                assert toks[n] == int(greedy[i]), (steps, i)
            if steps:
                assert torch.equal(eng._graph.logits, logits), steps
            a, b = tree_leaves(eng.state), tree_leaves(want)
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), steps
            steps += 1
    assert steps == eng.decode_steps >= 16 and admitted >= 1
    assert eng.graph_replays == eng.decode_steps - 1


def test_traced_tiny_chat_run_reads_every_chat_metric():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    sys.path.insert(0, str(ROOT / "perfbench" / "tests"))
    from test_perfbench_cuda import RUN
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), family="jamba")],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    code, result = json.loads(out.stdout.strip().splitlines()[-1])
    assert code == 0 and result["correct"], result["checks"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chat = [m["name"] for m in bench["per_layer"]
            if m["name"].endswith(".chat")]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(chat) <= set(m), sorted(set(chat) - set(m))
    assert m["decode_graph_share.chat"] == 100.0
    assert 0 < m["decode_dispatch_ms.chat"]
    assert 0 < m["moe_dispatch_share.chat"] < 100
