"""A whole run of the harness on a tiny cell on the CPU (the look for a
card skipped), sound and with the timed path broken underneath: each
fault a serving cell can have must come out as not correct."""
from __future__ import annotations

import pytest
import torch

from conftest import tiny_spec

ARGS = ["--workload", "tiny", "--seed", str(2**31 + 77), "--seconds", "1.5",
        "--trace", "0"]


def _run(tiny_cell, family):
    # float32 models: a sound run differs from the reference by summation
    # order alone (~1e-6), so a tight limit shows each fault
    run = tiny_cell(family, tiny_spec(family, limit=1e-4), dtype="float32")
    code, result = run.main(ARGS, device="cpu")
    assert code == 0
    return result


@pytest.mark.parametrize("family", ["jamba", "deepseek"])
def test_sound_run_is_correct(tiny_cell, family):
    result = _run(tiny_cell, family)
    assert result["correct"], result["checks"]
    assert result["reported"]["decode_tokens"] > 0
    assert result["reported"]["admitted"] == 3
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"output_tok_s", "ttft_p95_ms",
                                      "itl_p95_ms", "prefill_tok_s",
                                      "setup_s"}


def _state_unchanged(monkeypatch):
    from repro_torch.models.model import Model
    orig = Model.decode_step

    def step(self, params, state, tokens):
        saved = [t.clone() for t in _tensors(state)]
        logits, new = orig(self, params, state, tokens)
        for t, s in zip(_tensors(state), saved):
            t.copy_(s)
        return logits, state
    monkeypatch.setattr(Model, "decode_step", step)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model
    orig = Model.decode_step

    def step(self, params, state, tokens):
        logits, new = orig(self, params, state, tokens)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].mean(0, keepdim=True)
        return logits, new
    monkeypatch.setattr(Model, "decode_step", step)


def _no_exchange(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.exchange_features

    def exchange(x_slices, mode):
        return orig([x_slices[0]] + [torch.zeros_like(x)
                                     for x in x_slices[1:]], mode)
    monkeypatch.setattr(T, "exchange_features", exchange)


def _altered_token(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    orig = ServingEngine._sample

    def sample(self, logits, temperature):
        return (orig(self, logits, temperature) + 1) % logits.shape[-1]
    monkeypatch.setattr(ServingEngine, "_sample", sample)


FAULTS = {"state unchanged by a step": _state_unchanged,
          "half the batch left out": _half_batch,
          "the clients' exchange left out": _no_exchange,
          "a token altered where it is sampled": _altered_token}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("family", ["jamba", "deepseek"])
def test_fault_is_not_correct(tiny_cell, monkeypatch, family, fault):
    FAULTS[fault](monkeypatch)
    result = _run(tiny_cell, family)
    assert not result["correct"], result["checks"]


def _prefill_state_zeroed(monkeypatch):
    """The Mamba state and convolution history that a prefill leaves,
    zeroed where the engine splices them into the slot."""
    from repro_torch.serving.engine import ServingEngine
    orig = ServingEngine._insert_state

    def zero(tree, i, scanned=False, mamba=False):
        for k, v in tree.items():
            if isinstance(v, dict):
                zero(v, i, scanned or k == "scanned", mamba or k == "mamba")
            elif mamba:
                (v[:, i] if scanned else v[i]).zero_()

    def insert(self, slot_idx, single_state, first_tok):
        orig(self, slot_idx, single_state, first_tok)
        zero(self.state["cache"], slot_idx)
    monkeypatch.setattr(ServingEngine, "_insert_state", insert)


def test_zeroed_prefill_state_is_not_correct(tiny_cell, monkeypatch):
    """The decode part starts from the program's own state, so only the
    admissions' comparison can see a prefill's state lost."""
    _prefill_state_zeroed(monkeypatch)
    result = _run(tiny_cell, "jamba")
    assert not result["correct"], result["checks"]
    state = result["checks"]["prefill_state"]
    assert state["value"] > 0.5 > state["limit"]
