"""Whether what the timed path served is right: the served tokens and
the state the program wrote, judged against the plain float32
reference (``reference/model.py``) once the window has closed.

Three parts, each on what the window's own engine produced at the
cell's sizes:

- Prefills.  A sample drawn from the seed of the requests the window
  admitted that are still in their slots, and the longest prompt the
  window admitted: the reference prefills each prompt from nothing and
  judges the first served token by its gap (how far its logit lies
  below the reference's best), and the keys and values the program's
  prefill left in the slot's cache, row by row.
- Decode.  ``decode_steps`` more turns of the window's own loop
  (admission, then one decode step of every slot).  A decode step
  routes every slot's token through the MoE layers together, and the
  capacity drops one token's pair by the others', so a request's decode
  cannot be replayed alone: the reference takes the program's state
  before the step (the caches, positions and fed tokens of every slot),
  computes the step for the whole batch itself, and judges each served
  token by its gap and each slot's written state (keys and values,
  Mamba state, convolution history) against its own.
- Admissions.  The first ``admit_sample`` requests that those turns of
  the loop admit (more turns run, without the decode comparison, until
  that many are in): the last-position logits that the program's
  prefill returned (recorded from the timed call itself) and the Mamba
  state and convolution history spliced into the slot before its first
  step, against the reference's prefill of the prompt from nothing.
  The decode part starts from the program's state, so this is what
  judges the state a prefill leaves.

A router's top-k picks can flip at a near tie between bf16 and float32,
and a flipped pick changes that token's layer output by a whole expert's
share, which later layers carry on: the numbers are therefore means and
medians over many tokens, rows and slots, never one token's reading.
Compared, those that ``checks/<cell>.json`` lists, each with its limit:
``decode_gap``, the mean gap of the tokens served by the decode steps;
``prefill_kv``, the median relative error of a cache row the prefill
wrote; ``decode_state``, the largest over keys and values, Mamba state
and convolution history of the median slot's relative error;
``prefill_state``, the larger over Mamba state and convolution history
of the median relative error of one admission's one layer, over the
layers whose input has passed no router (``route_free``: a flipped pick
in a prefill of 2,000 tokens moves every later layer's state, by up to
the control's error).  The program's positions and fed tokens must
also equal what its clients were served.  Reported beside them:
``prefill_gap``, the mean gap of the first tokens, and
``prefill_logits``, the median admission's relative error of its
logits: a dozen first tokens, or a few admissions, a run are too few
for a number that holds still through route flips, and neither parts
the program from the control; ``prefill_state_all``, the state's
number over every Mamba layer.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from perfbench.reference import model as ref

CHECKS = Path(__file__).resolve().parent / "checks"
KINDS = ("kv", "h", "conv")
MAX_TURNS = 400       # turns of the loop the check waits for admissions


def load(cell):
    return json.loads((CHECKS / f"{cell}.json").read_text())


def _layer(tree, kinds, l):
    return ref.layer_tree(tree, kinds, l)


def _row_err(got, want):
    """Relative error of each row of [rows, ...] tensors."""
    return ref.rel_err(got.reshape(got.shape[0], -1),
                       want.reshape(want.shape[0], -1), dim=1)


def prefills(srv, t_open, seed, spec, sides):
    """{side: {"gaps": [...], "rows": [...]}} of the prefill part."""
    cfg = srv.cfg
    kinds = ref.layer_kinds(cfg)
    eng = srv.engine
    dev = srv.params["final_norm"]["scale"].device
    out = {n: {"gaps": [], "rows": []} for n in sides}
    admitted = sorted(u for u, r in srv.reqs.items()
                      if r.t_submit >= t_open and r.times
                      and r.times[0] >= t_open)
    if not admitted:
        return out
    # drawn among those still in their slots, whose prefill's keys and
    # values are still there to read; and the longest prompt of all
    slot_of = {s.uid: i for i, s in enumerate(eng.slots) if s.active}
    live = [u for u in admitted if u in slot_of] or admitted
    rng = np.random.default_rng([seed, 5])
    pick = set(rng.choice(live, size=min(spec["prefill_sample"], len(live)),
                          replace=False).tolist())
    pick.add(max(admitted, key=lambda u: len(srv.reqs[u].prompt)))
    for uid in sorted(pick):
        r = srv.reqs[uid]
        P = len(r.prompt)
        ids = torch.tensor(r.prompt, dtype=torch.long, device=dev)
        base = ref.prefill(srv.params, cfg, ids)
        for name, prec in sides.items():
            if name == "program":
                first = srv.served(uid)[0]
                kv = None
                if uid in slot_of:
                    i = slot_of[uid]
                    kv = {}
                    for l in base["kv"]:
                        c = _layer(eng.state["cache"], kinds, l)["attn"]
                        kv[l] = (c["k"][i, :P], c["v"][i, :P])
            else:
                other = ref.prefill(srv.params, cfg, ids, prec)
                first = int(other["logits"].argmax())
                kv = other["kv"] if uid in slot_of else None
            out[name]["gaps"].append(ref.gap(base["logits"], first))
            if kv is not None:
                for l, (k, v) in base["kv"].items():
                    out[name]["rows"] += _row_err(
                        torch.cat([kv[l][0], kv[l][1]], 1),
                        torch.cat([k, v], 1)).tolist()
    return out


class _PrefillLogits:
    """Records the last-position logits of every prefill the program's
    engine runs while it is in place (after the window only)."""

    def __init__(self, model):
        self.model, self.got = model, []
        timed = model.prefill

        def prefill(*args, **kwargs):
            logits, st = timed(*args, **kwargs)
            self.got.append(logits[0, -1].float().clone())
            return logits, st
        model.prefill = prefill

    def close(self):
        del self.model.prefill


def _mamba_state(cache, kinds, i):
    """{layer: (h, conv)} of slot ``i``'s Mamba layers, copied."""
    out = {}
    for l, (mixer, _) in enumerate(kinds):
        if mixer == "mamba":
            m = _layer(cache, kinds, l)["mamba"]
            out[l] = (m["h"][i].clone(), m["conv"][i].clone())
    return out


def decode(srv, spec, sides):
    """{side: {"gaps": [...], "kv" / "h" / "conv": [error a slot]}} of
    the decode part over ``spec["decode_steps"]`` more turns of the
    loop, the slots whose position or fed token disagrees with what
    their clients were served, and [(uid, logits, {layer: (h, conv)})]
    of the first ``spec["admit_sample"]`` requests those turns (and as
    many more as it takes) admitted, as the program left them."""
    cfg = srv.cfg
    kinds = ref.layer_kinds(cfg)
    eng = srv.engine
    out = {n: {"gaps": [], **{k: [] for k in KINDS}} for n in sides}
    mismatch, fresh = [], []
    want = spec.get("admit_sample", 0)
    rec = _PrefillLogits(srv.model)
    try:
        turn = 0
        while turn < spec["decode_steps"] or \
                (len(fresh) < want and turn < MAX_TURNS):
            was = list(srv.by_slot)
            rec.got.clear()
            if not srv.admit():
                break
            new = [(i, u) for i, u in enumerate(srv.by_slot)
                   if u is not None and u != was[i]]
            if len(new) == len(rec.got):
                for (i, u), logits in zip(new, rec.got):
                    if len(fresh) < want:
                        fresh.append((u, logits, _mamba_state(
                            eng.state["cache"], kinds, i)))
            if turn < spec["decode_steps"]:
                _compared_step(srv, kinds, sides, out, mismatch)
            else:
                srv.step()
            turn += 1
    finally:
        rec.close()
    return out, mismatch, fresh


def _compared_step(srv, kinds, sides, out, mismatch):
    """One decode step of every slot, recomputed by the reference from
    the program's state before it."""
    cfg = srv.cfg
    eng = srv.engine
    cache = eng.state["cache"]
    pos = eng.state["position"].clone().long()
    fed = eng._last_tok[:, 0].to(pos.device).long()
    live = [(i, u) for i, u in enumerate(srv.by_slot) if u is not None]
    for i, u in live:
        r = srv.reqs[u]
        want_pos = len(r.prompt) + len(r.times) - 1
        if int(pos[i]) != want_pos or int(fed[i]) != srv.served(u)[-1]:
            mismatch.append([u, int(pos[i]), want_pos])
    before = {}
    for l, (mixer, _) in enumerate(kinds):
        if mixer == "mamba":
            m = _layer(cache, kinds, l)["mamba"]
            before[l] = {"h": m["h"].clone(), "conv": m["conv"].clone()}
    srv.step()
    served = {i: srv.served(u)[-1] for i, u in live}
    rows = torch.arange(pos.shape[0], device=pos.device)

    def state(l):
        return before.get(l) or _layer(cache, kinds, l)["attn"]

    base = ref.decode(srv.params, cfg, fed, pos, state)
    j = torch.tensor([i for i, _ in live], device=pos.device)
    for name, prec in sides.items():
        if name == "program":
            toks = served
            new = {}
            for l, (mixer, _) in enumerate(kinds):
                c = _layer(cache, kinds, l)
                new[l] = (c["attn"]["k"][rows, pos],
                          c["attn"]["v"][rows, pos]) \
                    if mixer == "attn" else \
                    (c["mamba"]["h"], c["mamba"]["conv"])
        else:
            other = ref.decode(srv.params, cfg, fed, pos, state, prec)
            toks = other["logits"].argmax(-1).tolist()
            new = other["new"]
        res = out[name]
        res["gaps"] += [ref.gap(base["logits"][i], int(toks[i]))
                        for i, _ in live]
        # a slot's error over every layer of a kind
        got = {k: [] for k in KINDS}
        want = {k: [] for k in KINDS}
        for l, (mixer, _) in enumerate(kinds):
            pair = ("kv", "kv") if mixer == "attn" else ("h", "conv")
            for kind, g, w in zip(pair, new[l], base["new"][l]):
                got[kind].append(g[j].reshape(len(j), -1))
                want[kind].append(w[j].reshape(len(j), -1))
        for kind in KINDS:
            if got[kind]:
                res[kind] += ref.rel_err(torch.cat(got[kind], 1),
                                         torch.cat(want[kind], 1),
                                         dim=1).tolist()


def route_free(kinds):
    """The Mamba layers whose input has passed no router: those up to
    the first MoE layer (a layer's mixer runs before its FFN)."""
    first = next((l for l, (_, f) in enumerate(kinds) if f == "moe"),
                 len(kinds))
    return {l for l, (m, _) in enumerate(kinds) if m == "mamba" and l <= first}


def admissions(srv, fresh, sides):
    """{side: {"logits": [error an admission], "h" / "conv": [error an
    admission's layer], "h0" / "conv0": the same of the route-free
    layers}}: the reference's prefill of each prompt from nothing
    against what the program's prefill gave."""
    out = {n: {"logits": [], "h": [], "conv": [], "h0": [], "conv0": []}
           for n in sides}
    free = route_free(ref.layer_kinds(srv.cfg))
    dev = srv.params["final_norm"]["scale"].device
    for uid, logits, state in fresh:
        ids = torch.tensor(srv.reqs[uid].prompt, dtype=torch.long,
                           device=dev)
        base = ref.prefill(srv.params, srv.cfg, ids)
        for name, prec in sides.items():
            if name == "program":
                got, st = logits, state
            else:
                other = ref.prefill(srv.params, srv.cfg, ids, prec)
                got, st = other["logits"], other["state"]
            res = out[name]
            res["logits"].append(ref.rel_err(got, base["logits"]))
            for l, (h, conv) in base["state"].items():
                for kind, got_l, want in (("h", st[l][0], h),
                                          ("conv", st[l][1], conv)):
                    err = ref.rel_err(got_l, want)
                    res[kind].append(err)
                    if l in free:
                        res[kind + "0"].append(err)
    return out


def numbers(pre, dec, adm, raw=False):
    """The compared numbers of one side, and what is only reported
    (``raw``: with every token's gap and every slot's error)."""
    def mean(xs):
        return float(np.mean(xs)) if xs else None

    def med(xs):
        return float(np.median(xs)) if xs else None

    def q(xs):
        return [float(v) for v in np.quantile(xs, (0.1, 0.5, 0.9, 0.99))] \
            if xs else None
    state = [med(dec[k]) for k in KINDS if dec[k]]
    fresh = [med(adm[k]) for k in ("h0", "conv0") if adm[k]]
    every = [med(adm[k]) for k in ("h", "conv") if adm[k]]
    got = {"prefill_gap": mean(pre["gaps"]),
           "prefill_kv": med(pre["rows"]),
           "decode_gap": mean(dec["gaps"]),
           "decode_state": max(state) if state else None,
           "prefill_logits": med(adm["logits"]),
           "prefill_state": max(fresh) if fresh else None,
           "prefill_state_all": max(every) if every else None}
    seen = {"prefill_tokens": len(pre["gaps"]),
            "prefill_gap_q": q(pre["gaps"]),
            "prefill_kv_rows": len(pre["rows"]),
            "prefill_kv_q": q(pre["rows"]),
            "decode_tokens": len(dec["gaps"]),
            "decode_gap_q": q(dec["gaps"]),
            **{f"decode_{k}_q": q(dec[k]) for k in KINDS},
            "admitted": len(adm["logits"]),
            **{f"admitted_{k}_q": q(adm[k]) for k in adm}}
    if raw:
        seen["raw"] = {"prefill_gaps": pre["gaps"],
                       **{f"decode_{k}": v for k, v in dec.items()},
                       **{f"admitted_{k}": v for k, v in adm.items()}}
    return got, seen


def run(srv, t_open, seed, spec, precs=None, raw=False):
    """{side: (numbers, reported)} for the program and any other sides
    (``precs``: {name: precision} of the reference put in its place),
    the slots at odds with what was served, and the seconds it took."""
    t0 = time.perf_counter()
    sides = {"program": None,
             **{n: ref.Precision(p) for n, p in (precs or {}).items()}}
    pre = prefills(srv, t_open, seed, spec, sides)
    t1 = time.perf_counter()
    dec, mismatch, fresh = decode(srv, spec, sides)
    t2 = time.perf_counter()
    adm = admissions(srv, fresh, sides)
    t3 = time.perf_counter()
    out = {n: numbers(pre[n], dec[n], adm[n], raw) for n in sides}
    for _, seen in out.values():
        seen.update(check_prefill_s=t1 - t0, check_decode_s=t2 - t1,
                    check_admitted_s=t3 - t2)
    return out, mismatch


def verdict(got, limits, mismatch):
    """(correct, [[name, value, limit]]): every number present and
    within its limit, and no slot at odds with what was served."""
    rows = [[k, got.get(k), limits[k]] for k in limits]
    ok = not mismatch and all(v is not None and v <= lim
                              for _, v, lim in rows)
    return ok, rows
