"""Drives the system under test: ``repro_torch.serving.ServingEngine``
over ``build_model(cfg, clients=n)``, with the admission-then-step cycle
that ``ServingEngine.run()`` runs, in its order, written out here so
that the window can end mid-stream and every call can be timed on the
host.  Both calls end on the host (each samples on the card and copies
the tokens back), so a token counts as delivered when the call that
made it returns: a first token at the end of the admission pass that
prefilled it, the next ones at the end of each decode step.
"""
from __future__ import annotations

import time

from perfbench import weights
from perfbench.loadgen import ClosedLoop

clock = time.perf_counter


class Req:
    """One request as its client sees it."""

    __slots__ = ("n", "prompt", "max_new", "t_submit", "times", "done")

    def __init__(self, n, prompt, max_new, t_submit):
        self.n, self.prompt, self.max_new = n, prompt, max_new
        self.t_submit = t_submit
        self.times = []          # host time of each token's delivery
        self.done = False


def model_config(model):
    from repro_torch.configs.base import ModelConfig, VFLConfig
    d = dict(model)
    return ModelConfig(**{k: v for k, v in d.items() if k != "vfl"},
                       vfl=VFLConfig(**d["vfl"]))


class Server:
    """The program under the cell's traffic, and what its clients saw."""

    def __init__(self, conf, mix, seed, device):
        from repro_torch.models import build_model
        from repro_torch.serving import ServingEngine
        self.mix = mix
        self.cfg = conf["model"]
        self.model = build_model(model_config(self.cfg),
                                 clients=conf["clients"])
        self.params, self.n_weights = weights.draw(
            self.model.init_meta(), seed, device)
        self.loop = ClosedLoop(mix, self.cfg["vocab_size"], seed)
        self.engine = ServingEngine(self.model, self.params,
                                    max_batch=mix["slots"],
                                    cache_len=mix["cache_len"], seed=seed)
        self.reqs = {}
        self.made = {}
        self.next_n = 0
        self.steps = []      # (start, end, keys each active row sees)
        self.admits = []     # (start, end, prompt tokens, requests)
        self.by_slot = [None] * mix["slots"]

    # ------------------------------------------------------------------
    def make(self, count):
        """Draw the next ``count`` requests' token ids ahead of time."""
        for n in range(self.next_n, self.next_n + count):
            if n not in self.made:
                self.made[n] = self.loop.request(n)

    def submit(self):
        from repro_torch.serving import Request
        n = self.next_n
        self.next_n += 1
        prompt, new = self.made.pop(n) if n in self.made else \
            self.loop.request(n)
        self.reqs[n] = Req(n, prompt, new, clock())
        self.engine.submit(Request(uid=n, prompt=prompt, max_new_tokens=new))

    def warm_up(self):
        """One prefill at the mix's longest prompt and one decode step of
        every slot: the shapes' first calls (the cuBLAS handles, the
        allocator's blocks, the kernels' libraries) before anything is
        timed.  The warm-up request's uid is negative."""
        from repro_torch.serving import Request
        eng = self.engine
        ids = [(7 * i + 1) % self.cfg["vocab_size"]
               for i in range(self.loop.longest_prompt())]
        eng.submit(Request(uid=-1, prompt=ids, max_new_tokens=2))
        eng._admit()
        eng.step()
        eng.done.clear()

    def fill(self):
        """Every client's first request, admitted: the window opens on
        a full pool of conversations at their steady mix of ages."""
        for _ in range(self.mix["clients"]):
            self.submit()
        self.cycle()

    # ------------------------------------------------------------------
    def cycle(self):
        """One turn of ``ServingEngine.run``: admit, then a decode step
        of every slot if any is active."""
        if self.admit():
            self.step()

    def admit(self):
        """The admission pass; returns whether any slot is active."""
        eng = self.engine
        t0 = clock()
        eng._admit()
        t1 = clock()
        admitted, tokens = [], 0
        for i, s in enumerate(eng.slots):
            if s.active and self.by_slot[i] != s.uid:
                r = self.reqs[s.uid]
                r.times.append(t1)
                admitted.append(s.uid)
                tokens += len(r.prompt)
                self.by_slot[i] = s.uid
        if admitted:
            self.admits.append((t0, t1, tokens, admitted))
        return any(u is not None for u in self.by_slot)

    def step(self):
        """A decode step of every slot; each active one's client gets its
        token, and a client whose request is done sends its next."""
        eng = self.engine
        keys = [len(self.reqs[u].prompt) + len(self.reqs[u].times)
                for u in self.by_slot if u is not None]
        t2 = clock()
        eng.step()
        t3 = clock()
        self.steps.append((t2, t3, keys))
        for i, u in enumerate(self.by_slot):
            if u is None:
                continue
            r = self.reqs[u]
            r.times.append(t3)
            if not eng.slots[i].active or eng.slots[i].uid != u:
                r.done = True
                self.by_slot[i] = None
                self.submit()

    def window(self, seconds, after=None):
        """The closed loop for ``seconds``: (open, close) host times.
        ``after`` = (s, fn): ``fn()`` runs between two turns once ``s``
        seconds have passed (or when the window closes), and its result
        is returned third."""
        t_open = clock()
        end = t_open + seconds
        done, got = after is None, None
        while clock() < end:
            self.cycle()
            if not done and clock() >= t_open + after[0]:
                done, got = True, after[1]()
        t_close = clock()
        if not done:
            got = after[1]()
        return t_open, t_close, got

    def served(self, uid):
        """The tokens served to request ``uid`` so far."""
        eng = self.engine
        if uid in eng.done:
            return list(eng.done[uid])
        for s in eng.slots:
            if s.active and s.uid == uid:
                return list(s.generated)
        raise KeyError(uid)

    def spans(self):
        return [("admit", a, b) for a, b, _, _ in self.admits] + \
            [("step", a, b) for a, b, _ in self.steps]
