"""The arithmetic behind ``decode_graph_share.chat``: the share of the
traced decode steps that replayed the serving engine's captured CUDA
graph rather than launching the model from Python.  It counts the
engine tracer's counter readings in the traced part: one
``decode_steps`` reading a step, one ``decode_graph_replays`` reading a
replayed one (``ServingEngine.step``).  Returns None where the engine
captures no graph (a program without ``graph_replays``) or records no
step in the traced part."""
from __future__ import annotations

COUNTERS = ("decode_steps", "decode_graph_replays")


def decode_graph_share(run):
    eng = run.srv.engine
    tr = getattr(eng, "tracer", None)
    if not hasattr(eng, "graph_replays") or not hasattr(tr, "records"):
        return None
    n = dict.fromkeys(COUNTERS, 0)
    for r in tr.records:
        if r["ph"] == "C" and r["name"] in n and \
                run.t_open <= tr.origin + r["ts"] / 1e6 <= run.t_trace:
            n[r["name"]] += 1
    if not n["decode_steps"]:
        return None
    return 100.0 * n["decode_graph_replays"] / n["decode_steps"]
