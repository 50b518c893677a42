"""Federated serving demo: continuous-batched vertical inference
through ``Session.server()``.  The twin of ``examples/serving.py``.

Each request's features arrive SPLIT ACROSS CLIENTS (the vertical
setting: every party owns a column slice of the same entity's row).
The server assembles per-client offers, batches admissible requests
into a fixed slot pool advanced by one step (one ``vfl_matmul`` launch
on the card), and keeps a hot-entity cache of exchange activations -- a
repeat entity is served bitwise-identically with NO feature delivery
from any client.

  PYTHONPATH=src python -m repro_torch.examples.serving
  PYTHONPATH=src python -m repro_torch.examples.serving --smoke
  PYTHONPATH=src python -m repro_torch.examples.serving --slots 16 \\
      --requests 64
"""
import argparse

import numpy as np

from repro_torch.api import ExperimentSpec, ServeRequest, build, \
    split_features


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="toy sizes")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_req = 8 if args.smoke else args.requests

    spec = ExperimentSpec(
        dataset="mnist", mode="devertifl", n_clients=3,
        rounds=1 if args.smoke else 3, epochs=1,
        n_samples=512 if args.smoke else 2000, eval_every=0)
    sess = build(spec, device=args.device)
    print(f"training {spec.dataset}/{spec.mode} "
          f"({spec.n_clients} clients, spec {spec.spec_hash}) ...")
    res = sess.run()
    print(f"  trained: f1={res.metrics['f1']:.3f}")

    layout = sess.federation.layout
    xte = np.asarray(sess.federation.xte)[:n_req]

    # --- wave 1: features arrive split across clients, out of order
    srv = sess.server(max_slots=args.slots)
    offers = []
    for i in range(n_req):
        srv.submit(ServeRequest(uid=i, entity_id=f"entity-{i}"))
        slices = split_features(layout, xte[i])  # {client: [F_i]}
        offers += [(i, c, payload) for c, payload in slices.items()]
    rng = np.random.default_rng(0)
    rng.shuffle(offers)                     # arrival order is free
    for uid, client, payload in offers:
        srv.offer(uid, client, payload)
    report = srv.run()
    print(f"wave 1 (fresh): {report.counters['completed']}/{n_req} "
          f"served through {args.slots} slots in "
          f"{report.counters['steps']} steps "
          f"({report.counters['step_traces']} compile), "
          f"p50={report.latency_ms['p50']:.2f}ms "
          f"p99={report.latency_ms['p99']:.2f}ms "
          f"{report.throughput_rps:.0f} req/s")

    # --- wave 2: same entities -- cache hits, no slices needed at all
    for i in range(n_req):
        srv.submit(ServeRequest(uid=n_req + i, entity_id=f"entity-{i}"))
    report2 = srv.run()
    hit = report2.cache["hits"] / n_req
    print(f"wave 2 (hot):   {n_req}/{n_req} served from the "
          f"exchange cache (hit rate {hit:.0%}) -- no client sent "
          f"a single feature")

    # serving is predict, bit for bit
    ref = sess.predict(xte).cpu().numpy()
    ok = all(np.array_equal(report.results[i], ref[:, i])
             and np.array_equal(report2.results[n_req + i], ref[:, i])
             for i in range(n_req))
    print(f"parity with Session.predict(): "
          f"{'bitwise identical' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(1)
    return {"result": res, "waves": [report, report2]}


if __name__ == "__main__":
    main()
