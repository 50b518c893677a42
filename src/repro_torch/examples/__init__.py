"""The port's twins of the repository's ``examples/`` scripts: each runs
the same experiment through the port's public API (``repro_torch.api``,
``launch.train``, ``models``, ``optim``, ``data``, ``checkpoint``) and
prints the same fields as its counterpart.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.federated_training --smoke
  PYTHONPATH=src python -m repro_torch.examples.serving --smoke
  PYTHONPATH=src python -m repro_torch.examples.staleness_sweep
  PYTHONPATH=src python -m repro_torch.examples.wire_tradeoff --smoke
  PYTHONPATH=src python -m repro_torch.examples.quickstart_lm
  PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e

Each takes its counterpart's flags and ``--device`` (``cuda`` by
default; ``--device cpu`` runs on the CPU, where the kernels' plain
versions stand in).  Each module's ``main(argv)`` returns what it ran
(results, reports, losses), so a caller can check them.
"""
