from repro_torch.metrics.classification import accuracy, f1_score  # noqa: F401
