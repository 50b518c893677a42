"""The benchmark's plain reference: float32 PyTorch, no part of the
system under test (``model.py``)."""
