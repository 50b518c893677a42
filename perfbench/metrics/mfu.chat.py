"""The model's operations in the traced window over its seconds at the
card's bf16 peak, in %."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
