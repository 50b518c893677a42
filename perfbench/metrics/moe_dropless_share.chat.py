"""Share of the MoE layer calls in the traced part that took the dropless
path, from the program's counters, in %."""
from perfbench import moe_work


def read(run):
    return moe_work.dropless_share(run)
