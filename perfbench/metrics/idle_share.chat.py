"""Share of the traced window in which no operation ran on the device (the
union of their intervals), in %."""
from perfbench import readers


def read(run):
    return readers.idle_share(run)
