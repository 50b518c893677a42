"""95th percentile of the gaps between consecutive tokens of one request,
over every gap inside the window."""
from perfbench import readers


def read(run):
    return readers.itl_ms(run, 95)
