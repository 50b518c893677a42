"""95th percentile, over the requests whose first token came in the window,
of the time from submit to first token."""
from perfbench import readers


def read(run):
    return readers.ttft_ms(run, 95)
