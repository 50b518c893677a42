"""95th percentile, over the requests whose prefill started in the window, of
submit to prefill start (the engine's request times)."""
from perfbench import program_spans


def read(run):
    return program_spans.queue_wait_p95_ms(run)
