"""Median host ms, over the traced decode steps, of the program's
``decode.dispatch`` span: the ``model.decode_step`` call, launch side."""
from perfbench import program_spans


def read(run):
    return program_spans.decode_dispatch_ms(run)
