"""Every token handed to a client in the window, over the window's seconds."""
from perfbench import readers


def read(run):
    return readers.output_tok_s(run)
