"""Prompt tokens whose prefill completed in the window, over the window's
seconds."""
from perfbench import readers


def read(run):
    return readers.prefill_tok_s(run)
