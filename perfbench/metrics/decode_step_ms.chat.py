"""Median host ms of the window's decode steps (ServingEngine.step, ending
in the tokens' copy to the host)."""
from perfbench import readers


def read(run):
    return readers.decode_step_ms(run)
