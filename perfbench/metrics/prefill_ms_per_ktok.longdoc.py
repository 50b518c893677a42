"""Median host ms of the window's admission passes (each ends in the first
token's copy to the host) per 1,000 prompt tokens admitted."""
from perfbench import readers


def read(run):
    return readers.prefill_ms_per_ktok(run)
