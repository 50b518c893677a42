"""Attention kernels' share of their roofline: the calls' bounds over their
device time, in %."""
from perfbench import readers


def read(run):
    return readers.attn_roofline(run)
