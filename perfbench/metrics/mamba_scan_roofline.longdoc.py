"""The fused Mamba scan kernels' share of their roofline: the calls' bounds
over their device time, in %."""
from perfbench import readers


def read(run):
    return readers.mamba_scan_roofline(run)
