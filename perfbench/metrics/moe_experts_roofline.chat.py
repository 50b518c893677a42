"""The routed experts' products' share of their roofline over the traced
decode steps: the calls' bounds over the device-busy time inside their
``moe.experts`` spans, in %."""
from perfbench import moe_work


def read(run):
    return moe_work.experts_roofline(run)
