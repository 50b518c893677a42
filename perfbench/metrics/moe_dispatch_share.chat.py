"""Share of the MoE layers' device-busy time, over the traced decode steps,
spent in routing, dispatch and combine rather than in the experts, in %."""
from perfbench import program_spans


def read(run):
    return program_spans.moe_dispatch_share(run, "step")
