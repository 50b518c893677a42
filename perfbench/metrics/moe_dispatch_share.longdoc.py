"""Share of the MoE layers' device-busy time, over the traced prefills, spent
in routing, dispatch and combine rather than in the experts, in %."""
from perfbench import program_spans


def read(run):
    return program_spans.moe_dispatch_share(run, "prefill")
