"""Share of the traced decode steps that replayed the engine's captured CUDA
graph, in %."""
from perfbench import decode_graph


def read(run):
    return decode_graph.decode_graph_share(run)
