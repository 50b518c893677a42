"""Share of the traced window in which the device runs nothing while the host
is inside the program's ``decode.dispatch`` or ``prefill.dispatch`` span, in
%: idle put down to the model's launches."""
from perfbench import program_spans


def read(run):
    return program_spans.idle_dispatch_share(run)
