"""The H100's bounds and the cost counting the dry run reads: the port
of ``repro.roofline`` for one card (``analysis``: peaks,
``roofline_terms``, ``summarize``; ``costs``: a dispatch-mode counter
in place of the reference's HLO parser; ``work``: each kernel's
operations and bytes)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    roofline_terms, summarize,
)
