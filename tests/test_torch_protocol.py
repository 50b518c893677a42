"""The port's training path against the JAX package's, end to end.

The reference trains (``DeVertiFL.train``, 2 rounds x 1 epoch); the port
replays it from the reference's initial weights and per-round batch
indices (``DeVertiFL.run_round``), on the CPU.  Per-step losses are
allclose at ``LOSS_RTOL``, test predictions agree on >= 99% of rows and
the final F1 within 0.01 (``assert_replays``).  The port's ``kernel``
lane runs the kernel's plain version here; the reference's ``pallas``
lane runs the Pallas kernel in interpret mode.
"""
import pytest

from test_torch_support import (assert_replays, port_run, reference,
                                reference_run)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


CASES = [
    # dataset, n_samples, n_clients, reference lane, port lane
    ("titanic", None, 3, "slice", "slice"),
    ("titanic", None, 3, "masked", "masked"),
    ("titanic", None, 3, "pallas", "kernel"),
    ("bank", None, 3, "slice", "kernel"),
    ("bank", 2000, 4, "masked", "masked"),
    ("mnist", 600, 3, "pallas", "kernel"),
    ("mnist", 600, 5, "slice", "slice"),
]


@pytest.mark.parametrize("dataset,n_samples,n_clients,ref_lane,lane", CASES)
def test_devertifl_replays_reference(ref, dataset, n_samples, n_clients,
                                     ref_lane, lane):
    kw = dict(dataset=dataset, n_samples=n_samples, n_clients=n_clients,
              rounds=2, epochs=1)
    r = reference_run(ref, first_layer=ref_lane, **kw)
    fed, losses, params = port_run(r.init, r.idx, first_layer=lane, **kw)
    assert fed.first_layer == lane
    assert_replays(r, fed, losses, params)
