"""The reference's default audit grid at 3 clients, port against
reference (``test_torch_support.assert_audits_alike``): the
devertifl combos with a fault plan or a wire transform (the engine's
layers).  Each combo is clean in both, with the same
set of channels seen."""
from __future__ import annotations

import pytest

from test_torch_support import (assert_audits_alike, audit_grid, combo_id,
                                reference)

GRID = audit_grid(engine=True)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.mark.parametrize("combo", GRID, ids=[combo_id(c) for c in GRID])
def test_combo_is_clean_in_both(ref, combo):
    assert_audits_alike(ref, combo)
