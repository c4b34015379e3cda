"""On the card: each cell's first call at its own size against the
reference (the window closed as soon as that call has finished).  Run as
`python -m pytest portbench/tests -m cuda`; skips without a card."""

import pytest

from portbench import run as RUN


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["composite-720p", "composite-512-stream-int8"])
def test_cell_is_correct_on_card(card, cell):
    res = RUN.run_cell(cell, 2 ** 31 + 12345, 0.0, False)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
