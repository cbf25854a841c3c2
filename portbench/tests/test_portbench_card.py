"""On the card, at a size a test run holds (the configurations at their
published widths, the mixes with fewer items): each cell's runs come out
correct, and each cell's control, put in the program's place, does not.
(The controls at the cells' own sizes: ``portbench/control.py``.)"""

import copy

import pytest

from portbench import build, harness

CELLS = [
    ("stvqa-fp32.train-b16", "train-b16", dict(items=256), "tf32"),
    ("stvqa-fp32.offline-b64", "offline-b64", dict(items=256), "tf32"),
]
IDS = [c[0] for c in CELLS]


def run(cell, device, control=None, seed=41):
    workload, mix, kw, _ = cell
    traffic = dict(copy.deepcopy(build.read_json("traffic", mix)), **kw)
    line, _out = harness.local(workload, seed, 2.0, device=device,
                               traffic=traffic, control=control)
    return line


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_cell_is_correct_on_the_card(cell, card):
    line = run(cell, card)
    assert line["correct"], line["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_control_is_not_correct(cell, card):
    line = run(cell, card, control=cell[3])
    assert not line["correct"], line["compared"]


@pytest.mark.card
def test_half_batch_fault_is_not_correct(card):
    line = run(CELLS[0], card, control="half_batch")
    assert not line["correct"], line["compared"]
