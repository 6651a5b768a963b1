"""Whole runs past the harness's look for a card, with the timed path broken
underneath (``faults.plant``): each fault a cell can have turns ``correct``
false. A cell on one chip has no exchange between chips to leave out."""
import pytest

from annbench.conftest import SMALL
from annbench.faults import FAULTS, plant
from annbench.harness import merge

KINDS = {"sift1m.search": "search", "sift1m.build": "build"}
# at SMALL's 1,200 points the cell's ef of 64 reaches nearly every point
# whatever the beam does; at ef 16 a beam cut short (``early_stop``) shows
OVERRIDES = {"search": merge(SMALL, {"params": {"ef": 16}}), "build": SMALL}


@pytest.mark.parametrize("cell,fault",
                         [(cell, fault) for fault in FAULTS["search"] for cell in KINDS
                          if fault in FAULTS[KINDS[cell]]],
                         ids=lambda v: v)
def test_fault_turns_correct_false(cell, fault, run_small):
    with plant(KINDS[cell], fault):
        rc, r, err = run_small(cell, overrides=OVERRIDES[KINDS[cell]])
    assert rc == 0 and r["correct"] is False
    assert any(line.endswith(" FAIL") for line in err)


def test_plant_restores_the_program(run_small):
    with plant("search", "altered_answer"):
        pass
    rc, r, _ = run_small("sift1m.search")
    assert rc == 0 and r["correct"] is True
