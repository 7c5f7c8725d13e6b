"""The control (the plain reference one precision lower, float8 for the
bfloat16 configurations, put in the program's place) comes out not correct
under each cell's limits: on the CPU at a size a test run holds, and on the
card at the cell's own size (where the program comes out correct)."""

import pytest

from perfbench import calibrate, harness

from .test_perfbench_faults import SMALL

CELLS = list(SMALL)


def judged(cell, seed, mode, device, seconds, overrides=None):
    limits = harness.cell_files(cell)[3]
    return harness.judge(calibrate.readings(cell, seed, seconds, device, mode, overrides),
                         limits)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_a_small_size(cell):
    assert judged(cell, 2 ** 31 + 3, "control", "cpu", 0.2, SMALL[cell]) is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell, card):
    for seed in (31, 2 ** 31 + 99, 3 * 10 ** 9 + 7):
        assert judged(cell, seed, "program", card, 1.5) is True
        assert judged(cell, seed, "control", card, 1.5) is False
