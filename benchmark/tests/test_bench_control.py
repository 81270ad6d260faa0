"""On the card: the control comes out not correct under each cell's
limits, and the program correct, at the cell's own size on three seeds.

The control is the reference put in the program's place one precision
below the configuration's bfloat16 (fp8 operands), judged against the
float32 reference as a run judges the program
(``modes/<mode>.py:calibrate``).  For a training cell the faults the
cell can have are planted in the program too, and each must fail a
limit.  Run on a card with ``python3 -m pytest benchmark/tests -m cuda``.
"""

import pytest

from benchmark import cells

SEEDS = (3400000001, 3400000002, 3400000003)


def fails(numbers, limits):
    return any(numbers.get(k, 1.0) > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize('name', cells.names('workloads'))
@pytest.mark.parametrize('seed', SEEDS)
def test_the_control_fails_and_the_program_passes(card, name, seed):
    cell = cells.load_cell(name)
    mode = cells.load_mode(cell.mode)
    readings = dict(mode.calibrate(cell, seed, control=True))
    assert not fails(readings['program'], cell.limits), readings['program']
    for side, numbers in readings.items():
        if side.startswith(('control', 'fault')):
            assert fails(numbers, cell.limits), (side, numbers)
