'''On the card: each cell of the manifest runs a window of the manifest's
length and comes out correct, and its control (the plain reference one
precision down, in the program's place) comes out not correct.

    python -m pytest portbench/tests/test_portbench_card.py

Skips without a CUDA device.'''
import pytest

from portbench import core

MANIFEST = core.load_manifest()
CELLS = [w['name'] for w in MANIFEST['workloads']]
# a run's window: the shares compared want the frames of a whole window
SECONDS = float(MANIFEST['run_seconds'])


@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_correct(card, cell):
    line = core.run_cell(cell, 97531, SECONDS, False)
    assert line['correct'] is True, line['checks']
    assert line['device']['kind'] == __import__('torch').cuda.get_device_name(card)
    assert all(m['value'] > 0 for m in line['metrics'].values())


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(card, cell):
    line = core.run_cell(cell, 97531, SECONDS, False, faults={'control'})
    assert line['correct'] is False, line['checks']
