'''With the timed path broken underneath, a run's check says not correct:
each planted fault that a cell can have, driven through the whole harness
on the CPU (the look for a card skipped) on a tiny random model, held to
the cells' own limits.'''
import pytest

from portbench import core

FAULTS = [('tiny-infer', 'alter_answer'),     # an answer altered where it is produced
          ('tiny-infer', 'half_batch'),       # half the frames left out
          ('tiny-infer', 'shift_origin'),     # every feature window cut 4 px off
          ('tiny-train', 'frozen_step'),      # a step that leaves the state unchanged
          ('tiny-train', 'half_batch')]       # half the batch left out, the mean over the rest


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_fault_is_not_correct(tiny_root, cell, fault):
    line = core.run_cell(cell, 20231, 0.2, False, faults={fault}, device='cpu', root=tiny_root)
    assert line['correct'] is False, line['checks']
    assert any(c['value'] > c['limit'] for c in line['checks'].values())


@pytest.mark.parametrize('cell', ['tiny-infer', 'tiny-train'])
def test_sound_run_reports_every_check(tiny_root, cell):
    line = core.run_cell(cell, 20231, 0.2, False, device='cpu', root=tiny_root)
    limits = core.resolve(cell, tiny_root).limits['limits']
    assert list(line['checks']) == list(limits)
    assert line['attempted'] >= 1 and line['failed'] == 0


def test_witness_prints_second_readings(tiny_root, capsys):
    '''The training cell's witness: the program runs as it is, and the
    reference under bf16 autocast, on its own proposals and in float8
    read the same recorded steps beside it.'''
    import json
    line = core.run_cell('tiny-train', 20231, 0.2, False, faults={'witness'}, device='cpu',
                         root=tiny_root)
    assert line['attempted'] >= 1
    err = capsys.readouterr().err
    report = json.loads(err.split('portbench: witness ', 1)[1].splitlines()[0])
    for name in ('program', 'reference_bf16', 'reference_own_proposals', 'control_fp8'):
        assert len(report[name]) == 3
