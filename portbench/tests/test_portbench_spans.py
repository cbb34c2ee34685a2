'''The program's spans in the harness's window: each tiny CPU cell run
once, traced, its window holding the spans that each span reader names,
and the readers that need no device time reporting from them.'''
import math

import pytest

from portbench import core
from portbench.yardstick import spans

READ = {'tiny-infer': {'detector.proposal_nms': 'nms.proposal_ms_per_batch.infer',
                       'predictor.to_frame': 'predictor.to_frame_ms_per_batch.infer',
                       'chunk.select.track': 'select.host_ms_per_chunk.infer'},
        'tiny-train': {'train.wait_batch': 'train.wait_batch_ms_per_step.train',
                       'train.step': 'train.step_ms_p90.train'}}
HOST_ONLY = {'select.host_ms_per_chunk.infer', 'train.wait_batch_ms_per_step.train',
             'train.step_ms_p90.train', 'train.host_cpu_ms_per_step.train'}


@pytest.mark.parametrize('cell', sorted(READ))
def test_window_holds_the_spans_each_reader_names(tiny_root, cell, monkeypatch):
    seen = {}
    inner = core.result_line

    def keep(cell_, ctx, out, kind):
        seen['out'] = out
        return inner(cell_, ctx, out, kind)
    monkeypatch.setattr(core, 'result_line', keep)
    line = core.run_cell(cell, 20231, 0.2, True, device='cpu', root=tiny_root)
    out = seen['out']
    for name in READ[cell]:
        found = spans.window_spans(out, name)
        assert found, name
        assert all(out.window_start <= s['start_s'] <= out.window_start
                   + out.observed['window_s'] for s in found)
    steps = spans.window_spans(out, 'train.step') or []
    assert len(steps) == (out.attempted if cell == 'tiny-train' else 0)
    names = [m['name'] for m in core.resolve(cell, tiny_root).per_layer]
    for metric in HOST_ONLY & set(names):
        assert math.isfinite(line['metrics'][metric]['value']), metric
    # no device time on the CPU: the device readers find nothing
    assert not set(line['metrics']) & {'nms.proposal_ms_per_batch.infer',
                                       'predictor.to_frame_ms_per_batch.infer'}
