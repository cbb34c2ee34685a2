'''The port's recorder of spans and counters (``utils/profiling.py``) and
what it records on the main path, on the CPU.

* The recorder: nesting, parents, roots and self time; spans of two
  threads at once, and of more threads than cores under contention; the
  ring's bound; counters credited to the innermost
  open span; a span closed by an exception; the read's interval.
* ``torch.export`` traces through a span and records nothing; the
  exported program runs.
* ``torch_trace``: each span a user annotation in ``trace.json`` and the
  block's spans in ``spans.json``; a ``torch.profiler`` session opened
  outside it sees no span. ``enable_profiling`` writes the spans by name.
* ``StageTimer`` as before, its stages also spans; the pipeline steps'
  ``sub_times`` keep their keys; a pipeline item is the root span
  ``stage.<step name>``.
* The main path: a chunk through ``process_chunk`` (the detector's stages
  under each numbered ``predictor.batch``, the NMS syncs split between the
  proposal and the box NMS) and two training steps (``train.step`` with its
  CPU time, the loader's batches and reads).
'''
import json
import queue
import threading
import time

import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu_torch.ops import nms
from moseq2_detectron_extract_tpu_torch.utils import profiling
from moseq2_detectron_extract_tpu_torch.utils.profiling import (Recorder, StageTimer, span,
                                                                torch_trace)


def _by_name(records):
    return {r['name']: r for r in records}


def test_nesting_parents_roots_and_self_time():
    rec = Recorder()
    with rec.span('outer'):
        time.sleep(0.01)
        with rec.span('a', indexed=True):
            time.sleep(0.02)
        with rec.span('b', indexed=True):
            with rec.span('leaf'):
                time.sleep(0.01)
    with rec.span('second'):
        pass
    got = _by_name(rec.spans())
    outer, a, b, leaf, second = (got[k] for k in ('outer', 'a', 'b', 'leaf', 'second'))
    assert outer['parent'] is None and outer['root'] == outer['id']
    assert a['parent'] == outer['id'] and b['parent'] == outer['id']
    assert leaf['parent'] == b['id'] and leaf['root'] == outer['id']
    assert second['root'] == second['id'] != outer['id']
    # indexed spans are numbered among their parent's; their children inherit it
    assert (a['batch'], b['batch'], leaf['batch'], outer['batch']) == (0, 1, 1, None)
    assert outer['self_ms'] == pytest.approx(outer['host_ms'] - a['host_ms'] - b['host_ms'])
    assert 9 <= outer['self_ms'] < outer['host_ms'] - 25
    assert b['self_ms'] == pytest.approx(b['host_ms'] - leaf['host_ms'])
    # on the CPU no span has device time
    assert all(r['device_ms'] is None and r['cpu_ms'] is None for r in got.values())


def test_read_interval_and_names():
    rec = Recorder()
    with rec.span('early'):
        pass
    t0 = time.perf_counter()
    with rec.span('late'):
        pass
    with rec.span('late'):
        pass
    t1 = time.perf_counter()
    assert [r['name'] for r in rec.spans(t0, t1)] == ['late', 'late']
    assert [r['name'] for r in rec.spans(None, t0)] == ['early']
    assert rec.spans(t0, t1, 'early') == []
    assert rec.spans(t1 + 1.0) == []


def test_two_threads_at_once():
    rec = Recorder()
    barrier = threading.Barrier(2)

    def work(tag):
        for _ in range(50):
            with rec.span('root.' + tag):
                barrier.wait()
                with rec.span('child.' + tag):
                    rec.count('n.' + tag)
                    barrier.wait()
    threads = [threading.Thread(target=work, args=(t,), name='worker-' + t) for t in 'xy']
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    records = rec.spans()
    assert len(records) == 200
    by_id = {r['id']: r for r in records}
    for r in records:
        tag = r['name'][-1]
        assert r['thread'] == 'worker-' + tag
        if r['name'].startswith('child'):
            parent = by_id[r['parent']]
            assert parent['name'] == 'root.' + tag and r['root'] == parent['id']
            assert r['counters'] == {'n.' + tag: 1}
        else:
            assert r['parent'] is None and r['counters'] == {}
    assert rec.counters() == {'n.x': 50, 'n.y': 50}
    assert len({r['id'] for r in records}) == 200


def test_counts_lose_no_update_under_contention():
    '''More threads than cores, switching as often as the interpreter
    allows: every increment is in the total and in its span.'''
    import os
    import sys
    rec = Recorder()
    n_threads, rounds = 2 * (os.cpu_count() or 4), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with rec.span('stress'):
                    rec.count('hits')
                    rec.count('hits')
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    records = rec.spans()
    assert rec.counters() == {'hits': 2 * n_threads * rounds}
    assert len(records) == n_threads * rounds
    assert all(r['counters'] == {'hits': 2} for r in records)
    assert len({r['id'] for r in records}) == len(records)


def test_ring_is_bounded():
    rec = Recorder(capacity=8)
    for i in range(20):
        with rec.span(f's{i}'):
            pass
    records = rec.spans()
    assert [r['name'] for r in records] == [f's{i}' for i in range(12, 20)]


def test_counters_credit_the_innermost_open_span():
    rec = Recorder()
    rec.count('c')                                   # no span open: the total only
    with rec.span('a'):
        rec.count('c', 2)
        with rec.span('b'):
            rec.count('c')
            rec.count('d', 5)
    got = _by_name(rec.spans())
    assert got['a']['counters'] == {'c': 2}
    assert got['b']['counters'] == {'c': 1, 'd': 5}
    assert rec.counters() == {'c': 4, 'd': 5}


def test_nms_syncs_are_counted_in_the_open_span():
    g = torch.Generator().manual_seed(3)
    xy = torch.rand((2, 40, 2), generator=g) * 50
    boxes = torch.cat([xy, xy + 5 + torch.rand((2, 40, 2), generator=g) * 20], -1)
    scores = torch.rand((2, 40), generator=g)
    before, t0 = nms.sync_count, time.perf_counter()
    with span('test.nms'):
        nms.nms_keep_mask(boxes, scores, 0.5)
    syncs = nms.sync_count - before
    (got,) = profiling.spans(t0, time.perf_counter(), 'test.nms')
    assert syncs >= 2 and got['counters'] == {'nms.sync': syncs}


def test_an_exception_closes_its_spans():
    rec = Recorder()
    with pytest.raises(KeyError):
        with rec.span('outer'):
            with rec.span('inner'):
                raise KeyError('stop')
    with rec.span('after'):
        pass
    got = _by_name(rec.spans())
    assert got['inner']['parent'] == got['outer']['id']
    assert got['after']['parent'] is None                # the stack was unwound


class _Spanned(torch.nn.Module):
    def forward(self, x):
        with span('test.export.inner'):
            return x * 2 + 1


def test_export_traces_through_spans():
    t0 = time.perf_counter()
    program = torch.export.export(_Spanned(), (torch.ones(3),))
    t1 = time.perf_counter()
    assert profiling.spans(t0, t1, 'test.export.inner') == []
    np.testing.assert_array_equal(program.module()(torch.arange(3.0)).numpy(), [1, 3, 5])
    _Spanned()(torch.ones(1))
    assert len(profiling.spans(t1, time.perf_counter(), 'test.export.inner')) == 1


def _trace_names(path):
    with open(path, encoding='utf-8') as fh:
        events = json.load(fh)['traceEvents']
    return {e['name']: e.get('cat') for e in events if 'name' in e}


def test_torch_trace_annotates_spans_and_writes_spans_json(tmp_path):
    with torch_trace(str(tmp_path), cuda=False):
        with span('test.trace.outer'):
            with span('test.trace.inner'):
                profiling.count('test.trace.count', 3)
                torch.ones(8).add_(1)
    names = _trace_names(str(tmp_path / 'trace.json'))
    assert names['test.trace.outer'] == 'user_annotation'
    assert names['test.trace.inner'] == 'user_annotation'
    with open(tmp_path / 'spans.json', encoding='utf-8') as fh:
        written = json.load(fh)
    got = _by_name(written['spans'])
    assert got['test.trace.inner']['parent'] == got['test.trace.outer']['id']
    for key in ('host_ms', 'self_ms', 'device_ms', 'id', 'root', 'thread'):
        assert key in got['test.trace.outer']
    assert written['counters'] == {'test.trace.count': 3}
    assert written['summary']['test.trace.inner']['count'] == 1
    assert written['summary']['test.trace.inner']['counters'] == {'test.trace.count': 3}


def test_enable_profiling_writes_the_spans_by_name(tmp_path):
    import os
    import subprocess
    import sys
    prefix = str(tmp_path / 'prof')
    script = ('from moseq2_detectron_extract_tpu_torch.utils import profiling\n'
              f'profiling.enable_profiling({prefix!r})\n'
              'for _ in range(3):\n'
              '    with profiling.span("test.profile.outer"):\n'
              '        profiling.count("test.profile.count")\n')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    subprocess.run([sys.executable, '-c', script], check=True, env=env, timeout=300,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(prefix + '.spans.json', encoding='utf-8') as fh:
        written = json.load(fh)
    row = written['spans']['test.profile.outer']
    assert row['count'] == 3 and row['counters'] == {'test.profile.count': 3}
    assert set(row['host_ms']) == {'total', 'median', 'p90'} and 'self_ms' in row
    assert written['counters'] == {'test.profile.count': 3}
    assert os.path.getsize(prefix + '.prof_stats') > 0


def test_no_annotation_outside_torch_trace():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with span('test.plain.outer'):
            torch.ones(8).add_(1)
    names = {e.name for e in prof.events()}
    assert 'aten::add_' in names and 'test.plain.outer' not in names


def test_stage_timer_reads_as_before_and_records_spans():
    t0 = time.perf_counter()
    timer = StageTimer()
    with timer.time('a'):
        time.sleep(0.002)
    with timer.time('a'):
        pass
    assert timer.counts == {'a': 2} and set(timer.summary()) == {'a'}
    recorded = profiling.spans(t0, time.perf_counter(), 'a')
    assert len(recorded) == 2
    assert timer.totals['a'] == pytest.approx(sum(r['host_ms'] for r in recorded) / 1e3,
                                              rel=0.05)
    laps = StageTimer('lap.', stages=('x',))
    assert laps.totals == {'x': 0.0} and laps.summary() == {'x': 0.0}
    laps.start()
    laps.lap('x')
    laps.lap('y')
    assert laps.counts == {'x': 1, 'y': 1}
    assert {r['name'] for r in profiling.spans(t0, time.perf_counter())} >= {'lap.x', 'lap.y'}


def test_pipeline_steps_sub_times_keep_their_keys():
    from moseq2_detectron_extract_tpu_torch.proc import features
    from moseq2_detectron_extract_tpu_torch.pipeline import steps
    preview = steps.PreviewVideoWriterStep('Preview Video', {'min_height': 0.0,
                                                             'max_height': 100.0})
    preview.initialize()
    assert preview.sub_times == {'marshal': 0.0, 'render': 0.0}
    brain = steps.ProcessFeaturesStep('Process Features', {'use_tracking': False})
    brain.initialize()
    assert brain.sub_times == {}
    yy, xx = np.mgrid[:48, :48]
    masks = torch.from_numpy(((yy - 24) ** 2 / 100 + (xx - 20) ** 2 / 300 < 1)[None]
                             .repeat(4, 0))
    raw = masks.float() * 30
    kpts = np.zeros((4, 8, 3), 'float32')
    kpts[:, :, 0] = np.linspace(5, 35, 8)
    kpts[:, :, 1] = 24
    t0 = time.perf_counter()
    features.instances_to_features(masks, kpts, np.ones(4, int), raw, None, None,
                                   timers=brain.timer)
    stages = {'itf_moments', 'itf_flip_votes', 'itf_angle_filter'}
    assert set(brain.sub_times) == stages
    assert all(v >= 0 for v in brain.sub_times.values())
    names = {r['name'] for r in profiling.spans(t0, time.perf_counter())}
    assert {'features.' + s for s in stages} <= names


def test_a_pipeline_item_is_a_root_span():
    from moseq2_detectron_extract_tpu_torch.pipeline.pipeline_step import PipelineStep

    class Double(PipelineStep):
        def process(self, data):
            with span('test.stage.work'):
                return data * 2
    step = Double('  Double It', {})
    step.input_queue, step.shutdown_event = queue.Queue(), threading.Event()
    out = queue.Queue()
    step.output_queues = [out]
    for item in (1, 2, None):
        step.input_queue.put(item)
    t0 = time.perf_counter()
    step.run()
    assert step.error_info is None and [out.get(), out.get(), out.get()] == [2, 4, None]
    records = profiling.spans(t0, time.perf_counter())
    roots = [r for r in records if r['name'] == 'stage.Double It']
    work = [r for r in records if r['name'] == 'test.stage.work']
    assert len(roots) == 2 and all(r['parent'] is None for r in roots)
    assert sorted(w['parent'] for w in work) == sorted(r['id'] for r in roots)
    assert step.items_processed == 2 and step.busy_seconds > 0


def _tiny_cfg(**overrides):
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    base = dict(image_size=64, min_size_train=60, max_size_train=64, min_size_test=64,
                max_size_test=64, resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16,
                fpn_channels=32, box_fc_dim=32, mask_conv_dims=(32,),
                keypoint_conv_dims=(32,), rpn_pre_nms_topk_test=32,
                rpn_post_nms_topk_test=8, test_detections_per_image=1,
                rpn_pre_nms_topk_train=128, rpn_post_nms_topk_train=64,
                roi_batch_size_per_image=32, ims_per_batch=2, max_gt_instances=1,
                amp_dtype='float32', warmup_iters=2, checkpoint_period=100, max_iter=2)
    base.update(overrides)
    return ModelConfig(**base)


DETECTOR = ['predictor.resize_in', 'detector.backbone', 'detector.rpn_head',
            'detector.proposal_nms', 'detector.box_head', 'detector.box_nms',
            'detector.mask_head', 'detector.keypoint_head', 'predictor.to_frame']


def test_a_chunk_records_the_detector_stages():
    from moseq2_detectron_extract_tpu_torch.extract import process_chunk
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk
    torch.manual_seed(0)
    cfg = _tiny_cfg()
    pred = Predictor(cfg, MaskKeypointRCNN(cfg).state_dict(), batch_size=2,
                     score_threshold=0.0, device='cpu')
    chunk = make_sentinel_chunk(5, 80, 96, seed=0)
    before, t0 = nms.sync_count, time.perf_counter()
    process_chunk(chunk, pred, {})
    records = profiling.spans(t0, time.perf_counter())
    (root,) = [r for r in records if r['name'] == 'chunk']
    assert root['parent'] is None
    mine = [r for r in records if r['root'] == root['id']]
    batches = sorted((r for r in mine if r['name'] == 'predictor.batch'),
                     key=lambda r: r['batch'])
    assert [b['batch'] for b in batches] == [0, 1, 2]
    assert all(b['parent'] == root['id'] for b in batches)
    for b in batches:
        inside = [r['name'] for r in mine if r['parent'] == b['id']]
        assert sorted(inside) == sorted(DETECTOR)
    names = {r['name'] for r in mine if r['parent'] == root['id']}
    assert {'chunk.select.fetch', 'chunk.select.track', 'chunk.window_features'} <= names
    syncs = {k: sum(r['counters'].get('nms.sync', 0) for r in mine if r['name'] == k)
             for k in ('detector.proposal_nms', 'detector.box_nms')}
    assert min(syncs.values()) >= 3                      # a sync a round, per batch
    assert sum(syncs.values()) == nms.sync_count - before


def test_training_steps_record_their_stages(tmp_path):
    from moseq2_detectron_extract_tpu_torch.io.annot import load_annotations_helper
    from moseq2_detectron_extract_tpu_torch.models.trainer import Trainer
    from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views
    export = write_annotated_views(str(tmp_path / 'data'), 4, size=64, seed=0)
    items = load_annotations_helper([export], 'RGB', register=False, show_info=False)
    trainer = Trainer(_tiny_cfg(), str(tmp_path / 'model'), train_items=items, test_items=[],
                      device='cpu')
    trainer.resume_or_load()
    t0 = time.perf_counter()
    trainer.train()
    records = profiling.spans(t0, time.perf_counter())
    steps = [r for r in records if r['name'] == 'train.step']
    assert len(steps) == 2 and all(s['parent'] is None and s['cpu_ms'] > 0 for s in steps)
    for s in steps:
        inside = {r['name'] for r in records if r['parent'] == s['id']}
        assert inside == {'train.wait_batch', 'train.to_device', 'train.augment',
                          'train.forward', 'train.backward', 'train.optimizer'}
        (fwd,) = [r for r in records if r['parent'] == s['id'] and r['name'] == 'train.forward']
        under = {r['name'] for r in records if r['parent'] == fwd['id']}
        assert {'detector.backbone', 'detector.proposal_nms'} <= under
    loads = [r for r in records if r['name'] == 'loader.batch']
    assert loads and all(r['thread'] != steps[0]['thread'] for r in loads)
    read = sum(r['counters'].get('loader.samples_read', 0) for r in loads)
    assert 1 <= read <= 4                                   # each view read once
