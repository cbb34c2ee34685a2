'''The manifest meets the benchmark's contract, and every cell, configuration,
traffic mix and metric resolves by name; a cell added as files runs
without an edit to any file that is there.'''
import json
import os
import re
import shutil

import pytest

from portbench import core

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
MANIFEST = core.load_manifest()


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                             'end_to_end', 'per_layer'}
    assert MANIFEST['command'] == ['python3', 'portbench/run.py']
    assert MANIFEST['paths'] == ['portbench']
    assert isinstance(MANIFEST['run_seconds'], int) and 1 <= MANIFEST['run_seconds'] <= 51
    names = [e['name'] for key in ('configs', 'workloads', 'end_to_end', 'per_layer')
             for e in MANIFEST[key]]
    assert all(NAME.match(n) for n in names)
    for key in ('configs', 'workloads'):
        assert len({e['name'] for e in MANIFEST[key]}) == len(MANIFEST[key])
    metrics = [m['name'] for m in MANIFEST['end_to_end'] + MANIFEST['per_layer']]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_configs_are_used_and_their_files_hold_the_model():
    used = {w['config'] for w in MANIFEST['workloads']}
    for conf in MANIFEST['configs']:
        assert set(conf) == {'name', 'source', 'file', 'reduced', 'why'}
        assert conf['name'] in used
        assert conf['file'].startswith('portbench/')
        body = core.read_json(os.path.join(core.ROOT, conf['file']))
        assert set(conf['reduced']) <= set(body)
        assert not any(k.endswith(('_dim', '_rank', '_dims', '_width', 'channels'))
                       for k in conf['reduced'])
        assert os.path.isfile(os.path.join(core.ROOT, body['model_dir'], 'params_f16.npz'))


def test_metrics_shape():
    e2e = {m['name']: m for m in MANIFEST['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in MANIFEST['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    layers = {}
    for m in MANIFEST['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert m['moves'] in e2e and UNIT.match(m['unit'])
        for cell in m['workloads']:
            # a per-layer metric is reported only where the metric it moves is
            assert core.applies(e2e[m['moves']], cell, [])
        layers.setdefault(m['layer'], m['layer'])
        if m['name'].endswith('_roofline') or '_roofline.' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('cell', [w['name'] for w in MANIFEST['workloads']])
def test_every_cell_resolves(cell):
    resolved = core.resolve(cell)
    assert resolved.entry['chips'] in (1, 4)
    assert hasattr(resolved.driver, 'run')
    assert resolved.limits['limits']
    names = [m['name'] for m in resolved.end_to_end]
    assert 'setup_s' in names and len(names) >= 2
    assert resolved.per_layer
    assert os.path.isdir(resolved.model_dir)


@pytest.mark.parametrize('metric', [m['name'] for m in MANIFEST['per_layer']])
def test_every_reader_finds_nothing_in_an_empty_run(metric):
    reader = core.load_module(os.path.join(core.PKG_DIR, 'metrics', metric + '.py'), metric)
    ctx = core.Context(cell=None, seed=0, seconds=1, trace=True, t0=0.0,
                       kind='NVIDIA H100 80GB HBM3')
    out = core.Outcome(window_start=0.0, e2e={}, attempted=0, failed=0, memory_peak_bytes=0,
                       checks=[])
    assert reader.read(ctx, out) is None


def test_a_cell_added_as_files(tmp_path, tiny_root):
    '''A throwaway cell, traffic mix and metric, all new files in a copy of
    the checkout, resolve and report without an edit to the harness.'''
    root = str(tmp_path / 'checkout')
    shutil.copytree(tiny_root, root, symlinks=True)
    bench = os.path.join(root, 'portbench')
    traffic = core.read_json(os.path.join(bench, 'traffic', 'tiny-chunks.json'))
    traffic['samples_per_chunk'] = 2
    with open(os.path.join(bench, 'traffic', 'tiny-chunks-2.json'), 'w') as fh:
        json.dump(traffic, fh)
    shutil.copy(os.path.join(bench, 'workloads', 'tiny-infer.json'),
                os.path.join(bench, 'workloads', 'tiny-infer-2.json'))
    with open(os.path.join(bench, 'metrics', 'chunks.count.infer.py'), 'w') as fh:
        fh.write("def read(ctx, out):\n    return out.observed.get('chunks')\n")
    manifest = core.read_json(os.path.join(root, 'BENCHMARK.json'))
    manifest['workloads'].append({'name': 'tiny-infer-2', 'config': 'tiny', 'chips': 1,
                                  'traffic': 'tiny-chunks-2', 'why': 'test'})
    for m in manifest['end_to_end']:
        if m['name'] == 'infer_fps':
            m['workloads'].append('tiny-infer-2')
    manifest['per_layer'].append({'name': 'chunks.count.infer', 'unit': 'chunks',
                                  'better': 'higher', 'source': 'host_clock',
                                  'layer': 'Chunk entry', 'moves': 'infer_fps',
                                  'workloads': ['tiny-infer-2']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as fh:
        json.dump(manifest, fh)
    cell = core.resolve('tiny-infer-2', root)
    assert [m['name'] for m in cell.per_layer] == ['chunks.count.infer']
    line = core.run_cell('tiny-infer-2', 7, 0.2, True, device='cpu', root=root)
    assert line['metrics']['chunks.count.infer']['value'] >= 1
    assert list(line)[-1] == 'checks'


def test_missing_files_give_no_result(tmp_path):
    '''In a folder that holds only the manifest and the harness, the model
    folders are missing: a set-up error, no result.'''
    root = str(tmp_path)
    shutil.copy(os.path.join(core.ROOT, 'BENCHMARK.json'), root)
    shutil.copytree(core.PKG_DIR, os.path.join(root, 'portbench'),
                    ignore=shutil.ignore_patterns('data', '__pycache__'))
    with pytest.raises(core.SetupError):
        core.run_cell(MANIFEST['workloads'][0]['name'], 1, 0.1, False, device='cpu', root=root)


@pytest.mark.parametrize('conf', MANIFEST['configs'], ids=lambda c: c['name'])
def test_the_program_runs_the_configuration_file(conf):
    '''The model folder's config.yaml with the file's values set over it is
    the file, key for key; the keys it sets are named in the file.'''
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    body = core.read_json(os.path.join(core.ROOT, conf['file']))
    loaded = ModelConfig.from_yaml(os.path.join(core.ROOT, body['model_dir'], 'config.yaml'))
    cfg, changed = core.program_config(loaded, body)
    core.verify_config(cfg, body)
    assert all(key in body['source_values'] for key in changed)
