'''The port's YAML emitter and reader (``io/yaml_subset.py``, through
``io/util.write_yaml`` and ``read_yaml``) against PyYAML.

The emitter's output loads with PyYAML to the sanitized dict (numpy values
as Python's, tuples as lists); the reader reads the emitter's output, what
PyYAML's ``safe_dump`` writes for the extract command's defaults (the
``generate-extract-config`` file that ``--config-file`` reads) and the status
file of the JAX package, with PyYAML's values. Strings that YAML would read
as something else are quoted.
'''
import math
import uuid

import numpy as np
import pytest
import yaml

from moseq2_detectron_extract_tpu.cli import extract as jax_extract_command
from moseq2_detectron_extract_tpu.io.click import click_param_annot, get_command_defaults
from moseq2_detectron_extract_tpu.io.util import write_yaml as jax_write_yaml
from moseq2_detectron_extract_tpu_torch.io import yaml_subset
from moseq2_detectron_extract_tpu_torch.io.util import _sanitize_for_yaml, read_yaml, write_yaml
from moseq2_detectron_extract_tpu_torch.models.config import parse_config_yaml

AWKWARD = ['yes', 'No', 'ON', 'off', 'null', 'Null', '~', '', ' lead', 'trail ', 'a: b',
           'x #y', 'key:', '1e3', '1.5', '0650', '0x1F', '0b101', '1:20', '+1', '-7', '.inf',
           '.nan', '2026-01-01', '2026-01-01 10:00:00', "it's", 'say "hi"', 'a\nb', 'tab\t',
           'déjà vu', '- item', '*alias', '&anchor', '!tag', '@at', '%pct', '|', '>', '[x]',
           '{y}', 'a,b', '?', '#c', 'true', 'y', 'n', 'plain text', '/tmp/x.dat', 'C:\\dir']


def _same(a, b):
    '''Equal values of equal types, NaN equal to NaN.'''
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def status_like():
    '''A status dict as extract_session writes it, numpy values included.'''
    annotations = click_param_annot(jax_extract_command)
    return {
        'complete': True, 'skip': False, 'uuid': uuid.UUID(int=12345),
        'metadata': {'SubjectName': 'mouse 7', 'SessionName': 'session: 1',
                     'StartTime': '2026-01-01T10:00:00', 'DepthResolution': [512, 424],
                     'NidaqChannels': 0, 'NidaqSamplingRate': 0.0, 'IsLittleEndian': True,
                     'ColorResolution': [], 'Empty': {}, 'Note': None},
        'parameters': {'bg_roi_dilate': (10, 10), 'bg_roi_weights': (1, .1, 1),
                       'min_height': np.int64(0), 'max_height': np.float32(100.5),
                       'instance_threshold': 0.5, 'output_dir': '/data/proc',
                       'model': None, 'use_tracking': np.bool_(True),
                       'frame_trim': np.array([0, 0]), 'param_annotations': annotations,
                       'nested': [[1, 2], [3.5, float('nan')], {'a': [True, None]}],
                       'limits': [float('inf'), -float('inf'), 1e-5, 1e16, -0.0]},
        'stage_stats': {'Read Depth Data': {'busy_s': 1.234, 'cpu_s': 0.9, 'chunks': 2},
                        'Process Features': {'busy_s': 0.5, 'cpu_s': 0.4, 'chunks': 2,
                                             'sub_times': {'em_init': 0.25}}},
    }


def test_emitter_output_loads_with_pyyaml_to_the_sanitized_dict(tmp_path):
    data = status_like()
    path = str(tmp_path / 'status.yaml')
    write_yaml(path, data)
    with open(path, encoding='utf-8') as fh:
        loaded = yaml.safe_load(fh)
    assert _same(loaded, _sanitize_for_yaml(data))


def test_reader_reads_the_emitters_output(tmp_path):
    data = status_like()
    path = str(tmp_path / 'status.yaml')
    write_yaml(path, data)
    assert _same(read_yaml(path), _sanitize_for_yaml(data))


def test_emitter_layout_is_safe_dumps(tmp_path):
    '''Block style, sorted keys, lists at their key's indent: the same text
    as PyYAML's ``safe_dump`` wherever PyYAML neither wraps a line nor picks
    another quoting.'''
    data = {'b': [1, [2, 3], {'x': 'y', 'z': [True, None]}], 'a': {'c': 1.5, 'd': []},
            'e': {}, 'f': 'plain', 'g': 1e-05}
    assert yaml_subset.dump(data) == yaml.safe_dump(data)


def test_reader_reads_safe_dump_of_the_extract_defaults(tmp_path):
    '''What ``generate-extract-config`` writes (PyYAML) is what
    ``--config-file`` reads.'''
    defaults = get_command_defaults(jax_extract_command)
    path = str(tmp_path / 'config.yaml')
    jax_write_yaml(path, defaults)
    with open(path, encoding='utf-8') as fh:
        expected = yaml.safe_load(fh)
    assert _same(read_yaml(path), expected)
    assert read_yaml(path)['bg_roi_weights'] == [1, 0.1, 1]


def test_reader_reads_a_status_file_the_jax_package_wrote(tmp_path):
    '''The JAX package's ``write_yaml`` (PyYAML, which folds the long help
    strings onto several lines) of a status dict.'''
    path = str(tmp_path / 'results_00.yaml')
    jax_write_yaml(path, status_like())
    with open(path, encoding='utf-8') as fh:
        text = fh.read()
        expected = yaml.safe_load(text)
    assert any(line.startswith('    ') and ':' not in line for line in text.splitlines())
    assert _same(read_yaml(path), expected)


@pytest.mark.parametrize('text', AWKWARD, ids=[repr(t) for t in AWKWARD])
def test_awkward_strings_round_trip(text):
    dumped = yaml_subset.dump({'k': text, 'list': [text], text: 1})
    assert yaml.safe_load(dumped) == {'k': text, 'list': [text], text: 1}
    assert yaml_subset.load(dumped) == {'k': text, 'list': [text], text: 1}


@pytest.mark.parametrize('text', ['yes', 'null', '1e3', '0650', 'a: b', ' lead', '', '1.5',
                                  '2026-01-01', 'On', '~'])
def test_strings_yaml_would_read_otherwise_are_quoted(text):
    assert yaml_subset.format_scalar(text)[0] in '\'"'


@pytest.mark.parametrize('text,value', [
    ('yes', True), ('No', False), ('on', True), ('OFF', False), ('y', 'y'), ('~', None),
    ('null', None), ('0650', 424), ('0x1F', 31), ('0b101', 5), ('1_000', 1000), ('1:20', 80),
    ('-7', -7), ('1e3', '1e3'), ('1.0e+3', 1000.0), ('1.5', 1.5), ('.5', 0.5), ('-.inf', -math.inf),
    ('2026-01-01', '2026-01-01'), ('plain text', 'plain text'), ("'it''s'", "it's"),
    ('"a\\tb\\u00e9"', 'a\tb\u00e9'), ('[1, [2, a], \'c, d\']', [1, [2, 'a'], 'c, d']),
    ('[]', []), ('{}', {})])
def test_scalars_resolve_as_safe_load(text, value):
    expected = yaml.safe_load(f'k: {text}\n')['k']
    if text == '2026-01-01':
        # PyYAML makes a date of a plain date; the port keeps the text
        assert str(expected) == value
    else:
        assert _same(expected, value)
    assert _same(yaml_subset.load(f'k: {text}\n')['k'], value)


def test_floats_and_specials_round_trip():
    values = [0.1, 1e-5, 1e16, -2.5, 3.0, float('inf'), -float('inf'), 1.7976931348623157e308]
    text = yaml_subset.dump({'v': values, 'nan': float('nan')})
    for loaded in (yaml.safe_load(text), yaml_subset.load(text)):
        assert loaded['v'] == values and math.isnan(loaded['nan'])


def test_comments_documents_and_indented_lists():
    text = ('--- # a document\n'
            'a: 1  # one\n'
            '# a comment line\n'
            'b:\n'
            '    - x\n'
            '    -   - 2\n'
            '        - 3\n'
            'c:\n'
            '  d: e # f\n'
            '  g:\n'
            '  - h: 1\n'
            '    i: [1, 2]\n'
            '...\n')
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize('text', ['a: &x 1\n', 'a: *x\n', 'a: !!str 1\n', 'a: |\n  b\n',
                                  'a: {b: 1}\n', 'a: 1\na: 2\n', "a: 'open\n"])
def test_unsupported_or_bad_yaml_raises(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


def test_model_config_reader_still_refuses_nested_mappings():
    '''The model config's reader is the same parser, held to a flat mapping.'''
    assert parse_config_yaml('a: 1\nb:\n- - 2\n  - 3\n') == {'a': 1, 'b': [[2, 3]]}
    with pytest.raises(ValueError):
        parse_config_yaml('a:\n  b: 1\n')
