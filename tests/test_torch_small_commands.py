'''The small commands and the allocator tuning, on the CPU against the JAX
package.

* ``generate-extract-config``: the port's YAML holds the JAX package's keys
  and values (``device``, the port's own, the one extra key), and the
  port's ``extract --config-file`` reads it back to the defaults;
* ``dataset-info``: the same report logged as the JAX package's command on
  a synthetic Label Studio export;
* ``system-info``: versions, and the device table only where CUDA is (here
  there is none, and it says so; a card stubbed in shows its line);
* ``utils/hostmem.py:tune_host_allocator``: what the JAX package's returns,
  idempotent, and the first thing ``extract_session`` does;
* the command table: all 19 of the JAX package's commands.
'''
import logging
import os

import pytest
import yaml
from click.testing import CliRunner

from moseq2_detectron_extract_tpu.cli import cli as jax_cli
from moseq2_detectron_extract_tpu_torch import cli

LEFT = set()            # extract-batch, the last, is ported


def test_generate_extract_config_equals_jax(tmp_path):
    ours, ref = str(tmp_path / 'ours.yaml'), str(tmp_path / 'ref.yaml')
    assert cli.main(['generate-extract-config', '-o', ours]) == 0
    assert CliRunner().invoke(jax_cli, ['generate-extract-config', '-o', ref]).exit_code == 0
    with open(ours, encoding='utf-8') as fh:
        got = yaml.safe_load(fh)
    with open(ref, encoding='utf-8') as fh:
        expect = yaml.safe_load(fh)
    assert set(got) - set(expect) == {'device'} and got['device'] == 'cuda'
    assert set(expect) <= set(got)
    for key, value in expect.items():
        assert got[key] == value, key
    # read back through extract's --config-file: every option at its default
    from moseq2_detectron_extract_tpu_torch.io.options import apply_config_file
    dat = str(tmp_path / 'depth.dat')
    open(dat, 'wb').close()
    parser = cli.extract_parser()
    defaults = vars(parser.parse_args([dat]))
    argv = [dat, '--config-file', ours]
    args = parser.parse_args(argv)
    apply_config_file(parser, args, argv)
    assert dict(vars(args), config_file=None) == defaults


def _messages(records):
    return [r.getMessage() for r in records if r.name == 'root']


def test_dataset_info_equals_jax(tmp_path, caplog, monkeypatch):
    import moseq2_detectron_extract_tpu.cli as jax_cli_module
    from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views
    export = write_annotated_views(str(tmp_path / 'views'), 12, size=64, seed=0)
    # each command's setup_logging would take caplog's handler off the root logger
    for module in (cli, jax_cli_module):
        monkeypatch.setattr(module, 'setup_logging', lambda *args, **kwargs: None)
    with caplog.at_level(logging.INFO):
        assert cli.main(['dataset-info', export]) == 0
        ours = _messages(caplog.records)
        caplog.clear()
        assert CliRunner().invoke(jax_cli, ['dataset-info', export]).exit_code == 0
        ref = _messages(caplog.records)
    assert len(ours) > 5 and ours == ref
    assert any('Number of Items: 12' in m for m in ours)


def test_system_info_without_a_card(capsys):
    import numpy as np
    import torch
    assert not torch.cuda.is_available()
    assert cli.main(['system-info']) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('moseq2-detectron-extract-tpu-torch: ')
    assert f'torch: {torch.__version__}' in lines and f'numpy: {np.__version__}' in lines
    assert lines[-1] == 'no CUDA device'
    assert not any('device 0' in line for line in lines)


def test_system_info_lists_each_card(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i: 'NVIDIA H100 80GB HBM3')
    monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda i: (60 * 2 ** 30, 80 * 2 ** 30))
    assert cli.main(['system-info']) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        '  device 0: NVIDIA H100 80GB HBM3 (20.00/80.00 GiB)'


def test_tune_host_allocator_equals_jax_and_runs_first(monkeypatch):
    from moseq2_detectron_extract_tpu.utils.hostmem import tune_host_allocator as jtune
    from moseq2_detectron_extract_tpu_torch import extract
    from moseq2_detectron_extract_tpu_torch.utils import hostmem
    assert hostmem.tune_host_allocator() == jtune() is True
    assert hostmem.tune_host_allocator() is True

    class First(Exception):
        pass

    def called():
        raise First()

    monkeypatch.setattr(extract, 'tune_host_allocator', called)
    with pytest.raises(First):
        extract.extract_session(None, {})


def test_the_port_runs_16_of_the_19_commands(capsys):
    assert len(jax_cli.commands) == 19
    assert set(cli.COMMANDS) == set(jax_cli.commands) - LEFT
    assert cli.main(['no-such-command']) == 2
    err = capsys.readouterr().err
    assert all(name in err for name in cli.COMMANDS), err
    assert cli.main(['trim-result']) == 2          # argparse's exit code, returned
    assert os.path.exists(cli.__file__)
