'''``extract-batch`` on the CPU, against the JAX package's command.

* Emit mode: over a tree of sessions (an unextracted ``depth.dat``, one
  whose status says ``complete: true``, a ``.tar.gz`` session, and a
  ``depth.avi`` session beside the port's own preview AVI), the port prints
  the JAX command's lines with ``python -m
  moseq2_detectron_extract_tpu_torch.cli`` where the JAX package prints
  ``moseq2-detectron-extract-tpu``, locally and as ``sbatch`` jobs with a
  prefix. With ``--extension .avi`` the port lists the ``depth.avi``
  session and not the preview ``results_00.avi``, which the JAX scan takes
  for a session too.
* ``--in-process --device cpu --max-concurrent 2``: two sessions at once,
  a good one (complete) and a broken one (exit code 1, reported as FAILED);
  run again, the complete session is not listed.

About 15 s on the CPU.
'''
import os
import tarfile

import pytest
from click.testing import CliRunner

from moseq2_detectron_extract_tpu.cli import cli as jax_cli
from moseq2_detectron_extract_tpu_torch import cli
from moseq2_detectron_extract_tpu_torch.io.util import read_yaml, write_yaml

from tests.test_torch_eval import tiny_model_dir
from tests.test_torch_parallel import _session

PORT_CMD = 'python -m moseq2_detectron_extract_tpu_torch.cli'
JAX_CMD = 'moseq2-detectron-extract-tpu'


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, 'wb').close()
    return path


@pytest.fixture()
def tree(tmp_path):
    root = tmp_path / 'data'
    _touch(str(root / 'a' / 'depth.dat'))
    _touch(str(root / 'b' / 'depth.dat'))
    write_yaml(_touch(str(root / 'b' / 'proc' / 'results_00.yaml')), {'complete': True})
    _touch(str(root / 'c' / 'depth.avi'))
    _touch(str(root / 'c' / 'proc' / 'results_00.avi'))
    os.makedirs(str(root / 'd'))
    with tarfile.open(str(root / 'd' / 'sess.tar.gz'), 'w:gz'):
        pass
    return str(root), str(tmp_path / 'model')


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def _jax_lines(args):
    result = CliRunner().invoke(jax_cli, ['extract-batch'] + args)
    assert result.exit_code == 0, result.output
    return [line.replace(JAX_CMD, PORT_CMD) for line in result.output.strip().splitlines()]


@pytest.mark.parametrize('extra', [
    [], ['--config-file', 'CFG'],
    ['--cluster-type', 'slurm', '--prefix', 'source activate m2', '--slurm-ncpus', '8',
     '--slurm-memory', '32GB', '--slurm-wall-time', '1:00:00', '--slurm-partition', 'gpu']])
def test_emitted_commands_equal_jaxs(tree, capsys, extra):
    root, model = tree
    os.makedirs(model)
    if '--config-file' in extra:
        cfg = os.path.join(root, '..', 'cfg.yaml')
        write_yaml(cfg, {'chunk_size': 32})
        extra = ['--config-file', cfg]
    args = [root, '--model', model] + extra
    assert cli.main(['extract-batch'] + args) == 0
    ours = _lines(capsys)
    assert ours == _jax_lines(args)
    assert len(ours) == 2 and all(PORT_CMD in line for line in ours)
    assert any(line.endswith(os.path.join(root, 'a', 'depth.dat')) or
               os.path.join(root, 'a', 'depth.dat') in line for line in ours)
    assert not any(os.path.join(root, 'b') + os.sep in line for line in ours)


def test_avi_scan_finds_depth_avi_and_not_the_preview(tree, capsys):
    root, model = tree
    os.makedirs(model)
    args = [root, '--model', model, '--extension', '.avi']
    assert cli.main(['extract-batch'] + args) == 0
    ours = _lines(capsys)
    preview = os.path.join(root, 'c', 'proc', 'results_00.avi')
    assert [line.split()[-1] for line in ours] == [os.path.join(root, 'c', 'depth.avi'),
                                                   os.path.join(root, 'd', 'sess.tar.gz')]
    # the reference takes the port's preview for a session too
    assert _jax_lines(args) == sorted(ours + [f'{PORT_CMD} extract --model {model} {preview}'],
                                      key=lambda line: line.split()[-1])


def test_in_process_runs_the_sessions_and_reports_a_failure(tmp_path, capsys):
    root = tmp_path / 'sessions'
    good = _session(str(root / 'good'), 9)
    bad = _touch(str(root / 'bad' / 'depth.dat'))          # no frames, no metadata
    model = tiny_model_dir(str(tmp_path / 'model'))
    cfg = str(tmp_path / 'cfg.yaml')
    write_yaml(cfg, {'chunk_size': 32, 'batch_size': 8, 'instance_threshold': 0.5,
                     'use_tracking': True, 'show_progress': False})
    argv = ['extract-batch', str(root), '--model', model, '--config-file', cfg,
            '--in-process', '--device', 'cpu', '--max-concurrent', '2']
    assert cli.main(argv) == 1
    out = _lines(capsys)
    assert f'{bad}: FAILED (see log)' in out
    status = os.path.join(os.path.dirname(good), 'proc', 'results_00.yaml')
    assert f'{good}: {status}' in out
    done = read_yaml(status)
    assert done['complete'] is True
    assert done['parameters']['chunk_size'] == 32 and done['parameters']['device'] == 'cpu'
    assert done['parameters']['allowed_detections'] == 4
    assert done['parameters']['model'] == model
    assert cli.main(['extract-batch', str(root), '--model', model, '--in-process',
                     '--device', 'cpu']) == 1
    out = _lines(capsys)
    assert not any(line.startswith(good) for line in out)
    os.remove(bad)
    assert cli.main(['extract-batch', str(root), '--model', model, '--in-process',
                     '--device', 'cpu']) == 0
    assert 'No unextracted sessions found.' in _lines(capsys)
