'''Nothing the benchmark runs loads JAX or the JAX package, and the plain
references import nothing of the program.'''
import ast
import os
import subprocess
import sys

import pytest

from portbench import core

REFERENCE = os.path.join(core.PKG_DIR, 'reference')
PORT = 'moseq2_detectron_extract_tpu_torch'


@pytest.mark.parametrize('name', sorted(f for f in os.listdir(REFERENCE) if f.endswith('.py')))
def test_reference_imports_nothing_of_the_program(name):
    tree = ast.parse(open(os.path.join(REFERENCE, name), encoding='utf-8').read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split('.')[0])
    assert not tops & (set(core.FORBIDDEN) | {PORT})
    assert tops <= {'math', 'contextlib', 'typing', 'numpy', 'torch', 'portbench'}


def test_forbidden_names_compare_whole():
    assert core.forbidden_loaded([PORT, PORT + '.ops.nms', 'numpy', 'jaxtyping']) == []
    assert core.forbidden_loaded(['jaxlib.xla_client', 'moseq2_detectron_extract_tpu.models',
                                  'flax']) == ['flax', 'jaxlib', 'moseq2_detectron_extract_tpu']


def test_harness_and_program_load_no_jax():
    '''Every harness module and the program modules the drivers use, in a
    fresh interpreter, leave JAX and the JAX package unloaded.'''
    script = (
        'import sys, os, glob; sys.path.insert(0, %r)\n'
        'from portbench import core\n'
        'for d in ("drivers", "metrics"):\n'
        '    for f in sorted(glob.glob(os.path.join(core.PKG_DIR, d, "*.py"))):\n'
        '        core.load_module(f, "m_" + os.path.basename(f).replace(".", "_"))\n'
        'import portbench.control\n'
        'from moseq2_detectron_extract_tpu_torch import extract\n'
        'from moseq2_detectron_extract_tpu_torch.models import trainer, predictor, rcnn\n'
        'from moseq2_detectron_extract_tpu_torch.io import annot\n'
        'print(core.forbidden_loaded())\n') % core.ROOT
    env = dict(os.environ, OMP_NUM_THREADS='1')
    out = subprocess.run([sys.executable, '-c', script], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == '[]'
