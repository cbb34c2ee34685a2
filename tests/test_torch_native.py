'''The kernel build of ``native.py`` on the CPU, with a stand-in for nvcc: it
compiles one unit per process, links them, gives every process its own copy
of the environment (so that a thread setting variables meanwhile cannot
break the start), and raises with the compiler's stderr on a failure.'''
import os
import stat
import subprocess
import threading

import pytest

from moseq2_detectron_extract_tpu_torch import native

# Writes an empty file at the path after -o; exits 1 with a message when
# FAKE_NVCC_FAIL is set.
_FAKE_NVCC = '''#!/bin/sh
if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: fake nvcc failed" >&2; exit 1; fi
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
: > "$out"
'''


@pytest.fixture()
def fake_build(tmp_path, monkeypatch):
    '''native's build pointed at a stand-in nvcc and a build dir under
    tmp_path; the list of (command, kwargs) of every process it starts.'''
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(native, 'find_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / '_build'))
    calls = []
    real_popen = subprocess.Popen

    def popen(cmd, **kwargs):   # subprocess.run starts its process here too
        calls.append((cmd, kwargs))
        return real_popen(cmd, **kwargs)

    monkeypatch.setattr(subprocess, 'Popen', popen)
    return calls


def test_build_gives_each_nvcc_its_environment_while_a_thread_sets_variables(fake_build):
    stop = threading.Event()

    def churn():
        # what `import torch` does beside a build thread, many times over
        n = 0
        while not stop.is_set():
            os.environ[f'M2DE_TEST_CHURN_{n % 64}'] = 'x' * (n % 7)
            if n % 64 == 63:
                for i in range(64):
                    os.environ.pop(f'M2DE_TEST_CHURN_{i}', None)
            n += 1

    thread = threading.Thread(target=churn)
    thread.start()
    try:
        lib_path = native.build_library()
    finally:
        stop.set()
        thread.join()
        for i in range(64):
            os.environ.pop(f'M2DE_TEST_CHURN_{i}', None)
    assert os.path.isfile(lib_path)
    assert os.path.basename(lib_path) == native.LIB_NAME
    assert os.path.isfile(os.path.join(os.path.dirname(lib_path), 'build.log'))
    # one compile per unit, then the link
    assert len(fake_build) == len(native.UNITS) + 1
    assert [cmd[-3] for cmd, _ in fake_build[:-1]] == [
        os.path.join(native.CSRC_DIR, src) for src, _ in native.UNITS]
    assert '-shared' in fake_build[-1][0]
    assert all(isinstance(kwargs.get('env'), dict) for _, kwargs in fake_build)
    # a second call finds the library by its source hash and starts nothing
    assert native.build_library() == lib_path
    assert len(fake_build) == len(native.UNITS) + 1


def test_build_raises_with_the_compilers_stderr(fake_build, monkeypatch):
    monkeypatch.setenv('FAKE_NVCC_FAIL', '1')
    with pytest.raises(RuntimeError, match='fake nvcc failed'):
        native.build_library()
    assert len(fake_build) == len(native.UNITS)
    out_dirs = os.listdir(native.BUILD_DIR)
    assert len(out_dirs) == 1
    # nothing is left that a later call would take for a built library
    assert os.listdir(os.path.join(native.BUILD_DIR, out_dirs[0])) == []
