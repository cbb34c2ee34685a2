'''Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc -c`` (all started
together), and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``. No source includes PyTorch's headers,
so a build takes seconds. The library lands in ``_build/<hash>/`` beside
this file, keyed by a hash of the sources, the flags and the compiler, so an
unchanged checkout builds once. The build happens at the first kernel call,
never at import.

A failed build raises with nvcc's stderr; there is no fallback.
'''
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
SOURCES = ('roi_align.cu', 'clean.cu')
LIB_NAME = 'libm2de_kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()


def find_nvcc() -> str:
    '''Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda.'''
    candidates = []
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, $PATH and '
                       '/usr/local/cuda/bin); the CUDA kernels cannot be built')


def _build_key(nvcc: str) -> str:
    digest = hashlib.sha256()
    digest.update(nvcc.encode())
    digest.update(' '.join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith(('.cu', '.cuh', '.h')):
            digest.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), 'rb') as fh:
                digest.update(fh.read())
    return digest.hexdigest()[:16]


def build_library() -> str:
    '''Build the kernel library unless this source hash is built; its path.

    The sources compile in parallel, one ``nvcc -c`` each; the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills per kernel) is
    kept in ``build.log`` beside the library.
    '''
    nvcc = find_nvcc()
    out_dir = os.path.join(BUILD_DIR, _build_key(nvcc))
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir, prefix='tmp-')
    try:
        procs = []
        objs: List[str] = []
        for src in SOURCES:
            obj = os.path.join(work, src + '.o')
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, '-c', os.path.join(CSRC_DIR, src), '-o', obj]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        log = []
        failed = []
        for cmd, proc in procs:
            stdout, stderr = proc.communicate()
            log.append(' '.join(cmd) + '\n' + stdout + stderr)
            if proc.returncode != 0:
                failed.append(f'{" ".join(cmd)}\n{stderr}')
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
        tmp_lib = os.path.join(work, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, '-shared', *objs, '-o', tmp_lib]
        result = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(' '.join(cmd) + '\n' + result.stdout + result.stderr)
        if result.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{" ".join(cmd)}\n{result.stderr}')
        with open(os.path.join(out_dir, 'build.log'), 'w', encoding='utf-8') as fh:
            fh.write('\n'.join(log))
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.m2de_roi_align_bf16.argtypes = [ctypes.POINTER(p),              # level pointers
                                        ctypes.POINTER(ctypes.c_longlong),  # level H, W, strides
                                        i, i,             # n_levels, min_level
                                        p, p,             # boxes, out
                                        i, i, i, i,       # B, K, C, out_size
                                        i, i,             # vec, column segments
                                        p]                # stream
    lib.m2de_roi_align_bf16.restype = i
    lib.m2de_clean_u8.argtypes = [p, p, i, i, i, i, i, p]  # in, out, N, H, W, tile_h, tile_w, stream
    lib.m2de_clean_u8.restype = i
    lib.m2de_clean_smem_bytes.argtypes = [i, i]
    lib.m2de_clean_smem_bytes.restype = i
    lib.m2de_cuda_error_string.argtypes = [i]
    lib.m2de_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    return _configure(ctypes.CDLL(build_library()))


def load_library() -> ctypes.CDLL:
    '''The kernel library, built on first use.'''
    with _lock:
        return _load()


def check(rc: int, what: str) -> None:
    '''Raise if a C entry returned a CUDA error.'''
    if rc != 0:
        msg = load_library().m2de_cuda_error_string(rc).decode()
        raise RuntimeError(f'{what}: CUDA error {rc} ({msg})')
