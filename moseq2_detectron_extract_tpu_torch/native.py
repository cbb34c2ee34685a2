'''Build and load the hand-written CUDA kernels of ``csrc/``.

Each build unit, a ``csrc/*.cu`` source with its own flags, is compiled by
its own ``nvcc -c`` (all started together), and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.
``roi_stage2_resident.cu`` is four units, one per entry, so that its four
kernels compile in parallel. No source includes PyTorch's headers,
so a build takes seconds. The library lands in ``_build/<hash>/`` beside
this file, keyed by a hash of the sources, the flags and the compiler, so an
unchanged checkout builds once. The build happens at the first kernel call,
never at import.

A failed build raises with nvcc's stderr; there is no fallback.

The host's C++ cores, ``csrc/prep_host.cpp`` (the host prep),
``csrc/kalman_host.cpp`` (the Kalman filter and smoother),
``csrc/draw_host.cpp`` (the preview's drawing), ``csrc/mjpeg_host.cpp``
(the preview's JPEG encoder) and ``csrc/ffv1_host.cpp`` (the FFV1 codec of
compressed depth; both run threads: ``-pthread``), are built
the same way with ``g++`` (nvcc's host compiler), each into a library of
its own beside them (``build_host_library``), with one loader each; a
failed build raises with g++'s stderr.

Every ``nvcc`` gets its own copy of the environment (``env=``). Without it
the child reads the C ``environ`` array while it starts, and a thread that
sets a variable meanwhile (``import torch`` does, and ``chip_smoke.py``
builds in a thread beside that import) can free the array under it: the
start then fails with ``OSError: [Errno 14] Bad address``.
'''
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
SOURCES = ('roi_align.cu', 'clean.cu', 'roi_stage2_resident.cu', 'nms.cu')
# the stage-2 entries each source holds (0 retile, 1 transpose, 2 dotswap, 3 noxpose)
_STAGE2_ENTRIES = {'roi_stage2_resident.cu': (0, 1, 2, 3)}
# (source, extra nvcc flags), one nvcc -c each: the stage-2 sources once per entry
UNITS = tuple((src, flags) for src in SOURCES for flags in (
    [(f'-DM2DE_STAGE2_VARIANT={v}',) for v in _STAGE2_ENTRIES[src]]
    if src in _STAGE2_ENTRIES else [()]))
LIB_NAME = 'libm2de_kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

HOST_SOURCE = os.path.join(CSRC_DIR, 'prep_host.cpp')
HOST_LIB_NAME = 'libm2de_prep_host.so'
KALMAN_SOURCE = os.path.join(CSRC_DIR, 'kalman_host.cpp')
KALMAN_LIB_NAME = 'libm2de_kalman_host.so'
DRAW_SOURCE = os.path.join(CSRC_DIR, 'draw_host.cpp')
DRAW_LIB_NAME = 'libm2de_draw_host.so'
MJPEG_SOURCE = os.path.join(CSRC_DIR, 'mjpeg_host.cpp')
MJPEG_LIB_NAME = 'libm2de_mjpeg_host.so'
FFV1_SOURCE = os.path.join(CSRC_DIR, 'ffv1_host.cpp')
FFV1_LIB_NAME = 'libm2de_ffv1_host.so'
HOST_CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-pthread')

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
    digest.update(repr(UNITS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith(('.cu', '.cuh', '.h')):
            digest.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), 'rb') as fh:
                digest.update(fh.read())
    return digest.hexdigest()[:16]


def _build_once(key: str, lib_name: str, build: Callable[[str, str], None]) -> str:
    '''Path of ``BUILD_DIR/<key>/<lib_name>``. Unless it exists, ``build(work,
    tmp_lib)`` makes ``tmp_lib`` in a scratch directory ``work`` beside it,
    and the library is swapped in whole; the scratch directory goes either
    way, so a failed build leaves nothing a later call would take for built.'''
    out_dir = os.path.join(BUILD_DIR, key)
    lib_path = os.path.join(out_dir, lib_name)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir, prefix='tmp-')
    try:
        tmp_lib = os.path.join(work, lib_name)
        build(work, tmp_lib)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def _loaded_once(load: Callable[[], ctypes.CDLL]) -> Callable[[], ctypes.CDLL]:
    '''``load`` run at the first call, under a lock of its own, and kept.'''
    lock = threading.Lock()
    cached = functools.lru_cache(maxsize=None)(load)

    @functools.wraps(load)
    def loaded() -> ctypes.CDLL:
        with lock:
            return cached()
    return loaded


def build_library() -> str:
    '''Build the kernel library unless this source hash is built; its path.

    The units compile in parallel, one ``nvcc -c`` each; the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills per kernel) is
    kept in ``build.log`` beside the library.
    '''
    nvcc = find_nvcc()
    key = _build_key(nvcc)
    env = dict(os.environ)

    def build(work: str, tmp_lib: str) -> None:
        procs = []
        objs: List[str] = []
        for n, (src, flags) in enumerate(UNITS):
            obj = os.path.join(work, f'{n}-{src}.o')
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, *flags, '-c', os.path.join(CSRC_DIR, src), '-o', obj]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True, env=env)))
        log = []
        failed = []
        for cmd, proc in procs:
            stdout, stderr = proc.communicate()
            log.append(' '.join(cmd) + '\n' + stdout + stderr)
            if proc.returncode != 0:
                failed.append(f'{" ".join(cmd)}\n{stderr}')
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
        cmd = [nvcc, *NVCC_FLAGS, '-shared', *objs, '-o', tmp_lib]
        result = subprocess.run(cmd, capture_output=True, text=True, check=False, env=env)
        log.append(' '.join(cmd) + '\n' + result.stdout + result.stderr)
        if result.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{" ".join(cmd)}\n{result.stderr}')
        with open(os.path.join(os.path.dirname(work), 'build.log'), 'w',
                  encoding='utf-8') as fh:
            fh.write('\n'.join(log))

    return _build_once(key, LIB_NAME, build)


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
    for variant in ('retile', 'transpose', 'dotswap', 'noxpose'):
        entry = getattr(lib, f'm2de_roi_stage2_{variant}')
        entry.argtypes = [p, p, p, p,          # f, wy, wx, out
                          i, i, i, i, i, i,    # B, K, Kp, C, Hp, Wp
                          i, i,                # block_k, out_bf16
                          p]                   # stream
        entry.restype = i
    for entry in (lib.m2de_roi_stage2_resident_cs, lib.m2de_roi_stage2_resident_smem_bytes):
        entry.argtypes = [i, i]                          # Hp, Wp
        entry.restype = i
    lib.m2de_nms_keep_mask.argtypes = [p, p, p, p, p,          # boxes, scores, valid, keep, scratch
                                       i, i, i, i, i,          # B, K, cluster, words/CTA, in smem
                                       ctypes.c_float, i, p]   # threshold, max rounds, stream
    lib.m2de_nms_keep_mask.restype = i
    lib.m2de_nms_max_active_clusters.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.m2de_nms_max_active_clusters.restype = i
    lib.m2de_cuda_error_string.argtypes = [i]
    lib.m2de_cuda_error_string.restype = ctypes.c_char_p
    return lib


@_loaded_once
def load_library() -> ctypes.CDLL:
    '''The kernel library, built on first use.'''
    return _configure(ctypes.CDLL(build_library()))


def check(rc: int, what: str) -> None:
    '''Raise if a C entry returned a CUDA error.'''
    if rc != 0:
        msg = load_library().m2de_cuda_error_string(rc).decode()
        raise RuntimeError(f'{what}: CUDA error {rc} ({msg})')


def find_host_cxx() -> str:
    '''Path of ``g++`` on $PATH.'''
    found = shutil.which('g++')
    if not found:
        raise RuntimeError('g++ not found on $PATH; the host prep (csrc/prep_host.cpp) '
                           'cannot be built')
    return found


def build_host_library(source: str = HOST_SOURCE, lib_name: str = HOST_LIB_NAME) -> str:
    '''Build the host library ``lib_name`` from ``source`` with g++ unless
    this source hash is built; its path. Raises with g++'s stderr on a
    failure.'''
    cxx = find_host_cxx()
    digest = hashlib.sha256()
    for part in (cxx, ' '.join(HOST_CXX_FLAGS)):
        digest.update(part.encode())
    with open(source, 'rb') as fh:
        digest.update(fh.read())

    def build(_work: str, tmp_lib: str) -> None:
        cmd = [cxx, *HOST_CXX_FLAGS, source, '-o', tmp_lib]
        result = subprocess.run(cmd, capture_output=True, text=True, check=False,
                                env=dict(os.environ))
        if result.returncode != 0:
            raise RuntimeError(f'g++ failed:\n{" ".join(cmd)}\n{result.stderr}')

    return _build_once('host-' + digest.hexdigest()[:16], lib_name, build)


@_loaded_once
def load_host_library() -> ctypes.CDLL:
    '''The host prep library, built on first use.'''
    lib = ctypes.CDLL(build_host_library())
    u8, i32 = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int32)
    i, l = ctypes.c_int, ctypes.c_long
    lib.prep_frames_native.argtypes = [u8, l, l, i32, i32, l, l, l,   # frames, strides, bg, roi, t h w
                                       i, i, i, i, i, u8]           # vmin, lo, hi, sentinel, out
    lib.prep_frames_native.restype = i
    return lib


@_loaded_once
def load_kalman_library() -> ctypes.CDLL:
    '''The Kalman filter and smoother core, built on first use.'''
    lib = ctypes.CDLL(build_host_library(KALMAN_SOURCE, KALMAN_LIB_NAME))
    d, u8, i = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int
    lib.kalman_filter_native.argtypes = [d, d, d, d, d, d,     # A, C, Q, R, mu0, S0
                                         d, u8, i, i, i,       # obs, missing, T, S, O
                                         d, d, d, d]           # means, covs, pred means, covs
    lib.kalman_filter_native.restype = i
    lib.kalman_smooth_native.argtypes = [d, d, d, d, d,        # A, filtered and predicted
                                         i, i, d, d, d]        # T, S, out means, covs, lags
    lib.kalman_smooth_native.restype = i
    return lib


@_loaded_once
def load_draw_library() -> ctypes.CDLL:
    '''The preview's drawing core, built on first use.'''
    lib = ctypes.CDLL(build_host_library(DRAW_SOURCE, DRAW_LIB_NAME))
    u8, i32, i64 = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64))
    i = ctypes.c_int
    lib.m2de_draw_ops.argtypes = [u8, i, i, i, i,                 # frames, N, H, W, channels
                                  i32, i, u8, i32]                # records, count, glyphs, meta
    lib.m2de_draw_ops.restype = i
    lib.m2de_resize_linear_u8.argtypes = [u8, i, i, i, i, u8, i, i]  # src N H W C, dst h w
    lib.m2de_resize_linear_u8.restype = i
    lib.m2de_blend_windows.argtypes = [u8, i, i, i, i,            # frames, N, H, W, channels
                                       u8, i, i, i64, u8]         # masks, mh, mw, origins, lut
    lib.m2de_blend_windows.restype = i
    return lib


@_loaded_once
def load_mjpeg_library() -> ctypes.CDLL:
    '''The preview's baseline JPEG encoder, built on first use.'''
    lib = ctypes.CDLL(build_host_library(MJPEG_SOURCE, MJPEG_LIB_NAME))
    u8, i32, i64 = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64))
    i = ctypes.c_int
    lib.m2de_jpeg_encode_block.argtypes = [u8, i, i, i, i, i,     # frames, N, H, W, quality, bgr
                                           i, u8, ctypes.c_int64,  # threads, out, capacity
                                           i64]                    # sizes
    lib.m2de_jpeg_encode_block.restype = i
    lib.m2de_jpeg_forward.argtypes = [u8, i, i, i, i, i32]        # frame, H, W, quality, bgr, out
    lib.m2de_jpeg_forward.restype = i
    return lib


@_loaded_once
def load_ffv1_library() -> ctypes.CDLL:
    '''The FFV1 decoder and encoder of compressed depth, built on first use.'''
    lib = ctypes.CDLL(build_host_library(FFV1_SOURCE, FFV1_LIB_NAME))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.m2de_ffv1_parse_config.argtypes = [p, i64, p, p]          # extradata, size, info, detail
    lib.m2de_ffv1_parse_config.restype = i
    lib.m2de_ffv1_inline_version.argtypes = [p, i64]              # packet, size
    lib.m2de_ffv1_inline_version.restype = i
    lib.m2de_ffv1_decoder_new.argtypes = [p, i64, i, i, p, p]     # extradata, W, H, err, detail
    lib.m2de_ffv1_decoder_new.restype = p
    lib.m2de_ffv1_decoder_free.argtypes = [p]
    lib.m2de_ffv1_decoder_free.restype = None
    lib.m2de_ffv1_decode.argtypes = [p, p, p, i, p, i, p, p]      # packets, sizes, n, outs,
    lib.m2de_ffv1_decode.restype = i                              # threads, err frame, slice
    lib.m2de_ffv1_encoder_new.argtypes = [i, i, i, i, i, i]       # W, H, num_h, num_v, gop, ec
    lib.m2de_ffv1_encoder_new.restype = p
    lib.m2de_ffv1_encoder_free.argtypes = [p]
    lib.m2de_ffv1_encoder_free.restype = None
    lib.m2de_ffv1_encoder_extradata.argtypes = [p, p, i64]
    lib.m2de_ffv1_encoder_extradata.restype = i64
    lib.m2de_ffv1_encode.argtypes = [p, p, i, i, p, p]            # frames, n, threads, sizes, keys
    lib.m2de_ffv1_encode.restype = i64
    lib.m2de_ffv1_encoder_fetch.argtypes = [p, p]
    lib.m2de_ffv1_encoder_fetch.restype = None
    return lib
