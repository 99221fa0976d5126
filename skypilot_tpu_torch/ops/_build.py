"""Build and load the port's CUDA kernels.

Each source under skypilot_tpu_torch/csrc/ (flash_fwd.cu,
paged_decode.cu) is compiled at first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

and loaded with ctypes. The library name carries a hash of the source,
the shared headers and the flags, so an edited source is rebuilt and a
stale library is never loaded. Libraries land in skypilot_tpu_torch/_build/
(SKYT_TORCH_BUILD_DIR overrides). `build_all()` starts one nvcc per
source at once and waits for all of them.

Only sources in this repository are built. A failed build raises with
nvcc's output.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from skypilot_tpu_torch.utils import env

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
SOURCES = ('flash_fwd', 'paged_decode')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo',
              '-Xptxas', '-v']

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {'seconds': build wall time (0 when cached), 'log': nvcc output}
build_info: Dict[str, Dict[str, object]] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu extern "C").
_SIGNATURES = {
    'flash_fwd': ('skyt_flash_fwd',
                  [_P, _P, _P, _P, _P, _P] + [_LL] * 9 +
                  [_I, _I, _I, _I, _I, _I, _I, _F, _P]),
    'paged_decode': ('skyt_paged_decode',
                     [_P] * 10 + [_I] * 9 + [_F, _P]),
}


def build_dir() -> str:
    return env.get('SKYT_TORCH_BUILD_DIR') or os.path.join(_PKG, '_build')


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin and PATH): the '
            'CUDA kernels are built at first use on a machine with the '
            'CUDA toolkit')
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, f'{name}.cu')] + sorted(
            glob.glob(os.path.join(CSRC, '*.cuh'))):
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + b'\0' + f.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f'lib{name}-{h.hexdigest()[:16]}.so')


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_nvcc()] + NVCC_FLAGS + [
        '-o', _tmp_path(out), os.path.join(CSRC, f'{name}.cu')]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _tmp_path(out: str) -> str:
    return f'{out}.{os.getpid()}.tmp'


def _finish(name: str, out: str, proc: subprocess.Popen,
            t0: float) -> None:
    log, _ = proc.communicate()
    tmp = _tmp_path(out)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu '
                           f'(rc {proc.returncode}):\n{log}')
    os.replace(tmp, out)
    with open(f'{out}.log', 'w') as f:
        f.write(log)
    build_info[name] = {'seconds': time.perf_counter() - t0, 'log': log}


def build_all(names: Optional[List[str]] = None) -> Dict[str, object]:
    """Build every missing library, one nvcc per source, all started
    together. Returns build_info for the requested names."""
    names = list(names or SOURCES)
    with _lock:
        t0 = time.perf_counter()
        procs = []
        for name in names:
            out = _lib_path(name)
            if os.path.exists(out):
                if name not in build_info:
                    log = ''
                    if os.path.exists(f'{out}.log'):
                        with open(f'{out}.log') as f:
                            log = f.read()
                    build_info[name] = {'seconds': 0.0, 'log': log}
                continue
            procs.append((name, out, _start(name, out)))
        errors = []
        for name, out, proc in procs:
            try:
                _finish(name, out, proc, t0)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError('\n'.join(errors))
    return {n: build_info[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if needed, with the
    entry point's argtypes/restype and skyt_error_string set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.skyt_error_string.argtypes = [ctypes.c_int]
            lib.skyt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.skyt_error_string(rc).decode(errors='replace')
        raise RuntimeError(f'{what} launch failed: CUDA error {rc} ({msg})')
