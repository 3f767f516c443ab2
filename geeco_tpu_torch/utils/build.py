"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library is one source under ``geeco_tpu_torch/csrc/`` compiled for
Hopper with a plain C interface::

  nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -std=c++17 \
       -Xptxas=-v -Xcompiler -fPIC [-D...] -shared -o <library>.so <source>.cu

``load_kernels`` gives the rasterizer (``raster_tiles.cu``), built at first
use.  ``load_psd`` gives the fused PSD solve (``psd_solve.cu``) built for
one set of shapes and one launch plan, passed as ``-DPSD_*`` constants: the
kernel's loops and offsets are compile-time, and a new shape costs one nvcc
run (a few seconds) at its first solve.  ``build_all`` builds several
libraries at once, every nvcc started together.

``load_native`` builds a host library from ``geeco_tpu_torch/native/`` with
``g++ -O2 -shared -fPIC ... -lz`` (the TFRecord writer) into
``build/native/``.

Libraries go to ``build/kernels/`` at the root of the checkout (listed in
.gitignore).  A file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing here
runs at import time: the CPU tests import every module and never touch
nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'native')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '--fmad=false', '-std=c++17', '-Xptxas=-v', '-Xcompiler',
              '-fPIC')
# the constants psd_solve.cu is built with: the shapes of one solve and
# its launch plan (physics/solver_pallas.py::plan)
PSD_KEYS = ('nI', 'nv', 'nE', 'K', 'nlim', 'cluster', 'threads', 'resident',
            'jreg', 'xreg')
_PSD_MACROS = ('PSD_NI', 'PSD_NV', 'PSD_NE', 'PSD_K', 'PSD_NLIM', 'PSD_C',
               'PSD_THREADS', 'PSD_RESIDENT', 'PSD_JREG', 'PSD_XREG')

# seconds the last build took in this process (0.0 when it was cached),
# and what nvcc printed (ptxas's register and shared-memory report)
last_build_seconds = 0.0
last_build_log = ''


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  path = os.path.join(home, 'bin', 'nvcc')
  if os.path.exists(path):
    return path
  raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                     '/usr/local/cuda/bin): the CUDA kernels cannot be built')


def _library(source: str, defines: tuple = ()) -> tuple:
  """(path of the library, its nvcc arguments) for csrc/<source> built with
  `defines` (a tuple of 'NAME=value')."""
  src = os.path.join(CSRC, source)
  flags = (*NVCC_FLAGS, *(f'-D{d}' for d in defines))
  h = hashlib.sha1(' '.join(flags).encode())
  with open(src, 'rb') as f:
    h.update(source.encode() + f.read())
  stem = os.path.splitext(source)[0]
  out = os.path.join(BUILD_DIR, f'lib{stem}_{h.hexdigest()[:12]}.so')
  return out, [*flags, '-shared', '-o', out + '.tmp', src]


def build_all(libraries) -> None:
  """Compile those of `libraries` ((path, nvcc arguments) pairs) that are
  not on disk, every nvcc started together; raises if one fails."""
  global last_build_seconds, last_build_log
  todo = [(out, args) for out, args in dict(libraries).items()
          if not os.path.exists(out)]
  last_build_seconds = 0.0
  if not todo:
    return
  os.makedirs(BUILD_DIR, exist_ok=True)
  t0 = time.perf_counter()
  nvcc = _nvcc()
  procs = [subprocess.Popen([nvcc, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
           for _, args in todo]
  logs = [p.communicate()[0] for p in procs]
  last_build_log = '\n'.join(f'$ {" ".join(p.args)}\n{log}'
                             for p, log in zip(procs, logs))
  if any(p.returncode for p in procs):
    raise RuntimeError(f'nvcc failed:\n{last_build_log}')
  for out, _ in todo:
    os.replace(out + '.tmp', out)
  last_build_seconds = time.perf_counter() - t0


def raster_library(defines: tuple = ()) -> tuple:
  """(path, nvcc arguments) of the rasterizer's library; `defines` adds
  macros (``RASTER_PROFILE=1``: chip_smoke.py --raster-phases)."""
  return _library('raster_tiles.cu', tuple(defines))


def library_path() -> str:
  """Where the rasterizer's library is, or will be, on disk."""
  return raster_library()[0]


def psd_library(spec: dict, defines: tuple = ()) -> tuple:
  """(path, nvcc arguments) of the PSD solve built for `spec`, which holds
  PSD_KEYS: the shapes nI, nv, nE, K, nlim and the plan's cluster, threads,
  resident, jreg, xreg (``solver_pallas.build_spec``); `defines` adds
  macros."""
  return _library('psd_solve.cu', tuple(
      f'{m}={int(spec[k])}' for m, k in zip(_PSD_MACROS, PSD_KEYS)) +
      tuple(defines))


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
  """The rasterizer's library with its C signatures declared."""
  out, args = raster_library()
  build_all([(out, args)])
  lib = ctypes.CDLL(out)
  vp, ci = ctypes.c_void_p, ctypes.c_int
  lib.raster_tiles_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                   ctypes.c_float, vp]
  lib.raster_tiles_f32.restype = ci
  lib.geeco_cuda_error_string.argtypes = [ci]
  lib.geeco_cuda_error_string.restype = ctypes.c_char_p
  return lib


@functools.lru_cache(maxsize=None)
def _load_psd(values: tuple) -> ctypes.CDLL:
  out, args = psd_library(dict(zip(PSD_KEYS, values)))
  build_all([(out, args)])
  lib = ctypes.CDLL(out)
  vp, ci = ctypes.c_void_p, ctypes.c_int
  lib.psd_solve_f32.argtypes = [vp] * 13 + [ci, ci, vp]
  lib.psd_solve_f32.restype = ci
  lib.psd_solve_smem_bytes.argtypes = []
  lib.psd_solve_smem_bytes.restype = ci
  lib.psd_cuda_error_string.argtypes = [ci]
  lib.psd_cuda_error_string.restype = ctypes.c_char_p
  return lib


def load_psd(spec: dict) -> ctypes.CDLL:
  """The PSD solve built for `spec` (see ``psd_library``), compiled at its
  first use and kept for the process."""
  return _load_psd(tuple(int(spec[k]) for k in PSD_KEYS))


_NATIVE_LOCK = threading.Lock()


def load_native(name: str) -> ctypes.CDLL:
  """geeco_tpu_torch/native/<name>.cpp as a host library (g++, zlib), built
  into ``build/native/`` at first use; raises with the compiler's output if
  it does not build (there is no other writer to fall back on).  Safe to
  call from several threads (the collect CLI's writers)."""
  with _NATIVE_LOCK:
    return _load_native(name)


@functools.lru_cache(maxsize=None)
def _load_native(name: str) -> ctypes.CDLL:
  src = os.path.join(_PKG, 'native', f'{name}.cpp')
  with open(src, 'rb') as f:
    digest = hashlib.sha1(f.read()).hexdigest()[:12]
  out = os.path.join(NATIVE_DIR, f'lib{name}_{digest}.so')
  if not os.path.exists(out):
    os.makedirs(NATIVE_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run(['g++', '-O2', '-shared', '-fPIC', '-o', tmp, src,
                           '-lz'], capture_output=True, text=True)
    if proc.returncode:
      raise RuntimeError(f'g++ failed to build {src}:\n{proc.stderr}')
    os.replace(tmp, out)
  return ctypes.CDLL(out)
