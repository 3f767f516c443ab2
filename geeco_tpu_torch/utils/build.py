"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, every ``*.cu`` under ``geeco_tpu_torch/csrc/`` is compiled for
Hopper, one nvcc per source, all started together::

  nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -std=c++17 \
       -Xptxas=-v -Xcompiler -fPIC -c -o <source>.o <source>.cu

and the objects are linked into one shared library with a plain C
interface, ``build/kernels/libgeeco_kernels_<hash>.so`` (``nvcc -shared``).

``build/`` sits at the root of the checkout and is listed in .gitignore.
The file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  Nothing here runs at
import time: the CPU tests import every module and never touch nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '--fmad=false', '-std=c++17', '-Xptxas=-v', '-Xcompiler',
              '-fPIC')

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


def _sources():
  srcs = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
  if not srcs:
    raise RuntimeError(f'no CUDA sources under {CSRC}')
  return srcs


def library_path() -> str:
  h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
  for src in _sources():
    with open(src, 'rb') as f:
      h.update(os.path.basename(src).encode() + f.read())
  return os.path.join(BUILD_DIR, f'libgeeco_kernels_{h.hexdigest()[:12]}.so')


def build() -> str:
  """Compile the kernels if this exact build is not on disk; its path."""
  global last_build_seconds, last_build_log
  out = library_path()
  if os.path.exists(out):
    last_build_seconds = 0.0
    return out
  os.makedirs(BUILD_DIR, exist_ok=True)
  t0 = time.perf_counter()
  nvcc = _nvcc()
  start = lambda *args: subprocess.Popen(
      [nvcc, *NVCC_FLAGS, *args], stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True)
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    srcs = _sources()
    objs = [os.path.join(tmp, os.path.basename(s) + '.o') for s in srcs]
    lib = os.path.join(tmp, 'lib.so')
    procs = [start('-c', '-o', o, s) for o, s in zip(objs, srcs)]
    logs = [p.communicate()[0] for p in procs]  # every compile ends first
    if all(p.returncode == 0 for p in procs):
      procs.append(start('-shared', '-o', lib, *objs))
      logs.append(procs[-1].communicate()[0])
    last_build_log = '\n'.join(f'$ {" ".join(p.args)}\n{log}'
                                for p, log in zip(procs, logs))
    if any(p.returncode for p in procs):
      raise RuntimeError(f'nvcc failed:\n{last_build_log}')
    os.replace(lib, out)
  last_build_seconds = time.perf_counter() - t0
  return out


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
  """The built kernel library with its C signatures declared."""
  lib = ctypes.CDLL(build())
  vp, ci = ctypes.c_void_p, ctypes.c_int
  lib.raster_tiles_f32.argtypes = [vp, vp, vp, ci, ci, ci, ctypes.c_float,
                                   vp]
  lib.raster_tiles_f32.restype = ci
  lib.psd_solve_f32.argtypes = [vp] * 13 + [ci] * 7 + [vp]
  lib.psd_solve_f32.restype = ci
  lib.geeco_cuda_error_string.argtypes = [ci]
  lib.geeco_cuda_error_string.restype = ctypes.c_char_p
  return lib
