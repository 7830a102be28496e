"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point, so it compiles in a
few seconds without PyTorch's headers.  The shared library goes to
``build/multinerf_tpu_torch/<name>-<hash>.so`` beside the package, keyed by
a hash of the sources and flags, and is built at first use.  Nothing here
runs at import time: this module must import on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'multinerf_tpu_torch')
# -fmad=false: every f32 multiply and add rounds on its own, as in the plain
# PyTorch versions and the JAX twins; the contraction's terms cancel at
# far = 1e6 and fused multiply-adds would round them differently.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS = {}
# name -> {'seconds': build time (0.0 when cached), 'log': nvcc stderr}.
BUILD_INFO = {}


def _nvcc():
  found = shutil.which('nvcc')
  if found:
    return found
  default = '/usr/local/cuda/bin/nvcc'
  if os.path.exists(default):
    return default
  raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit.')


def _sources(name):
  """The kernel's .cu file plus every shared header in csrc/."""
  headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
  return [os.path.join(CSRC_DIR, f'{name}.cu')] + [
      os.path.join(CSRC_DIR, h) for h in headers]


def library_path(name):
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for path in _sources(name):
    with open(path, 'rb') as f:
      digest.update(f.read())
  return os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')


def load(name):
  """The ctypes handle of csrc/<name>.cu, compiled on first use."""
  if name in _LIBS:
    return _LIBS[name]
  out = library_path(name)
  info = {'seconds': 0.0, 'log': ''}
  if not os.path.exists(out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, _sources(name)[0]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    info = {'seconds': time.perf_counter() - t0, 'log': proc.stderr}
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc failed for {name}:\n{proc.stdout}\n'
                         f'{proc.stderr}')
    os.replace(tmp, out)
  BUILD_INFO[name] = info
  _LIBS[name] = ctypes.CDLL(out)
  return _LIBS[name]


def check(status, what):
  """Raise on a non-zero cudaError_t returned by a C entry point."""
  if status != 0:
    raise RuntimeError(f'{what}: CUDA error {status} at launch.')
