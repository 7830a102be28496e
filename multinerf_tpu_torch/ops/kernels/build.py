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
import re
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


def _start(name):
  """Start nvcc for csrc/<name>.cu unless its library exists: (out, tmp,
  process, start time) or None."""
  if name in _LIBS:
    return None
  out = library_path(name)
  if os.path.exists(out):
    return None
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = f'{out}.{os.getpid()}.tmp'
  cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, _sources(name)[0]]
  t0 = time.perf_counter()
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
  return out, tmp, proc, t0


def _finish(name, started):
  if started is not None:
    out, tmp, proc, t0 = started
    stdout, stderr = proc.communicate()
    BUILD_INFO[name] = {'seconds': time.perf_counter() - t0, 'log': stderr}
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc failed for {name}:\n{stdout}\n{stderr}')
    os.replace(tmp, out)
  elif name not in BUILD_INFO:
    BUILD_INFO[name] = {'seconds': 0.0, 'log': ''}
  if name not in _LIBS:
    _LIBS[name] = ctypes.CDLL(library_path(name))
  return _LIBS[name]


def load(name):
  """The ctypes handle of csrc/<name>.cu, compiled on first use."""
  if name in _LIBS:  # Every launch asks: skip hashing the sources.
    return _LIBS[name]
  return _finish(name, _start(name))


def load_all(names):
  """Compile the missing libraries of `names` at once, one nvcc process
  each, then load them all."""
  started = {name: _start(name) for name in names}
  try:
    return {name: _finish(name, started[name]) for name in names}
  finally:
    for job in started.values():
      if job is not None and job[2].poll() is None:
        job[2].kill()
        job[2].wait()


def short_name(mangled):
  """'_ZN3mnt14dw_gemm_kernelILi256ENS_13DensityMlpBwdEEEv...' ->
  'dw_gemm_kernel<256, DensityMlpBwd>' (names in namespace mnt only)."""
  m = re.match(r'_ZN3mnt(\d+)', mangled)
  if m is None:
    return mangled
  end = m.end() + int(m.group(1))
  ident, rest = mangled[m.end():end], mangled[end:]
  args = []
  pos = 1 if rest.startswith('I') else len(rest)
  while pos < len(rest) and rest[pos] != 'E':
    lit = re.match(r'Li(-?\d+)E', rest[pos:])
    typ = re.match(r'(?:N3mnt|NS_)(\d+)', rest[pos:])
    if lit:
      args.append(lit.group(1))
      pos += lit.end()
    elif typ:
      start = pos + typ.end()
      args.append(rest[start:start + int(typ.group(1))])
      pos = start + int(typ.group(1)) + 1  # The name's closing E.
    else:
      break
  return ident + (f'<{", ".join(args)}>' if args else '')


def kernel_resources(log):
  """{kernel: {'registers', 'spill_stores', 'spill_loads'}} from a ptxas -v
  log (BUILD_INFO[name]['log']), kernels by short_name."""
  out, func, spills = {}, None, (0, 0)
  for line in log.splitlines():
    m = re.search(r'Function properties for (\S+)', line)
    if m:
      func, spills = short_name(m.group(1)), (0, 0)
      continue
    m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
    if m:
      spills = (int(m.group(1)), int(m.group(2)))
    m = re.search(r'Used (\d+) registers', line)
    if m and func is not None:
      out[func] = {'registers': int(m.group(1)), 'spill_stores': spills[0],
                   'spill_loads': spills[1]}
      func = None
  return out


def check(status, what):
  """Raise on a non-zero cudaError_t returned by a C entry point."""
  if status != 0:
    raise RuntimeError(f'{what}: CUDA error {status} at launch.')
