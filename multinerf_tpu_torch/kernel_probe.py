"""Where the time of the forward kernels K1 and K2 goes, on the GPU.

Builds variants of ``csrc/density_mlp.cu`` (K1) and ``csrc/featurize_dense.cu``
(K2) with parts of their tile pass taken out, each from a patched copy of
``csrc/`` under ``build/``, and times every variant at the main path's shapes
(K1: 262,144 samples through 360.gin's 504 -> 4 x 256 PropMLP; K2: 131,072
samples, 504 -> 1,024) through the kernels' own wrappers, with CUDA events
around 10 calls queued back to back, in rounds that take the variants in
turn.  Each variant runs with the kernels' clusters of two CTAs and with one
CTA per weight stream.  A variant's output is meaningless; only its time is
read.

    python -m multinerf_tpu_torch.kernel_probe

Prints the card's name and power limit, one line per variant and kernel, and
one JSON object as the last line.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from multinerf_tpu_torch.ops import geopoly
from multinerf_tpu_torch.ops.kernels import build
from multinerf_tpu_torch.ops.kernels import density_mlp as dm
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
from multinerf_tpu_torch.ops.kernels import plans

_FEATURIZE = ('      featurize_tile(means, covs, basis_t, bb_t, row0, n, '
              'num_dims,\n                     num_degs, use_contract != 0, '
              'kpad64, x, scratch, wtid,\n                     bar_id);\n')
_NO_FEATURIZE = {name: (_FEATURIZE, '      named_sync(bar_id, 128);\n')
                 for name in ('density_mlp.cu', 'featurize_dense.cu')}
_NO_PRODUCTS = {'tile_pass.cuh': ('for (int k = 0; k < kSlabK / 16; ++k) {',
                                  'for (int k = 0; k < 0; ++k) {')}
# One CTA per weight stream instead of a cluster of two sharing it by
# multicast (with plans.FWD_CLUSTER set to match).
_SINGLE_CTA = {'tile_pass.cuh': ('constexpr int kFwdCluster = 2;',
                                 'constexpr int kFwdCluster = 1;')}
_NO_EPILOGUE = {
    'density_mlp.cu': (
        'bias_relu_bf16<W>(acc, bias, x, pos, [](int, float, float) {});',
        ''),
    'featurize_dense.cu': ('if (row0 >= n) continue;', 'continue;')}

K1_N = 4096 * 64
K2_N = 4096 * 32


def _merge(*patches):
  """{file: [(text, replacement), ...]} of several patch sets."""
  out = {}
  for patch in patches:
    for name, rule in patch.items():
      out.setdefault(name, []).append(rule)
  return out


# Variant -> (patches {file: [(text, replacement), ...]}, cluster size):
# what each takes out, with the 2-CTA clusters or one CTA per stream.
_TAKEOUTS = {
    'no_featurize': (_NO_FEATURIZE,),
    'no_products': (_NO_PRODUCTS,),
    'no_epilogue': (_NO_EPILOGUE,),
    'featurize_only': (_NO_PRODUCTS, _NO_EPILOGUE),
    'products_only': (_NO_FEATURIZE, _NO_EPILOGUE),
    'ring_only': (_NO_FEATURIZE, _NO_EPILOGUE, _NO_PRODUCTS),
}
VARIANTS = {}
for _cluster, _prefix in ((2, ''), (1, 'single_cta_')):
  _base = (_SINGLE_CTA,) if _cluster == 1 else ()
  VARIANTS[_prefix + 'full'] = (_merge(*_base), _cluster)
  for _name, _parts in _TAKEOUTS.items():
    VARIANTS[_prefix + _name] = (_merge(*_base, *_parts), _cluster)
ROUNDS = 5  # Every variant timed once per round, the rounds in turn.


def _patched_csrc(src, dst, variant, patches):
  """A copy of the sources in src at dst, with `patches` applied."""
  shutil.rmtree(dst, ignore_errors=True)
  shutil.copytree(src, dst)
  for name, rules in patches.items():
    path = os.path.join(dst, name)
    with open(path) as f:
      text = f.read()
    for old, new in rules:
      if text.count(old) != 1:
        raise RuntimeError(f'{variant}: {name} holds {text.count(old)} '
                           f'copies of {old!r}, expected 1.')
      text = text.replace(old, new)
    with open(path, 'w') as f:
      f.write(text)
  return dst


def _time_ms(fn, calls=10, warmup=3):
  """Device ms per call of `calls` calls queued back to back (CUDA events
  around all of them), so that the host's time between calls is hidden."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(calls):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / calls


def _inputs(rng, n):
  means = torch.tensor((rng.randn(n, 3) * 2.0).astype(np.float32),
                       device='cuda')
  a = rng.randn(n, 3, 3).astype(np.float32) * 0.05
  covs = torch.tensor(a @ np.swapaxes(a, -1, -2), device='cuda')
  return means, covs


def _uniform(rng, fan_in, fan_out):
  lim = np.sqrt(6.0 / fan_in)
  return torch.tensor(rng.uniform(-lim, lim, (fan_in, fan_out)).astype(
      np.float32), device='cuda')


def main():
  if not torch.cuda.is_available():
    raise SystemExit('FAIL: the probe needs a CUDA GPU.')
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0]
  print(smi, flush=True)
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T
  num_feats = 2 * 12 * basis.shape[-1]
  rng = np.random.RandomState(0)
  m1, c1 = _inputs(rng, K1_N)
  ws = [_uniform(rng, num_feats, 256)] + [_uniform(rng, 256, 256)
                                          for _ in range(3)]
  bs = [torch.zeros(256, device='cuda') for _ in ws]
  wd = _uniform(rng, 256, 1)
  bd = torch.zeros((), device='cuda')
  m2, c2 = _inputs(rng, K2_N)
  w = _uniform(rng, num_feats, 1024)
  b = torch.zeros(1024, device='cuda')
  run = {
      'density_mlp': lambda: dm.density_mlp_forward(
          m1, c1, ws, bs, wd, bd, basis, 0, 12, True),
      'featurize_dense': lambda: fd.featurize_dense_forward(
          m2, c2, w, b, basis, 0, 12, True),
  }
  csrc, build_dir = build.CSRC_DIR, build.BUILD_DIR
  cluster = plans.FWD_CLUSTER
  libs = {}
  try:
    for variant, (patches, _) in VARIANTS.items():
      root = os.path.join(os.path.dirname(build_dir), 'probe', variant)
      build.CSRC_DIR = _patched_csrc(csrc, os.path.join(root, 'csrc'),
                                     variant, patches)
      build.BUILD_DIR = os.path.join(root, 'lib')
      build._LIBS.clear()
      libs[variant] = build.load_all(tuple(run))
      for name in run:
        print(f'{variant} {name}: '
              f'{build.kernel_resources(build.BUILD_INFO[name]["log"])}',
              flush=True)
    times = {v: {name: [] for name in run} for v in VARIANTS}
    for _ in range(ROUNDS):
      for variant, (_, cluster_size) in VARIANTS.items():
        build._LIBS.clear()
        build._LIBS.update(libs[variant])
        fd._MAX_CLUSTERS.clear()
        plans.FWD_CLUSTER = cluster_size
        for name, fn in run.items():
          times[variant][name].append(_time_ms(fn))
  finally:
    build.CSRC_DIR, build.BUILD_DIR = csrc, build_dir
    build._LIBS.clear()
    fd._MAX_CLUSTERS.clear()
    plans.FWD_CLUSTER = cluster
  results = {}
  for variant, by_name in times.items():
    results[variant] = {}
    for name, ts in by_name.items():
      results[variant][name] = statistics.median(ts)
      print(f'{variant} {name}: {statistics.median(ts):.3f} ms (median of '
            f'{ROUNDS} rounds of 10 calls back to back; range '
            f'{min(ts):.3f}-{max(ts):.3f})', flush=True)
  print(json.dumps({'device': torch.cuda.get_device_name(0), 'smi': smi,
                    'ms': results}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
