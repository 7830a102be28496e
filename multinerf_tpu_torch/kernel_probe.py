"""Where the time of the forward kernels K1 and K2, and of the int8 trunk's
forward K5 and backward K6, goes, on the GPU.

Builds variants of ``csrc/density_mlp.cu`` (K1), ``csrc/featurize_dense.cu``
(K2), ``csrc/int8_trunk.cu`` (K5) and ``csrc/int8_trunk_bwd.cu`` (K6, K5 and
K6 on ``csrc/int8_tile_pass.cuh``) with parts taken out, each from a
patched copy of ``csrc/`` under ``build/``, and times every variant at the
main path's shapes (K1: 262,144 samples through 360.gin's 504 -> 4 x 256
PropMLP; K2: 131,072 samples, 504 -> 1,024; K5: 131,072 samples through the
8 x 1,024 NerfMLP trunk, and 524,288, one render chunk; K6: 131,072 samples,
'int8' and 'int8_hybrid') through the kernels' own wrappers, with CUDA
events around 10 calls queued back to back (K5, K6: 3), in rounds that take
the variants in turn.  K1's and K2's variants run with the kernels'
clusters of two CTAs and with one CTA per weight stream.  A variant's
output is meaningless; only its time is read.

    python -m multinerf_tpu_torch.kernel_probe [--kernels k1k2|k5|k6|all]

Prints the card's name and power limit, one line per variant and kernel, and
one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
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
K5_CHUNK = 16384 * 32  # One render chunk of the NerfMLP level.


def _merge(*patches):
  """{file: [(text, replacement), ...]} of several patch sets (a set maps a
  file to one rule or a list of rules)."""
  out = {}
  for patch in patches:
    for name, rules in patch.items():
      out.setdefault(name, []).extend(
          rules if isinstance(rules, list) else [rules])
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

# K6 (int8_trunk_bwd.cu): its launch sequence with stages left out (the
# tile pass, the featurize stage, the bf16 and int8 dW GEMMs, the group
# quantizer), and its tile pass without parts (the scratch stores, the
# column reductions, pass 2's per-sample quantization).
_K6 = 'int8_trunk_bwd.cu'
_TILE = 'int8_tile_pass.cuh'  # The tile pass that K5 and K6 share.
_K6_NO_TILE = {_K6: (
    '  err = bn == 128 ? launch_tile_pass<128>(maps, args, grid, smem, st)\n'
    '                  : launch_tile_pass<64>(maps, args, grid, smem, st);',
    '  err = cudaSuccess;')}
_K6_NO_FEATURIZE = {_K6: ('  err = featurize_cast(f32(means)',
                          '  if (false) err = featurize_cast(f32(means)')}
_K6_NO_FEATURE_DW = {_K6: ('    return dw_gemm<Int8TrunkBwd>(feats_h',
                           '    if (l >= 0) return cudaSuccess;\n'
                           '    return dw_gemm<Int8TrunkBwd>(feats_h')}
_K6_NO_HIDDEN_BF16 = {_K6: ('      err = dw_gemm<Int8TrunkBwd>(\n',
                            '      if (false) err = dw_gemm<Int8TrunkBwd>(\n')}
_K6_NO_QUANTIZE = {_K6: ('    group_quantize_kernel<<<qgrid',
                         '    if (false) group_quantize_kernel<<<qgrid')}
_K6_NO_S8 = {_K6: ('        err = int8_dw(qx, qd,',
                   '        err = cudaSuccess;\n'
                   '        if (false) err = int8_dw(qx, qd,')}
_K6_NO_STORES = {_TILE: [
    ('      *reinterpret_cast<float2*>(dst + (size_t)(p.r_lo + 8 * h)',
     '      if (false) *reinterpret_cast<float2*>(dst + (size_t)(p.r_lo + 8 * h)'),
    ('      *reinterpret_cast<__nv_bfloat162*>(\n',
     '      if (false) *reinterpret_cast<__nv_bfloat162*>(\n')]}
_K6_NO_REDUCTIONS = {_K6: ('  const int lane = wtid % 32, warp = wtid / 32;\n',
                           '  if (wtid >= 0) return;\n'
                           '  const int lane = wtid % 32, warp = wtid / 32;\n')}
_NO_PASS2 = {_TILE: (
    '  for (int i0 = tid; i0 < total; i0 += kBatch * kI8Consumers) {\n'
    '    float4 x[kBatch];',
    '  for (int i0 = tid; i0 < 0; i0 += kBatch * kI8Consumers) {\n'
    '    float4 x[kBatch];')}
# Pass 2 quantizing with div.rn (x / s) instead of the reciprocal and one
# FMA correction; the probe also checks that both give the same outputs.
_K6_PASS2_DIVIDE = {_TILE: (
    '  const float q = __fmul_rn(x, r);\n'
    '  return (unsigned)(__float2int_rn(__fmaf_rn(__fmaf_rn(-q, s, x), r, q)) &\n'
    '                    0xff);',
    '  return (unsigned)(__float2int_rn(x / s) & 0xff);')}
_K6_DW = (_K6_NO_FEATURIZE, _K6_NO_FEATURE_DW, _K6_NO_HIDDEN_BF16,
          _K6_NO_QUANTIZE, _K6_NO_S8)
K6_VARIANTS = {
    'full': (),
    'tile_pass_only': _K6_DW,
    'dw_only': (_K6_NO_TILE,),
    'group_quantize_only': (_K6_NO_TILE, _K6_NO_FEATURIZE, _K6_NO_FEATURE_DW,
                            _K6_NO_HIDDEN_BF16, _K6_NO_S8),
    'no_scratch_stores': (_K6_NO_STORES,),
    'tile_no_reductions': _K6_DW + (_K6_NO_REDUCTIONS,),
    'tile_no_pass2': _K6_DW + (_NO_PASS2,),
    'pass2_divide': (_K6_PASS2_DIVIDE,),
    'tile_products_only': _K6_DW + (_K6_NO_STORES, _K6_NO_REDUCTIONS,
                                    _NO_PASS2),
}
# K5 (int8_trunk.cu): its tile pass without the staging stores of the
# hidden layers' rows (pass 2 then reads whatever the block holds), without
# pass 2's per-sample quantization, or with neither and no output stores.
_K5 = 'int8_trunk.cu'
_K5_NO_STAGING = {_K5: (
    '          store_block<BN>(y, stage, width, pos, col0);',
    '          if (false) store_block<BN>(y, stage, width, pos, col0);')}
_K5_NO_OUTPUT = {_K5: ('              if (row < p.n)',
                       '              if (false)')}
K5_VARIANTS = {
    'full': (),
    'no_pass2': (_NO_PASS2,),
    'no_staging_stores': (_K5_NO_STAGING,),
    'products_only': (_K5_NO_STAGING, _NO_PASS2, _K5_NO_OUTPUT),
}
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


def _build(variants, names):
  """{variant: {name: library}}: every variant's libraries of `names`, each
  built from its patched copy of the sources, all nvcc runs at once."""
  csrc, build_dir = build.CSRC_DIR, build.BUILD_DIR
  dirs, started, libs = {}, {}, {}
  try:
    for variant, patches in variants.items():
      root = os.path.join(os.path.dirname(build_dir), 'probe', variant)
      dirs[variant] = (_patched_csrc(csrc, os.path.join(root, 'csrc'),
                                     variant, patches),
                       os.path.join(root, 'lib'))
      build.CSRC_DIR, build.BUILD_DIR = dirs[variant]
      build._LIBS.clear()
      started[variant] = {name: build._start(name) for name in names}
    for variant in variants:
      build.CSRC_DIR, build.BUILD_DIR = dirs[variant]
      build._LIBS.clear()
      libs[variant] = {}
      for name in names:
        build.BUILD_INFO.pop(name, None)
        libs[variant][name] = build._finish(name, started[variant][name])
        print(f'{variant} {name}: '
              f'{build.kernel_resources(build.BUILD_INFO[name]["log"])}',
              flush=True)
  finally:
    build.CSRC_DIR, build.BUILD_DIR = csrc, build_dir
    build._LIBS.clear()
  return libs


def _k1k2(basis, num_feats, rng):
  """K1's and K2's variants: {variant: (patches, cluster size)}, and the
  calls to time."""
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
  return VARIANTS, run


def _k6(basis, num_feats, rng):
  """K6's variants (no clusters) and its calls in both bindings."""
  means, covs = _inputs(rng, K2_N)
  width, skip = 1024, (5,)
  ws = [_uniform(rng, num_feats if l == 0 else
                 width + (num_feats if l in skip else 0), width)
        for l in range(8)]
  bs = [torch.zeros(width, device='cuda') for _ in ws]
  g = torch.as_tensor(np.abs(rng.randn(K2_N, width)).astype(np.float32),
                      device='cuda').to(torch.bfloat16)
  run = {
      f'int8_trunk_bwd{tag}': (lambda hybrid=hybrid: i8t.int8_trunk_backward(
          means, covs, ws, bs, g, basis, 0, 12, True, skip, hybrid))
      for tag, hybrid in (('', False), ('_hybrid', True))}
  return {v: (_merge(*parts), 1) for v, parts in K6_VARIANTS.items()}, run


def _k5(basis, num_feats, rng):
  """K5's variants (no clusters) and its calls at the training chunk's N
  and at the render chunk's."""
  means, covs = _inputs(rng, K5_CHUNK)
  width, skip = 1024, (5,)
  ws = [_uniform(rng, num_feats if l == 0 else
                 width + (num_feats if l in skip else 0), width)
        for l in range(8)]
  bs = [torch.zeros(width, device='cuda') for _ in ws]
  run = {
      f'int8_trunk{tag}': (lambda n=n: i8t.int8_trunk_forward(
          means[:n], covs[:n], ws, bs, basis, 0, 12, True, skip))
      for tag, n in (('', K2_N), ('_chunk', K5_CHUNK))}
  return {v: (_merge(*parts), 1) for v, parts in K5_VARIANTS.items()}, run


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--kernels', choices=('k1k2', 'k5', 'k6', 'all'),
                      default='all')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('FAIL: the probe needs a CUDA GPU.')
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0]
  print(smi, flush=True)
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T
  num_feats = 2 * 12 * basis.shape[-1]
  rng = np.random.RandomState(0)
  groups = []  # (variants, calls, calls per timing).
  if args.kernels in ('k1k2', 'all'):
    groups.append(_k1k2(basis, num_feats, rng) + (10,))
  if args.kernels in ('k6', 'all'):
    groups.append(_k6(basis, num_feats, rng) + (3,))
  if args.kernels in ('k5', 'all'):
    groups.append(_k5(basis, num_feats, rng) + (3,))
  cluster = plans.FWD_CLUSTER
  results, checks = {}, {}
  try:
    for variants, run, calls in groups:
      libs = _build({v: patches for v, (patches, _) in variants.items()},
                    tuple({re.sub('_(hybrid|chunk)$', '', name)
                           for name in run}))
      times = {v: {name: [] for name in run} for v in variants}
      for _ in range(ROUNDS):
        for variant, (_, cluster_size) in variants.items():
          build._LIBS.clear()
          build._LIBS.update(libs[variant])
          fd._MAX_CLUSTERS.clear()
          plans.FWD_CLUSTER = cluster_size
          for name, fn in run.items():
            times[variant][name].append(_time_ms(fn, calls))
      if 'pass2_divide' in variants:
        # The reciprocal quantizer against div.rn: the same outputs?
        outs = {}
        for variant in ('full', 'pass2_divide'):
          build._LIBS.clear()
          build._LIBS.update(libs[variant])
          outs[variant] = {name: fn() for name, fn in run.items()}
        for name in run:
          got, want = outs['full'][name], outs['pass2_divide'][name]
          same = all(torch.equal(a, b) for a, b in
                     zip([*got[0], *got[1]], [*want[0], *want[1]]))
          print(f'pass2_divide {name}: outputs bitwise equal to full: '
                f'{same}', flush=True)
          checks[f'pass2_divide {name} bitwise equal to full'] = same
      for variant, by_name in times.items():
        for name, ts in by_name.items():
          results.setdefault(variant, {})[name] = statistics.median(ts)
          print(f'{variant} {name}: {statistics.median(ts):.3f} ms (median '
                f'of {ROUNDS} rounds of {calls} calls back to back; range '
                f'{min(ts):.3f}-{max(ts):.3f})', flush=True)
  finally:
    build._LIBS.clear()
    fd._MAX_CLUSTERS.clear()
    plans.FWD_CLUSTER = cluster
  print(json.dumps({'device': torch.cuda.get_device_name(0), 'smi': smi,
                    'ms': results, 'checks': checks}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
