"""Smoke test of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from ``multinerf_tpu_torch/csrc``, holds each against its plain
PyTorch version at the render and training shapes (the forward kernels
also at the edges of their tiles and at narrow widths, K2 at 672 features
too), renders ``configs/360.gin`` at full model width through ``python -m
multinerf_tpu_torch.render``'s entry point, trains it for 100 steps of
4,096 rays through ``python -m multinerf_tpu_torch.train``'s, holds one
train step on the GPU against the CPU, and checks that both paths went
through the kernels; runs the whole train driver on the device-resident
sampler (30 steps, a resume to 60, checkpoints, summaries read back,
in-train renders) and ``python -m multinerf_tpu_torch.eval`` on its final
checkpoint; then renders and trains it under ``trunk_dtype='bfloat16'``
(the same kernels K1-K4, and a bf16 train step GPU vs CPU), and under
``trunk_dtype='int8'`` and ``'int8_hybrid'`` (the int8 trunk kernels K5 and
K6; K5 is also held and timed at one render chunk of 524,288 samples);
last, trains, evaluates and renders ``configs/blender_refnerf.gin``
(Ref-NeRF) at full width on ``dummy_specular``, holds one of its steps on
the GPU against the CPU, and checks that this path launched none of the
kernels, as in the JAX package.  Then the real-capture data plane: it
writes two captures of the dummy_unbounded scene in the layout COLMAP
leaves (``sparse/0``, Exif-only JPEG originals, an ``images_4`` PNG level),
one unbounded through a distorted OPENCV camera, one forward-facing with
``poses_bounds.npy``, and drives ``configs/360.gin`` (host path and device
plane) and ``configs/llff_256.gin`` (after K1-K4 are held against their
plain versions at its shapes) through train, eval and render on them,
holding each capture's rays cast on the card against the host cast.  Last,
the rest of the model zoo: K2 and K4 held against their plain versions at
``configs/llff_raw.gin``'s shape (N = 2,097,152, outputs over 2^31 bytes),
then RawNeRF trained at its 16,384 rays a step on a raw capture in the
HDR+ test-scene layout the script writes (RGGB mosaics with ``.npy``
sidecars, exiftool JSON, three shutter buckets), evaluated under
``llff_raw_test.gin`` (affine color correction, cropped borders) and
rendered through the raw tonemap; RobustNeRF (``360_robustnerf.gin``, 16 x
16 patches, the loss threshold fed back) on ``dummy_distractor`` on both
data paths; GLO (``360_glo4.gin``) trained, evaluated and rendered with
zero GLO vectors; each with one step on the GPU against the CPU.  Last,
the 512-wide configs and the file formats: K1-K4 held against their plain
versions at 672 features (``configs/blender_512.gin``'s and
``llff_512.gin``'s: K1/K3 4 x 256 over 2,097,152 samples, K3's two-part
layer 0 bitwise against its one-part layout, K2/K4 672 -> 512 over
524,288); blender_512.gin trained 30 steps of 16,384 rays on a Blender-
layout scene the script writes (800 x 800 RGBA PNGs, linear TIFF channels
and disparities), one step GPU vs CPU, evaluated with ``use_tiffs``, the
disparity metrics and LPIPS (random weights; one view's LPIPS on the card
against the host), its test views rendered and assembled into MJPEG AVIs
that are read back; llff_512.gin the same on the forward-facing capture
with its ``images_4`` level written as JPEGs by the port's encoder (the
decoder held against the arrays encoded).  Occupancy culling (after the
GLO phase): 360.gin with the bf16 trunk trains on ``dummy_scatter`` with
the capacity ladder 0.33 / 0.5 / 0.67 on the host path (the grid's refresh
probe timed, eval unculled), each rung forced from the saved state beside
the unculled step, K2 and K4 held at the 0.33 rung's N = 43,008, a culled
step and a weight-decay step on the GPU against the CPU, ``int8_hybrid``
forced at 0.33 (K5/K6 at N = capacity); then the multi-step window
(``steps_per_jit_call = 8`` on the device plane) with and without culling
beside single device-plane steps, and one window held against 8 single
steps.  Last: a 128 x 64 pano path of 360.gin on the distorted capture
through ``render.main`` (frames, AVIs, 2 K1 + 2 K2 a frame; a 16 x 8 pano
frame GPU vs CPU; a perspective view from host-cast rays against the
card's cast), ``render_many`` of 8 test views against 8 single calls
(bitwise, and the ms a frame of both), ``blender_refnerf.gin`` under both
int8 bindings (train, eval with normal MAEs, a frame, a step GPU vs CPU,
no kernel), and ``blender_256.gin`` and ``debug.gin`` trained, evaluated
and rendered briefly.  Last, data parallelism through ``python -m
torch.distributed.run`` (``phase_ddp``): the train entry point at one NCCL
rank, its losses bitwise those of the run with no launcher; two gloo ranks
sharing the card, their fixed-batch step held against one process's, the
train driver (K1-K4 every step on each rank, only rank 0 writing) and eval
against one rank's; two NCCL ranks where there are two cards.  Then the
model axis (``phase_tp_kernels``, ``phase_tp``): K2 and K4 at a model
rank's 504 -> 512 columns, then two gloo ranks sharing the card at model
size 2, their bf16 and int8 fixed-batch steps held against one process's
(with the control of a model rank's part dropped), their launches per
step, the bytes a rank holds and a test view; two NCCL ranks where there
are two cards.  Last, grid-culled rendering (``phase_cull_render``):
360.gin's 64 x 64 test view through ``train_lib.create_render_fn(model,
cull=...)`` under the bf16 and the int8 trunk, at capacity 1.0 through a
grid that keeps every cell (bitwise the unculled frame), and at the rungs
0.5 and 0.33 through a half-empty grid (a 16 x 16 frame on the card
against the CPU, which culls by the card's keep masks), K2 and K5
launched at N = capacity and held there against their plain versions;
then the quality harnesses (``phase_harnesses``): ``cull_quality``,
``int8_eval_decision`` and ``keep_frac_probe`` through their entry points
for a few dozen steps, each in a process of its own with a time limit,
their outputs' keys checked.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Exits non-zero on any failure (and without a GPU); on success the last line
is ``{"ok": true, "device": {...}}`` and the line before it the per-kernel
JSON summary.
"""

import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# max |kernel - plain| <= TOL * max(1, max |plain|): the bf16-level bound of
# tests/test_pallas_*.py.  Both sides round features and weights to bf16;
# they differ only in summation order and in the last bits of sin/exp.
TOL = 2e-2

K1_SAMPLES = 4096 * 64  # One 4,096-ray chunk of a proposal level.
K2_SAMPLES = 4096 * 32  # One 4,096-ray chunk of the NerfMLP level.
# The NerfMLP level of one render chunk (16,384 rays x 32 samples): K5's
# call on the int8 render path.
K5_CHUNK = 16384 * 32
RAGGED = 37  # Samples cut off the full tile count to exercise the edge mask.


def log(msg):
  print(msg, flush=True)


def phase_device():
  """The card's name and power limit, as nvidia-smi prints them."""
  if not torch.cuda.is_available():
    raise SystemExit('FAIL device: torch.cuda.is_available() is false.')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  log(card)
  log(f'device: {torch.cuda.get_device_name(0)}, count '
      f'{torch.cuda.device_count()}, torch {torch.__version__}, '
      f'cuda {torch.version.cuda}, python {sys.version.split()[0]}')
  # 360.gin's hidden layers are float32; the reference numerics are full f32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return card


KERNEL_LIBS = ('density_mlp', 'featurize_dense', 'density_mlp_bwd',
               'featurize_dense_dw', 'int8_trunk', 'int8_trunk_bwd')


def phase_build():
  """All six libraries, one nvcc each, started together."""
  from multinerf_tpu_torch.ops.kernels import build
  t0 = time.perf_counter()
  build.load_all(KERNEL_LIBS)
  log(f'build: {time.perf_counter() - t0:.2f} s for {len(KERNEL_LIBS)} '
      'libraries in parallel')
  for name in KERNEL_LIBS:
    info = build.BUILD_INFO[name]
    log(f'build {name}: {info["seconds"]:.2f} s')
    for func, r in build.kernel_resources(info['log']).items():
      log(f'  {func}: {r["registers"]} registers, spills '
          f'{r["spill_stores"]} B stored / {r["spill_loads"]} B loaded')


def _gaussians(n, seed):
  """Means and covs as in tests/test_pallas_density_mlp.py, with one sample
  in 8 moved out to radius 1e3..1e6: the contraction's far branch and the
  safe_sin modulo branch both run."""
  rng = np.random.RandomState(seed)
  means = (rng.randn(n, 3) * 2.0).astype(np.float32)
  far = rng.rand(n) < 0.125
  dirs = rng.randn(n, 3)
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  radius = 10.0**rng.uniform(3, 6, n)
  means[far] = (dirs * radius[:, None])[far].astype(np.float32)
  a = rng.randn(n, 3, 3).astype(np.float32) * 0.05
  covs = a @ np.swapaxes(a, -1, -2)
  return (torch.tensor(means, device='cuda'),
          torch.tensor(covs, device='cuda'))


def _he_uniform(rng, fan_in, fan_out):
  lim = np.sqrt(6.0 / fan_in)
  return torch.tensor(rng.uniform(-lim, lim, (fan_in, fan_out)).astype(
      np.float32), device='cuda')


def _prop_trunk(rng, num_feats):
  """PropMLP trunk 504 -> 4 x 256 and its density head."""
  ws = [_he_uniform(rng, num_feats, 256)] + [
      _he_uniform(rng, 256, 256) for _ in range(3)]
  bs = [torch.tensor(rng.randn(256).astype(np.float32) * 0.1, device='cuda')
        for _ in ws]
  return ws, bs, _he_uniform(rng, 256, 1)


def _time_ms(fn, reps=10, warmup=3):
  """Median of `reps` single-call times (CUDA events), after warm-up."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def _hold(name, got, again, want, what):
  """One forward kernel's output against its plain version: same shape,
  finite, max |kernel - plain| <= TOL * max(1, max |plain|), and a second
  launch bitwise equal.  Returns max |kernel - plain|."""
  torch.cuda.synchronize()
  if got.shape != want.shape:
    raise SystemExit(f'FAIL {name} {what}: shape {tuple(got.shape)} vs '
                     f'{tuple(want.shape)}')
  if not bool(torch.isfinite(got).all()):
    raise SystemExit(f'FAIL {name} {what}: non-finite kernel output')
  if not torch.equal(got, again):
    raise SystemExit(f'FAIL {name} {what}: two launches differ.')
  err = float((got - want).abs().max())
  bound = TOL * max(1.0, float(want.abs().max()))
  log(f'{name} {what}: max|kernel - plain| = {err:.3e} (bound {bound:.3e}, '
      f'max|plain| {float(want.abs().max()):.3e}); two launches bitwise '
      'equal')
  if not err <= bound:
    raise SystemExit(f'FAIL {name} {what}: disagrees with its plain version.')
  return err


def _compare(name, run_kernel, run_plain, n_full):
  """Kernel vs plain at n_full and n_full - RAGGED; returns the summary."""
  worst = 0.0
  for n in (n_full, n_full - RAGGED):
    got, again = run_kernel(n), run_kernel(n)
    worst = max(worst, _hold(name, got, again, run_plain(n), f'N={n}'))
  return _summary(name, run_kernel, run_plain, n_full, worst)


# The forward kernels at the edges of their 128-sample tiles, and at widths
# narrower than the main path's (K1's trunk zero-padded by the wrapper, K2's
# output columns masked in the kernel): (N, width) pairs.
EDGE_N = (1, 129, 300)
K1_NARROW = (32, 64, 128)
K2_NARROW = (64, 96)


def _hold_edges(name, run_kernel, run_plain, cases):
  """Kernel vs plain at each (n, width) of `cases`, before any timing."""
  for n, width in cases:
    got, again = run_kernel(n, width), run_kernel(n, width)
    _hold(name, got, again, run_plain(n, width), f'N={n} width {width}')


def log_forward_plans(num_feats, num_dims, w=1024, n1=K1_SAMPLES,
                      n2=K2_SAMPLES):
  """K1's and K2's launch plans at a kernel phase's shapes (by default
  360.gin's: K1 4 x 256 over n1, K2 to `w` columns over n2): dynamic
  shared memory per CTA (the C entry points, held against plans.py), ring
  depth and grid."""
  from multinerf_tpu_torch.ops.kernels import build
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  from multinerf_tpu_torch.ops.kernels import plans
  k1 = fd.fwd_plan(plans.density_mlp_fwd_plan, 'density_mlp', num_feats, 256,
                   num_dims, n1)
  k2 = fd.fwd_plan(plans.featurize_dense_fwd_plan, 'featurize_dense',
                   num_feats, w, num_dims, n2)
  k1_smem = build.load('density_mlp').density_mlp_smem
  k2_smem = build.load('featurize_dense').featurize_dense_smem
  for fn, args in ((k1_smem, 4), (k2_smem, 5)):
    fn.argtypes = [ctypes.c_int] * args
    fn.restype = ctypes.c_int
  smem = (k1_smem(k1.width, num_feats, num_dims, k1.stages),
          k2_smem(num_feats, num_dims, k2.width, k2.stages, int(k2.staged)))
  if smem != (k1.smem, k2.smem):
    raise SystemExit(f'FAIL plans: shared memory {smem} in the sources, '
                     f'{(k1.smem, k2.smem)} in plans.py')
  log(f'density_mlp: {k1.smem:,} bytes of dynamic shared memory per CTA, '
      f'a {k1.stages}-stage weight ring, {k1.clusters} persistent clusters '
      f'of 2 CTAs ({k1.grid} CTAs) over {k1.tiles} tiles of 128 samples')
  log(f'featurize_dense: {k2.smem:,} bytes per CTA, a {k2.stages}-stage '
      f'ring, {k2.col_slabs} column slabs of {k2.width}, stores '
      f'{"by TMA from shared memory" if k2.staged else "from registers"}, '
      f'{k2.clusters} clusters ({k2.grid} CTAs) over {k2.tiles} tiles')


def _summary(name, run_kernel, run_plain, n_full, worst):
  """Times the kernel and its plain version at n_full; the summary line."""
  ms = _time_ms(lambda: run_kernel(n_full))
  plain_ms = _time_ms(lambda: run_plain(n_full))
  log(f'{name} N={n_full}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms '
      '(median of 10, CUDA events)')
  return {'max_abs_err': worst, 'ms': ms, 'plain_ms': plain_ms}


def phase_kernels():
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
  num_feats = 2 * 12 * basis.shape[-1]
  log_forward_plans(num_feats, basis.shape[-1])
  rng = np.random.RandomState(0)
  results = {}

  # K1: PropMLP 504 -> 4 x 256 -> 1.
  means, covs = _gaussians(K1_SAMPLES, seed=1)
  ws, bs, wd = _prop_trunk(rng, num_feats)
  bd = torch.tensor(np.float32(-0.3), device='cuda')
  trunks = {256: (ws, bs, wd)}
  for width in K1_NARROW:
    trunks[width] = ([_he_uniform(rng, num_feats, width)] + [
        _he_uniform(rng, width, width) for _ in range(3)],
                     [torch.tensor(rng.randn(width).astype(np.float32) * 0.1,
                                   device='cuda') for _ in range(4)],
                     _he_uniform(rng, width, 1))
  edge = lambda n, width: (means[:n], covs[:n], *trunks[width], bd, basis)
  _hold_edges('density_mlp',
              lambda *a: dm.density_mlp(*edge(*a), use_contract=True),
              lambda *a: dm.density_mlp_plain(*edge(*a), use_contract=True),
              [(n, 256) for n in EDGE_N] + [(300, w) for w in K1_NARROW])
  args = lambda n: (means[:n], covs[:n], ws, bs, wd, bd, basis)
  results['density_mlp'] = _compare(
      'density_mlp',
      lambda n: dm.density_mlp(*args(n), use_contract=True),
      lambda n: dm.density_mlp_plain(*args(n), use_contract=True),
      K1_SAMPLES)

  # K2: NerfMLP layer 0, 504 -> 1024.
  means, covs = _gaussians(K2_SAMPLES, seed=2)
  w = _he_uniform(rng, num_feats, 1024)
  b = torch.tensor(rng.randn(1024).astype(np.float32) * 0.1, device='cuda')
  edge = lambda n, width: (means[:n], covs[:n], w[:, :width], b[:width],
                           basis)
  _hold_edges('featurize_dense',
              lambda *a: fd.featurize_dense(*edge(*a), use_contract=True),
              lambda *a: fd.featurize_dense_plain(*edge(*a),
                                                  use_contract=True),
              [(n, 1024) for n in EDGE_N] + [(300, w) for w in K2_NARROW])
  # 672 features (16 degrees): no room for the output staging, so the
  # kernel stores from registers.
  wide = (means[:300], covs[:300],
          _he_uniform(rng, 2 * 16 * basis.shape[-1], 1024), b, basis, 0, 16)
  _hold('featurize_dense', fd.featurize_dense(*wide),
        fd.featurize_dense(*wide), fd.featurize_dense_plain(*wide),
        'N=300 width 1024, 672 features')
  args = lambda n: (means[:n], covs[:n], w, b, basis)
  results['featurize_dense'] = _compare(
      'featurize_dense',
      lambda n: fd.featurize_dense(*args(n), use_contract=True),
      lambda n: fd.featurize_dense_plain(*args(n), use_contract=True),
      K2_SAMPLES)
  return results


def _compare_leaves(name, run_kernel, run_plain, n_full):
  """A backward kernel vs its plain version at n_full and n_full - RAGGED:
  per output leaf max |kernel - plain| <= TOL * max |plain|, and two
  launches on the same inputs bitwise equal.  Returns the summary."""
  worst = 0.0
  for n in (n_full, n_full - RAGGED):
    got, again, want = run_kernel(n), run_kernel(n), run_plain(n)
    torch.cuda.synchronize()
    rel = []
    for i, (a, b, w) in enumerate(zip(got, again, want)):
      if a.shape != w.shape:
        raise SystemExit(f'FAIL {name} leaf {i}: shape {tuple(a.shape)} vs '
                         f'{tuple(w.shape)}')
      if not torch.equal(a, b):
        raise SystemExit(f'FAIL {name} leaf {i}: two launches differ '
                         f'(N={n}): not deterministic.')
      if not bool(torch.isfinite(a).all()):
        raise SystemExit(f'FAIL {name} leaf {i}: non-finite at N={n}')
      err = float((a - w).abs().max())
      scale = float(w.abs().max())
      rel.append(err / scale if scale > 0 else err)
      if not err <= TOL * scale:
        raise SystemExit(f'FAIL {name} leaf {i} N={n}: max|kernel - plain| '
                         f'{err:.3e} > {TOL} * {scale:.3e}')
      worst = max(worst, err)
    log(f'{name} N={n}: {len(rel)} leaves within {TOL} * max|plain|, '
        f'max|kernel - plain| / max|plain| per leaf '
        f'{", ".join(f"{r:.2e}" for r in rel)}; two launches bitwise equal')
  return _summary(name, run_kernel, run_plain, n_full, worst)


def log_backward_plans(num_feats, num_dims, w=1024, n1=K1_SAMPLES,
                       n2=K2_SAMPLES):
  """K3's and K4's launch plans at a kernel phase's shapes (as
  log_forward_plans'): dynamic shared memory per CTA (the C entry points,
  held against plans.py), layer 0's K-parts and grids."""
  from multinerf_tpu_torch.ops.kernels import build
  from multinerf_tpu_torch.ops.kernels import plans
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  k3 = plans.density_mlp_bwd_plan(num_feats, 256, 4, num_dims, n1, sms)
  k4 = plans.featurize_dense_dw_plan(num_feats, w, num_dims, n2, sms)
  k3_smem = build.load('density_mlp_bwd').density_mlp_bwd_smem
  k4_smem = build.load('featurize_dense_dw').featurize_dense_dw_smem
  for fn, args in ((k3_smem, 5), (k4_smem, 3)):
    fn.argtypes = [ctypes.c_int] * args
    fn.restype = ctypes.c_int
  smem = (k3_smem(256, 4, num_feats, num_dims, k3.parts),
          k4_smem(num_feats, num_dims, k4.gemm.bn))
  if smem != (k3.smem, k4.smem):
    raise SystemExit(f'FAIL plans: shared memory {smem} in the sources, '
                     f'{(k3.smem, k4.smem)} in plans.py')
  log(f'density_mlp_bwd: tile pass {k3.smem:,} bytes of dynamic shared '
      f'memory per CTA, layer 0 in {k3.parts} K-part(s) of {k3.kx} columns, '
      f'{k3.grid} persistent CTAs over {k3.tiles} tiles of 128 samples; dW '
      f'GEMMs {k3.dw0.smem:,} bytes, grids {k3.dw0.grid} (dW_0) and '
      f'{k3.dw1.grid} (dW_1..3)')
  log(f'featurize_dense_dw: {k4.smem:,} bytes per CTA, GEMM grid '
      f'{k4.gemm.grid}')


def phase_backward_kernels():
  """K3 and K4 against their plain versions at the training shapes."""
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
  num_feats = 2 * 12 * basis.shape[-1]
  log_backward_plans(num_feats, basis.shape[-1])
  rng = np.random.RandomState(3)
  results = {}

  # K3: the PropMLP backward, 504 -> 4 x 256 -> 1, g [N].
  means, covs = _gaussians(K1_SAMPLES, seed=4)
  ws, bs, wd = _prop_trunk(rng, num_feats)
  g = torch.tensor(rng.randn(K1_SAMPLES).astype(np.float32), device='cuda')

  def k3(fn):
    def run(n):
      dws, dbs, dwd, dbd = fn(means[:n], covs[:n], ws, bs, wd, g[:n], basis)
      return [*dws, *dbs, dwd, dbd]
    return run
  results['density_mlp_bwd'] = _compare_leaves(
      'density_mlp_bwd', k3(dm.density_mlp_backward),
      k3(dm.density_mlp_bwd_plain), K1_SAMPLES)

  # K4: dW of NerfMLP layer 0 (and of the skip layer's feature half),
  # 504 x 1024 from g [N, 1024].
  means, covs = _gaussians(K2_SAMPLES, seed=5)
  g = torch.tensor(rng.randn(K2_SAMPLES, 1024).astype(np.float32),
                   device='cuda')

  def k4(fn):
    return lambda n: [fn(means[:n], covs[:n], g[:n], basis)]
  results['featurize_dense_dw'] = _compare_leaves(
      'featurize_dense_dw', k4(fd.featurize_dense_dw),
      k4(fd.featurize_dense_dw_plain), K2_SAMPLES)
  return results


# The int8 trunk's output within a relative L2 of 2e-2 of its plain version
# (tests/test_pallas_int8_trunk.py:74), and each of its gradient leaves
# too.  The kernels and the plain versions quantize the same f32 values;
# they differ where a summation order moves an f32 value across an int8 or
# bf16 rounding step, and through eight layers such flips compound.  With
# a random-signed cotangent the gradient leaves are cancelling sums, and
# the plain version's own leaves move by up to 0.15 when the means move by
# a relative 1e-6 (phase_int8_kernels measures it, "NVIDIA H100 80GB HBM3,
# 700.00 W").  So K6 is held to I8_TOL with a cotangent g >= 0, whose sums
# do not cancel, where a wrong kernel is off by O(1); with a random-signed
# one by train_lib.leaf_gaps' rule against that move.
I8_TOL = 2e-2
NERF_SKIP = (5,)  # 360.gin's NerfMLP: depth 8, skip_layer 4.


def _nerf_trunk(rng, num_feats, width=1024, depth=8):
  """NerfMLP trunk 504 -> 8 x 1,024 with the skip at layer 5."""
  ws = [_he_uniform(rng, num_feats if l == 0 else
                    width + (num_feats if l in NERF_SKIP else 0), width)
        for l in range(depth)]
  bs = [torch.tensor(rng.randn(width).astype(np.float32) * 0.1, device='cuda')
        for _ in ws]
  return ws, bs


def _rel_l2(got, want):
  return float(torch.linalg.vector_norm((got - want).double()) /
               torch.linalg.vector_norm(want.double()))


def _compare_rel(name, run_kernel, run_plain, n_full, tol):
  """Kernel vs plain at n_full and n_full - RAGGED, per output leaf:
  relative L2 < tol, and two launches bitwise equal.  Returns the
  summary."""
  worst = 0.0
  for n in (n_full, n_full - RAGGED):
    got, again, want = run_kernel(n), run_kernel(n), run_plain(n)
    torch.cuda.synchronize()
    rels = []
    for i, (a, b, w) in enumerate(zip(got, again, want)):
      if a.shape != w.shape or a.dtype != w.dtype:
        raise SystemExit(f'FAIL {name} leaf {i}: {a.dtype} {tuple(a.shape)} '
                         f'vs {w.dtype} {tuple(w.shape)}')
      if not torch.equal(a, b):
        raise SystemExit(f'FAIL {name} leaf {i}: two launches differ (N={n})')
      if not bool(torch.isfinite(a).all()):
        raise SystemExit(f'FAIL {name} leaf {i}: non-finite at N={n}')
      a, w = a.float(), w.float()
      rel = _rel_l2(a, w)
      worst = max(worst, float((a - w).abs().max()))
      share = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
      rels.append(f'{rel:.2e} ({share:.2e})')
      if not rel < tol:
        raise SystemExit(f'FAIL {name} leaf {i} N={n}: relative L2 '
                         f'{rel:.3e} >= {tol}')
    log(f'{name} N={n}: relative L2 per leaf (max|kernel - plain| / '
        f'max|plain|): {", ".join(rels)}; bound {tol}; two launches '
        'bitwise equal')
  return _summary(name, run_kernel, run_plain, n_full, worst)


def log_int8_plans(num_feats, num_dims):
  """K5's and K6's launch plans at the kernel phase's shapes (K5 also at
  the render chunk's), the shared memory of their tile passes and of K6's
  s8 dW GEMM held against the sources (int8_fwd_tile_smem,
  int8_bwd_tile_smem, int8_dw_gemm_smem), and their kernels' registers and
  spills."""
  from multinerf_tpu_torch.ops.kernels import build
  from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
  from multinerf_tpu_torch.ops.kernels import plans
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  fwd_smem = build.load('int8_trunk').int8_fwd_tile_smem
  fwd_smem.argtypes = [ctypes.c_int] * 5
  fwd_smem.restype = ctypes.c_int
  for n in (K2_SAMPLES, K5_CHUNK):
    k5 = plans.i8_fwd_plan(num_feats, 1024, num_dims, n, sms)
    smem = fwd_smem(1024, num_feats, num_dims, k5.bn, k5.stages)
    if smem != k5.smem:
      raise SystemExit(f'FAIL plans: K5 shared memory {smem} in the '
                       f'sources, {k5.smem} in plans.py')
    log(f'int8_trunk N={n}: tile pass {k5.smem:,} bytes of dynamic shared '
        f'memory per CTA, two {k5.stages}-stage rings of {k5.bn}-column '
        f'slabs, {k5.grid} persistent CTAs over {k5.tiles} tiles of '
        f'{plans.I8_TILE} samples, a staging block of '
        f'{4 * k5.stage_floats / 2**20:.1f} MiB')
  for func, r in build.kernel_resources(
      build.BUILD_INFO['int8_trunk']['log']).items():
    log(f'  int8_trunk {func}: {r["registers"]} registers, spills '
        f'{r["spill_stores"]} B stored / {r["spill_loads"]} B loaded')
  n_pad, group = i8t.jax_groups(K2_SAMPLES)
  k6 = plans.int8_bwd_plan(num_feats, 1024, 8, len(NERF_SKIP), K2_SAMPLES,
                           n_pad, group, num_dims, sms, False)
  lib = build.load('int8_trunk_bwd')
  tile_smem, s8_smem = lib.int8_bwd_tile_smem, lib.int8_dw_gemm_smem
  tile_smem.argtypes = [ctypes.c_int] * 5
  s8_smem.argtypes = [ctypes.c_int]
  tile_smem.restype = s8_smem.restype = ctypes.c_int
  smem = (tile_smem(1024, num_feats, num_dims, k6.tile.bn, k6.tile.stages),
          s8_smem(k6.s8.bn))
  if smem != (k6.tile.smem, k6.s8.smem):
    raise SystemExit(f'FAIL plans: K6 shared memory {smem} in the sources, '
                     f'{(k6.tile.smem, k6.s8.smem)} in plans.py')
  log(f'int8_trunk_bwd: tile pass {k6.tile.smem:,} bytes of dynamic shared '
      f'memory per CTA, two {k6.tile.stages}-stage rings of {k6.tile.bn}-'
      f'column slabs, {k6.tile.grid} persistent CTAs over {k6.tile.tiles} '
      f'tiles of {plans.I8_TILE} samples; s8 dW GEMM {k6.s8.smem:,} bytes, '
      f'grid {k6.s8.grid} over {k6.s8.groups} groups of {k6.s8.group}; '
      f'feature dW grid {k6.features.grid}')
  for func, r in build.kernel_resources(
      build.BUILD_INFO['int8_trunk_bwd']['log']).items():
    log(f'  int8_trunk_bwd {func}: {r["registers"]} registers, spills '
        f'{r["spill_stores"]} B stored / {r["spill_loads"]} B loaded')


def _device_ms_by_kernel(fn, calls=3):
  """{kernel name: device ms per call} of the CUDA kernels that fn()
  launches, from torch.profiler over `calls` calls after one warm-up."""
  import collections
  import re
  fn()
  torch.cuda.synchronize()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  by_name = collections.Counter()
  for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA:
      name = re.sub(r'\(.*', '', e.name).replace('void ', '')
      name = name.replace('mnt::', '')
      if name.startswith('at::'):
        name = 'PyTorch ops of the wrapper'
      by_name[name] += (e.time_range.end - e.time_range.start) / 1e3 / calls
  return dict(by_name.most_common())


def _log_device_ms(tag, n, fn):
  pieces = _device_ms_by_kernel(fn)
  log(f'{tag} N={n}: device ms per call by kernel (torch.profiler, 3 '
      'calls): ' + '; '.join(f'{name} {ms:.3f}' for name, ms in pieces.items()))


def phase_int8_kernels():
  """K5 (also at the int8 render path's chunk) and K6 (both modes) against
  their plain versions at the NerfMLP's training shapes."""
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
  num_feats = 2 * 12 * basis.shape[-1]
  log_int8_plans(num_feats, basis.shape[-1])
  rng = np.random.RandomState(6)
  means, covs = _gaussians(K2_SAMPLES, seed=7)
  ws, bs = _nerf_trunk(rng, num_feats)
  kw = dict(use_contract=True, skip_layers=NERF_SKIP)
  results = {}

  def k5(fn, means=means, covs=covs):
    return lambda n: [fn(means[:n], covs[:n], ws, bs, basis, **kw)]
  results['int8_trunk'] = _compare_rel(
      'int8_trunk', k5(i8t.int8_trunk), k5(i8t.int8_trunk_plain), K2_SAMPLES,
      I8_TOL)
  _log_device_ms('int8_trunk', K2_SAMPLES,
                 lambda: k5(i8t.int8_trunk)(K2_SAMPLES))
  chunk = _gaussians(K5_CHUNK, seed=10)
  results['int8_trunk']['render_chunk'] = dict(n=K5_CHUNK, **_compare_rel(
      'int8_trunk', k5(i8t.int8_trunk, *chunk),
      k5(i8t.int8_trunk_plain, *chunk), K5_CHUNK, I8_TOL))
  _log_device_ms('int8_trunk', K5_CHUNK,
                 lambda: k5(i8t.int8_trunk, *chunk)(K5_CHUNK))
  del chunk

  g = torch.tensor(np.abs(rng.randn(K2_SAMPLES, 1024)).astype(np.float32),
                   device='cuda').to(torch.bfloat16)
  for bwd_bf16 in (False, True):
    def k6(fn):
      def run(n):
        dws, dbs = fn(means[:n], covs[:n], ws, bs, g[:n], basis,
                      bwd_bf16=bwd_bf16, **kw)
        return [*dws, *dbs]
      return run
    tag = 'int8_trunk_bwd' + ('_hybrid' if bwd_bf16 else '')
    results[tag] = _compare_rel(tag, k6(i8t.int8_trunk_backward),
                                k6(i8t.int8_trunk_bwd_plain), K2_SAMPLES,
                                I8_TOL)
    _log_device_ms(tag, K2_SAMPLES,
                   lambda: k6(i8t.int8_trunk_backward)(K2_SAMPLES))
  hybrid = results.pop('int8_trunk_bwd_hybrid')
  results['int8_trunk_bwd'].update(
      {f'{k}_hybrid': v for k, v in hybrid.items()})

  # A random-signed cotangent, against the plain version's own move.
  from multinerf_tpu_torch import train_lib
  g_signed = torch.tensor(rng.randn(K2_SAMPLES, 1024).astype(np.float32),
                          device='cuda').to(torch.bfloat16)

  def leaves(fn, m):
    dws, dbs = fn(m, covs, ws, bs, g_signed, basis, **kw)
    return {f'leaf {i}': t.cpu() for i, t in enumerate([*dws, *dbs])}
  gaps = train_lib.leaf_gaps(
      leaves(i8t.int8_trunk_backward, means),
      leaves(i8t.int8_trunk_bwd_plain, means),
      leaves(i8t.int8_trunk_bwd_plain, means * (1 + train_lib.NUDGE)),
      cap=INT8_TRAIN_GAP_CAP)
  log('int8_trunk_bwd, random-signed cotangent: relative L2 to plain '
      '(plain nudged) per leaf: ' + ', '.join(
          f'{gap:.2e} ({sens:.2e})' for gap, sens, _ in gaps.values()))
  over = {k: v for k, v in gaps.items() if not v[0] <= v[2]}
  if over:
    raise SystemExit(f'FAIL int8_trunk_bwd: over train_lib.leaf_gaps '
                     f'bounds: {over}')
  return results


# The card's published dense peaks and memory rate (H100 SXM data sheet, at
# its full 700 W): a function's bound is the larger of the bytes it must
# move over the memory rate and its products over the peak of their type.
PEAK_OPS_PER_S = {'bf16': 989e12, 'int8': 1979e12}
HBM_BYTES_PER_S = 3.35e12


def _bound(nbytes, ops):
  mem = nbytes / HBM_BYTES_PER_S
  compute = sum(n / PEAK_OPS_PER_S[t] for t, n in ops.items())
  return {'bound_ms': 1e3 * max(mem, compute),
          'bound_by': 'bytes' if mem > compute else 'operations',
          'ops': sum(ops.values())}


def _achieved(summary, bound, suffix=''):
  """Achieved tensor-core TFLOP/s (bf16 and int8 products together) and
  the share of the bound: bound_ms / ms."""
  ms = summary[f'ms{suffix}']
  return {f'achieved_tflops{suffix}': bound['ops'] / (ms * 1e-3) / 1e12,
          f'bound_share{suffix}': bound['bound_ms'] / ms}


def kernel_bounds(f=504, h=256, w=1024, n1=K1_SAMPLES, n2=K2_SAMPLES,
                  depth=4):
  """Each kernel's bound at the shapes of the kernel phases (by default
  360.gin's: `f` features, PropMLP `depth` x `h`, NerfMLP width `w`, K1/K3
  over `n1` samples, the others over `n2`): each input read once (means
  and covs, 48 bytes a sample), each output written once, the weights
  once; products of the trunks (2 operations a multiply-add), the
  features' few hundred f32 operations a sample aside."""
  prop = f * h + (depth - 1) * h * h  # PropMLP trunk weights.
  nerf_bf16 = 2 * f * w  # Layer 0 and the skip layer's feature rows.
  nerf_i8 = 7 * w * w  # The seven int8 hidden layers.
  int8_trunk = lambda n: _bound(48 * n + 2 * n * w + 2 * nerf_bf16 + nerf_i8,
                                {'bf16': 2 * n * nerf_bf16,
                                 'int8': 2 * n * nerf_i8})
  return {
      'density_mlp': _bound(52 * n1 + 2 * (prop + h),
                            {'bf16': 2 * n1 * (prop + h)}),
      'featurize_dense': _bound(48 * n2 + 4 * n2 * w + 2 * f * w + 4 * w,
                                {'bf16': 2 * n2 * f * w}),
      # Forward recomputed, the three dX and the four dW products.
      'density_mlp_bwd': _bound(
          52 * n1 + 4 * (prop + (depth + 1) * h + 1),
          {'bf16': 2 * n1 * (2 * prop + (depth - 1) * h * h + h)}),
      'featurize_dense_dw': _bound(48 * n2 + 4 * n2 * w + 4 * f * w,
                                   {'bf16': 2 * n2 * f * w}),
      'int8_trunk': int8_trunk(n2),
      'int8_trunk_render_chunk': int8_trunk(K5_CHUNK),
      # int8 mode: the recomputed forward, then the int8 dW and dx of the
      # hidden layers and the bf16 dW of layer 0 and the skip tail.
      'int8_trunk_bwd': _bound(
          48 * n2 + 2 * n2 * w + 2 * nerf_bf16 + 2 * nerf_i8 +
          4 * (nerf_bf16 + nerf_i8 + 8 * w),
          {'bf16': 4 * n2 * nerf_bf16, 'int8': 6 * n2 * nerf_i8}),
      # Hybrid: dW and dx of the hidden layers in bf16.
      'int8_trunk_bwd_hybrid': _bound(
          48 * n2 + 2 * n2 * w + 4 * nerf_bf16 + 4 * (
              nerf_bf16 + nerf_i8 + 8 * w),
          {'bf16': 4 * n2 * nerf_bf16 + 4 * n2 * nerf_i8,
           'int8': 2 * n2 * nerf_i8}),
  }


def _check_frames(tag, summary, shape):
  """Every rendered buffer finite, rgb in range, files under JAX names."""
  for idx, rendering in summary['renderings'].items():
    for key, val in rendering.items():
      if key.startswith('ray_'):
        continue
      if not np.isfinite(val).all():
        raise SystemExit(f'FAIL {tag}: non-finite {key} in frame {idx}')
    rgb = rendering['rgb']
    if rgb.shape != shape + (3,):
      raise SystemExit(f'FAIL {tag}: rgb shape {rgb.shape}')
    if not (rgb.min() >= -0.001 and rgb.max() <= 1.001):
      raise SystemExit(f'FAIL {tag}: rgb outside [-0.001, 1.001]')
    for name in (f'color_{idx:03d}.png', f'acc_{idx:03d}.tiff',
                 f'distance_mean_{idx:03d}.tiff',
                 f'distance_median_{idx:03d}.tiff'):
      if not os.path.exists(os.path.join(summary['out_dir'], name)):
        raise SystemExit(f'FAIL {tag}: missing {name}')
  num_rays = shape[0] * shape[1]
  for idx, sec in zip(summary['frames'], summary['seconds']):
    log(f'{tag} frame {idx}: {sec:.3f} s, {num_rays / sec:,.0f} rays/s')


# The bf16 trunk, the JAX package's shipping configuration (bench.py:459-464):
# the same kernels as the f32 trunk (K1-K4), the hidden products in bf16.
BF16_BINDINGS = ("NerfMLP.trunk_dtype = 'bfloat16'",
                 "PropMLP.trunk_dtype = 'bfloat16'")
BF16_STEPS = 40

# The bindings of the int8 trunk (scripts/render_bench.py:52-54): the
# PropMLPs keep K1/K3 (full density fusion comes first), the NerfMLP's trunk
# runs K5/K6.
INT8_MODES = ('int8', 'int8_hybrid')


def int8_bindings(mode):
  return [f"NerfMLP.trunk_dtype = '{mode}'", f"PropMLP.trunk_dtype = '{mode}'"]


# The kernels each path must launch, and those it must not.
F32_RENDER = (('density_mlp', 'featurize_dense'), ('int8_trunk',))
INT8_RENDER = (('density_mlp', 'int8_trunk'), ('featurize_dense',))
F32_TRAIN = (('density_mlp', 'featurize_dense', 'density_mlp_bwd',
              'featurize_dense_dw'), ('int8_trunk', 'int8_trunk_bwd'))
INT8_TRAIN = (('density_mlp', 'density_mlp_bwd', 'int8_trunk',
               'int8_trunk_bwd'), ('featurize_dense', 'featurize_dense_dw'))


def _check_launches(tag, launches, plain, kernels):
  """Every kernel of `kernels[0]` launched, none of `kernels[1]`, and no
  plain version ran."""
  must, must_not = kernels
  if (min((launches[k] for k in must), default=1) < 1 or
      max((launches[k] for k in must_not), default=0) != 0 or
      max(plain.values()) != 0):
    raise SystemExit(f'FAIL {tag}: launches {launches}, plain-version calls '
                     f'{plain}; expected {must} launched, {must_not} not.')


def phase_main_path(tag='main path', bindings=(), kernels=F32_RENDER):
  from multinerf_tpu_torch import render
  with tempfile.TemporaryDirectory() as tmp:
    base = [f'--gin_configs={os.path.join(REPO, "configs", "360.gin")}',
            "--gin_bindings=Config.dataset_loader='dummy_unbounded'",
            f"--gin_bindings=Config.checkpoint_dir='{tmp}/ckpt'",
            f"--gin_bindings=Config.render_dir='{tmp}/render'",
            '--gin_bindings=Config.render_job_id=0', '--device=cuda'] + [
                f'--gin_bindings={b}' for b in bindings]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    # Test views 0, 16 and 32 at 64 x 64: one 4,096-ray chunk per frame.
    views = render.main(base + ['--gin_bindings=Config.render_num_jobs=16'])
    # One path frame at 256 x 256: 65,536 rays in 4 chunks of 16,384.
    path = render.main(base + [
        '--gin_bindings=Config.render_num_jobs=48',
        '--gin_bindings=Config.render_path=True',
        '--gin_bindings=Config.render_resolution=(256, 256)'])
    torch.cuda.synchronize()
    launches, plain = _counts()
    if views['frames'] != [0, 16, 32] or path['frames'] != [0]:
      raise SystemExit(f'FAIL {tag}: frames {views["frames"]}, '
                       f'{path["frames"]}')
    _check_frames(f'{tag} 64x64', views, (64, 64))
    _check_frames(f'{tag} 256x256', path, (256, 256))
  log(f'{tag} launches {launches}, plain-version calls {plain}, '
      f'max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} '
      'GiB')
  _check_launches(tag, launches, plain, kernels)
  return launches


# GPU (kernels) vs CPU (plain versions) on a 16 x 16 frame at full width.
# f32 trunk: the two differ where an f32 value crosses a bf16 rounding
# boundary (features, K1's activations), which the CPU parity tests bound
# at 3e-3 for colors and 2e-3 for near / distance at test widths; at full
# width the sums are longer, so 1e-2 and 5e-3.  int8 trunk: twice those, as
# in tests/test_torch_int8_trunk.py: a one-step flip of an int8 value moves
# it by 1/127 of its row's absmax, a bf16 crossing by 2^-8 of itself.
REFERENCE_BOUNDS = {'rgb': 1e-2, 'acc': 1e-2, 'near/distance_mean': 5e-3,
                    'near/distance_median': 5e-3}
INT8_REFERENCE_BOUNDS = {k: 2 * v for k, v in REFERENCE_BOUNDS.items()}


def phase_reference(tag='reference', bindings=(), bounds=REFERENCE_BOUNDS,
                    gins=('360.gin',)):
  """The whole render path of the configs `gins` (in order) on the GPU
  (kernels) against the same model on the CPU (the kernels' plain
  versions), one 16 x 16 path frame at full width.  Same seed, same
  weights: the initializer draws on the CPU."""
  import argparse
  from multinerf_tpu_torch import configs
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.models import nerf
  args = argparse.Namespace(
      gin_configs=[os.path.join(REPO, 'configs', g) for g in gins],
      gin_bindings=["Config.dataset_loader = 'dummy_unbounded'",
                    'Config.render_path = True',
                    'Config.render_resolution = (16, 16)', *bindings])
  config = configs.load_config(args)
  dataset = datasets.load_dataset('test', None, config)
  frames = {}
  for device in ('cuda', 'cpu'):
    render_fn = train_lib.setup_model(config, render.SEED,
                                      torch.device(device))[2]
    frames[device] = nerf.DeviceImageRenderer(
        render_fn, config, dataset, torch.device(device))(1.0, 0)
  _hold_frames(f'{tag} (GPU kernels vs CPU plain versions, 16x16 frame)',
               frames['cuda'], frames['cpu'], config.near, bounds)


def _frame_gaps(got, want, near):
  """max |gap| of rgb and acc, and of the distances as near / t."""
  gaps = {key: float(np.abs(got[key] - want[key]).max())
          for key in ('rgb', 'acc')}
  for key in ('distance_mean', 'distance_median'):
    gaps[f'near/{key}'] = float(np.abs(near / got[key] -
                                       near / want[key]).max())
  return gaps


def _hold_frames(tag, got, want, near, bounds=REFERENCE_BOUNDS):
  """Two renderings of one frame: max |gap| of rgb and acc, and of the
  distances as near / t, each within its bound."""
  gaps = _frame_gaps(got, want, near)
  log(f'{tag}: {gaps}, bounds {bounds}')
  if not all(gaps[k] <= bounds[k] for k in bounds):
    raise SystemExit(f'FAIL {tag}: gaps {gaps} over bounds {bounds}')


TRAIN_STEPS = 100
HYBRID_STEPS = 40  # Enough to time 'int8_hybrid' (median of steps 6-40).
TRAIN_RAYS = 4096  # The per-device batch of bench.py:38.


def _counts():
  """Kernel launches and plain-version calls of K1..K6 since the reset."""
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
  table = {'density_mlp': dm.counts, 'featurize_dense': fd.counts,
           'density_mlp_bwd': dm.bwd_counts,
           'featurize_dense_dw': fd.bwd_counts, 'int8_trunk': i8t.counts,
           'int8_trunk_bwd': i8t.bwd_counts}
  return ({k: c['launches'] for k, c in table.items()},
          {k: c['plain_calls'] for k, c in table.items()})


def _reset_counts():
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
  dm.reset_counts()
  fd.reset_counts()
  i8t.reset_counts()


def phase_train(tag='train', bindings=(), steps=TRAIN_STEPS,
                kernels=F32_TRAIN, gin='360.gin',
                data=("Config.dataset_loader='dummy_unbounded'",),
                ckpt_dir=None, rays=TRAIN_RAYS, thresholds=None):
  """`steps` steps of configs/`gin` (360.gin; or a tuple of files, in
  order) at full width, `rays` rays
  per step (4,096), on the scene of the `data` bindings (dummy_unbounded),
  through ``python -m multinerf_tpu_torch.train``'s entry point,
  checkpoints into `ckpt_dir` (a temporary one); the launch counters, read
  around every step, show that each step ran the path's kernels.  The loss
  threshold each step is given is appended to `thresholds`, when a list.
  Returns (launches, median step seconds, the driver's summary)."""
  from multinerf_tpu_torch import train
  from multinerf_tpu_torch import train_lib
  per_step = []
  create_train_step = train_lib.create_train_step

  def counted_train_step(*args, **kwargs):
    step_fn = create_train_step(*args, **kwargs)

    def step(*step_args):
      if thresholds is not None:
        thresholds.append(step_args[5])
      before = _counts()[0]
      out = step_fn(*step_args)
      after = _counts()[0]
      per_step.append({k: after[k] - before[k] for k in after})
      return out
    return step

  gins = (gin,) if isinstance(gin, str) else gin
  with tempfile.TemporaryDirectory() as tmp:
    argv = [f'--gin_configs={os.path.join(REPO, "configs", g)}'
            for g in gins] + [
                f'--gin_bindings=Config.batch_size={rays}',
                f'--gin_bindings=Config.max_steps={steps}',
                '--gin_bindings=Config.lr_delay_steps=0',
                '--gin_bindings=Config.print_every=10',
                f"--gin_bindings=Config.checkpoint_dir='{ckpt_dir or tmp}'",
                '--device=cuda'] + [f'--gin_bindings={b}' for b in (
                    *data, *bindings)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    train_lib.create_train_step = counted_train_step
    try:
      summary = train.main(argv)
    finally:
      train_lib.create_train_step = create_train_step
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = _counts()
    if not os.path.exists(summary['checkpoint']):
      raise SystemExit(f'FAIL {tag}: no final checkpoint.')
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  losses = np.array(summary['losses'])
  data = np.array(summary['data_losses'])
  if len(losses) != steps or not np.isfinite(losses).all():
    raise SystemExit(f'FAIL {tag}: losses {losses}')
  for key, val in summary['stats'].items():
    if not np.isfinite(np.asarray(val)).all():
      raise SystemExit(f'FAIL {tag}: non-finite stat {key} = {val}')
  first, last = float(data[:10].mean()), float(data[-10:].mean())
  log(f'{tag}: mean data loss, steps 1-10 {first:.5f}, steps '
      f'{steps - 9}-{steps} {last:.5f}; final psnr '
      f'{summary["stats"]["psnr"]:.3f}')
  if not last < first:
    raise SystemExit(f'FAIL {tag}: the data loss did not fall.')
  fewest = {k: min(c[k] for c in per_step) for k in launches}
  most = {k: max(c[k] for c in per_step) for k in launches}
  log(f'{tag} launches {launches}, plain-version calls {plain} '
      f'({len(per_step)} steps; fewest launches in one step {fewest})')
  if len(per_step) != steps:
    raise SystemExit(f'FAIL {tag}: {len(per_step)} steps counted.')
  _check_launches(f'{tag} (every step)', fewest, plain,
                  (kernels[0], ()))
  _check_launches(f'{tag} (any step)', most, plain, ((), kernels[1]))
  step_s = statistics.median(summary['step_seconds'][5:])
  log(f'{tag}: {seconds:.1f} s for {steps} steps; median step '
      f'{step_s * 1e3:.3f} ms over steps 6-{steps} (synchronised per '
      f'step), {rays / step_s:,.0f} train rays/s, max memory '
      f'allocated {peak_gib:.2f} GiB')
  return launches, step_s, summary


# The cap of train_lib.leaf_gaps at full width: there the CPU step's own
# move under the nudge reaches 1.17e-1 at NerfMLP_0/Dense_0/kernel, above
# the 0.1 that caps it at the test widths, and the GPU step was 9.84e-2
# from the CPU step on that leaf ("NVIDIA H100 80GB HBM3, 700.00 W").  The
# int8 step is more sensitive: its CPU step moves by 1.81e-1 there under the
# nudge, and the GPU step was 1.75e-1 from it, so its cap is 0.25.  Its
# loss terms get 5e-3 instead of 1e-3: the interlevel term, the proposal
# levels' mismatch with the final level's weights, which the int8 NerfMLP
# sets, was 1.94e-3 apart (the same card).  The bf16 step keeps the f32
# step's bounds: its CPU step moves by 1.27e-1 at NerfMLP_0/Dense_0/kernel
# under the nudge, the GPU step was 1.12e-1 from it (0.75 of the cap), and
# its loss terms 4.7e-4 apart at most, the interlevel term (the same card).
TRAIN_GAP_CAP = 0.15
INT8_TRAIN_GAP_CAP = 0.25
LOSS_TOL = 1e-3
INT8_LOSS_TOL = 5e-3
# The interlevel term of 360_robustnerf.gin's and 360_glo4.gin's steps is
# more sensitive than 360.gin's on their random weights: the CPU step moved
# it by 2.37e-3 (robustnerf: one 16 x 16 patch of neighbouring rays) and
# 2.13e-3 (glo4) under the nudge, and the GPU step was 1.76e-3 and 1.24e-3
# from the CPU step ("NVIDIA H100 80GB HBM3, 700.00 W"); their loss terms
# get 5e-3, as the int8 step's do.
ZOO_LOSS_TOL = 5e-3


# The share of the cells a culled step's update reaches whose evaluated
# samples may differ between the GPU and the CPU step (phase_train_reference).
GRID_CELLS_DIFFER = 0.05


def phase_train_reference(tag='train reference', bindings=(),
                          cap=TRAIN_GAP_CAP, loss_tol=LOSS_TOL,
                          gin='360.gin', loader='dummy_unbounded',
                          data_dir=None, cull=None, loss_sens=0.0,
                          by_layer=()):
  """One full-width train step of 256 rays with Config.randomized=False
  (no jitter, no noise), from the same initial weights, on the GPU
  (kernels) and on the CPU (plain versions): the loss terms and every
  gradient leaf.  The configs are configs/`gin` (or a tuple of files, in
  order); the rays come from `loader`'s train split (at `data_dir`, for a
  capture).

  Bounds: each loss term within `loss_tol` relative (f32: 1e-3, measured
  1e-4 at most, the interlevel term), plus `loss_sens` times the CPU
  step's own relative move under the nudge; each gradient leaf by
  train_lib.leaf_gaps, the rule that also holds the CPU step against JAX,
  with the CPU step as the reference, run a second time on nudged rays, and
  a cap of `cap`.  The leaves named in `by_layer` take the same rule with
  their gaps (GPU and nudged CPU to CPU) in the L2 norm of their whole
  layer's CPU gradient, kernel and bias, in place of their own.  With
  `cull` (a capacity) the final level runs culled through a half-empty
  occupancy grid (culling.half_space_grid) on both sides, and the grids
  after the step's update are held within TOL * max(1, max |grid|)
  on the cells where both sides evaluated as many samples.  A sample
  within a rounding of the grid's empty half keeps on one side only, and
  then its cell, and the one the spare slots take next, differ; at most
  GRID_CELLS_DIFFER of the cells the update reached may.
  """
  from multinerf_tpu_torch.models import culling
  import argparse
  from multinerf_tpu_torch import configs
  from multinerf_tpu_torch import train
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  gins = (gin,) if isinstance(gin, str) else gin
  args = argparse.Namespace(
      gin_configs=[os.path.join(REPO, 'configs', g) for g in gins],
      gin_bindings=[f"Config.dataset_loader = '{loader}'",
                    'Config.batch_size = 256', 'Config.randomized = False',
                    *bindings])
  config = configs.load_config(args)
  with datasets.load_dataset('train', data_dir, config, seed=0) as dataset:
    host_batch = next(dataset)
  runs, grids = [], []
  for device, nudge in (('cuda', False), ('cpu', False), ('cpu', True)):
    t0 = time.perf_counter()
    model, _, _, _, _ = train_lib.setup_model(config, train.SEED,
                                              torch.device(device))
    if cull is not None:
      model.occupancy.grid.copy_(culling.half_space_grid(
          config.occupancy_grid_resolution, device))
    batch = train_lib.batch_to_device(host_batch, torch.device(device))
    if nudge:
      batch = train_lib.nudge_origins(batch)
    loss, losses, stats, grads = train_lib.loss_and_grads(
        model, config, batch, 0.5, cull=cull)
    losses['loss'] = loss
    if cull is not None:
      grids.append((culling.update_grid(
          model.occupancy.grid, stats['occ_cells'], stats['occ_density'],
          config.occupancy_grid_decay).cpu(), stats['occ_cells'].cpu(),
                    float(stats['occ_keep_frac'])))
    runs.append(({k: v.cpu() for k, v in losses.items()},
                 {k: v.cpu() for k, v in grads.items()}))
    log(f'{tag}: one step on {device} (nudged: {nudge}) in '
        f'{time.perf_counter() - t0:.1f} s')
  (losses, grads), (losses_c, grads_c), (losses_n, grads_n) = runs
  rel = lambda a, b: abs(float(a - b)) / abs(float(b))
  loss_gaps = {k: rel(losses[k], losses_c[k]) for k in losses}
  moved = {k: rel(losses_n[k], losses_c[k]) for k in losses}
  log(f'{tag}, GPU vs CPU loss terms (relative): {loss_gaps}; the CPU '
      f'step nudged: {moved}; bound {loss_tol} + {loss_sens} x nudged')
  over = {k: v for k, v in loss_gaps.items()
          if not v <= loss_tol + loss_sens * moved[k]}
  for k, g in grads.items():
    if not bool(torch.isfinite(g).all()):
      raise SystemExit(f'FAIL {tag}: non-finite gradient {k}')
  gaps = train_lib.leaf_gaps(grads, grads_c, grads_n, cap=cap)
  for k in by_layer:
    layer = k.rsplit('/', 1)[0]
    norm = float(torch.linalg.vector_norm(torch.cat([
        g.reshape(-1).double() for n, g in grads_c.items()
        if n.rsplit('/', 1)[0] == layer])))
    dist = lambda t, k=k: float(torch.linalg.vector_norm(
        (t - grads_c[k]).double())) / norm
    sens = dist(grads_n[k])
    gaps[k] = (dist(grads[k]), sens,
               min(train_lib.GAP_BASE + 2 * sens, cap))
    log(f'  {k}: GPU {grads[k].reshape(-1)[:4].tolist()}, CPU '
        f'{grads_c[k].reshape(-1)[:4].tolist()}, CPU nudged '
        f'{grads_n[k].reshape(-1)[:4].tolist()}; the layer\'s CPU gradient '
        f'has L2 norm {norm:.4e}; its own relative L2 GPU vs CPU '
        f'{_rel_l2(grads[k], grads_c[k]):.3e}, CPU nudged '
        f'{_rel_l2(grads_n[k], grads_c[k]):.3e}; held in the layer\'s norm '
        'below')
  for k, (gap, sens, bound) in gaps.items():
    measure = "in its layer's norm" if k in by_layer else 'relative L2'
    log(f'  {k}: GPU vs CPU {measure} {gap:.3e}, CPU nudged {sens:.3e}, '
        f'bound {bound:.3e}')
    if not gap <= bound:
      over[k] = gap
  worst = max((gap / bound, k) for k, (gap, _, bound) in gaps.items())
  log(f'{tag}: worst gradient gap is {worst[0]:.2f} of its bound '
      f'({worst[1]})')
  if cull is not None:
    (grid, cells, keep_frac), (grid_c, cells_c, keep_frac_c) = grids[:2]
    count, count_c, count_n = (torch.bincount(g[1], minlength=grid.numel())
                               for g in grids)
    same = count == count_c
    touched = int(((count > 0) | (count_c > 0)).sum())
    differ = int((~same).sum())
    gap = float((grid - grid_c).abs()[same].max())
    bound = TOL * max(1.0, float(grid_c.abs().max()))
    log(f'{tag}: culled at {cull} (keep fraction {keep_frac} on the GPU, '
        f'{keep_frac_c} on the CPU); the compact samples fill {touched} '
        f'cells, {differ} of them with other counts on the two sides '
        f'(bound {GRID_CELLS_DIFFER:.0%}; the CPU step nudged: '
        f'{int((count_n != count_c).sum())}); the grid after the update, '
        f'max|GPU - CPU| over the others {gap:.3e} (bound {bound:.3e}), '
        f'over all {float((grid - grid_c).abs().max()):.3e}')
    if not gap <= bound or differ > GRID_CELLS_DIFFER * touched:
      over['occupancy/grid'] = (gap, differ)
  if over:
    raise SystemExit(f'FAIL {tag}: over the bounds: {over}')


# The train driver on the device plane: 30 steps, then a resume to 60, with
# a save, a console line and an in-train render on the way, then eval.
DRIVER_STEPS = 60
DRIVER_EVERY = 30
DRIVER_EVAL_VIEWS = 3


def _opt_state(optimizer):
  """A CPU copy of an optimizer's per-parameter state."""
  return {i: {k: v.detach().cpu().clone() for k, v in s.items()}
          for i, s in optimizer.state_dict()['state'].items()}


def phase_train_driver(card, host_step_s):
  """``python -m multinerf_tpu_torch.train``'s whole driver at full width,
  4,096 rays per step on the device plane (``Config.device_data_plane``):
  30 steps (``early_exit_steps``), then a resume to step 60, saving every
  30 steps and rendering a test view every 30; the event file read back by
  the port's reader; then ``python -m multinerf_tpu_torch.eval`` over 3
  test views of the final checkpoint.  The launch counters, read around
  every step, render and eval, show K1-K4 in every step and K1/K2 in every
  render, with no plain-version call.  Logs the device plane's step time,
  the host sampler's time per batch on its own, and the render's rays/s."""
  import argparse
  from multinerf_tpu_torch import configs
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import train
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.utils import checkpoints as ckpt_lib
  from multinerf_tpu_torch.utils import summary
  tag = 'train driver'
  per_step, renders, restored = [], [], []

  def counted(fn, log):
    def run(*args, **kwargs):
      before = _counts()
      out = fn(*args, **kwargs)
      after = _counts()
      log.append(tuple({k: a[k] - b[k] for k in a}
                       for a, b in zip(after, before)))
      return out
    return run

  create_train_step = train_lib.create_train_step
  test_render = train.in_train_test_render
  restore_latest = ckpt_lib.CheckpointManager.restore_latest

  def restore(mngr, state):
    out = restore_latest(mngr, state)
    if mngr.latest_step() is not None and out.optimizer is not None:
      restored.append((out.step, _opt_state(out.optimizer),
                       {k: v.detach().cpu().clone()
                        for k, v in out.params.items()}))
    return out

  with tempfile.TemporaryDirectory() as tmp:
    ckpt_dir = f'{tmp}/ckpt'
    base = [f'--gin_configs={os.path.join(REPO, "configs", "360.gin")}',
            "--gin_bindings=Config.dataset_loader='dummy_unbounded'",
            f"--gin_bindings=Config.checkpoint_dir='{ckpt_dir}'",
            '--device=cuda']
    argv = base + [f'--gin_bindings={b}' for b in (
        f'Config.batch_size={TRAIN_RAYS}', f'Config.max_steps={DRIVER_STEPS}',
        'Config.lr_delay_steps=0', 'Config.print_every=10',
        f'Config.checkpoint_every={DRIVER_EVERY}',
        f'Config.train_render_every={DRIVER_EVERY}',
        'Config.device_data_plane=True')]
    torch.cuda.synchronize()
    _reset_counts()
    train_lib.create_train_step = lambda *a, **k: counted(
        create_train_step(*a, **k), per_step)
    train.in_train_test_render = counted(test_render, renders)
    ckpt_lib.CheckpointManager.restore_latest = restore
    t0 = time.perf_counter()
    try:
      first = train.main(argv + [
          f'--gin_bindings=Config.early_exit_steps={DRIVER_EVERY}'])
      saved = torch.load(os.path.join(ckpt_dir, f'checkpoint_{DRIVER_EVERY}'
                                      '.pt'), weights_only=True)
      second = train.main(argv)
    finally:
      train_lib.create_train_step = create_train_step
      train.in_train_test_render = test_render
      ckpt_lib.CheckpointManager.restore_latest = restore_latest
    train_s = time.perf_counter() - t0
    steps = ckpt_lib.CheckpointManager(ckpt_dir).steps()
    if (first['init_step'], second['init_step'], steps) != (
        1, DRIVER_EVERY + 1, [1, DRIVER_EVERY, DRIVER_STEPS]):
      raise SystemExit(f'FAIL {tag}: first steps {first["init_step"]}, '
                       f'{second["init_step"]}; checkpoints {steps}')
    # The resumed run's state, as restored, against the file it came from.
    step, opt_state, params = restored[-1]
    want = {i: {k: v for k, v in s.items()}
            for i, s in saved['opt_state']['state'].items()}
    if step != DRIVER_EVERY or opt_state.keys() != want.keys() or not all(
        opt_state[i].keys() == want[i].keys() and
        all(torch.equal(opt_state[i][k], want[i][k]) for k in want[i])
        for i in want) or not all(
            torch.equal(params[k], v) for k, v in saved['params'].items()):
      raise SystemExit(f'FAIL {tag}: the resumed state (step {step}) is not '
                       'the saved one.')
    losses = np.array(first['losses'] + second['losses'])
    if len(losses) != DRIVER_STEPS or not np.isfinite(losses).all():
      raise SystemExit(f'FAIL {tag}: losses {losses}')

    events = summary.read_events(ckpt_dir)
    for at in (DRIVER_EVERY, DRIVER_STEPS):
      tags = {e['tag'] for e in events if e['step'] == at}
      need = {'train_avg_loss', 'train_avg_psnr', 'train_psnr',
              'train_learning_rate', 'train_rays_per_sec', 'test_rays_per_sec',
              'train_metrics/psnr', 'train_metrics/ssim', 'test_true_color',
              'test_output_color', 'test_output_ray_weights'}
      if not need <= tags:
        raise SystemExit(f'FAIL {tag}: step {at} lacks {need - tags}')
    psnrs = [e['value'] for e in events if e['tag'] == 'train_metrics/psnr']
    if len(psnrs) != 2 or not np.isfinite(psnrs).all():
      raise SystemExit(f'FAIL {tag}: train_metrics/psnr {psnrs}')

    before = _counts()
    t0 = time.perf_counter()
    evaluated = eval_lib.main(base + [
        f'--gin_bindings=Config.max_steps={DRIVER_STEPS}',
        f'--gin_bindings=Config.eval_dataset_limit={DRIVER_EVAL_VIEWS}'])
    eval_s = time.perf_counter() - t0
    after = _counts()
    eval_counts = tuple({k: a[k] - b[k] for k in a}
                        for a, b in zip(after, before))
    names = sorted(os.listdir(evaluated['out_dir']))
    scores = {}
    for name in ('psnr', 'ssim', 'cc_psnr', 'cc_ssim'):
      fname = f'metric_{name}_{DRIVER_STEPS}.txt'
      if fname not in names:
        raise SystemExit(f'FAIL {tag}: eval wrote no {fname} ({names})')
      with open(os.path.join(evaluated['out_dir'], fname)) as f:
        scores[name] = [float(v) for v in f.read().split()]
      if (len(scores[name]) != DRIVER_EVAL_VIEWS or
          not np.isfinite(scores[name]).all()):
        raise SystemExit(f'FAIL {tag}: {fname}: {scores[name]}')
    launches, plain = _counts()

  fewest = {k: min(c[0][k] for c in per_step) for k in launches}
  _check_launches(f'{tag} (every step)', fewest, plain,
                  (F32_TRAIN[0], ()))
  for i, (got, calls) in enumerate(renders + [eval_counts]):
    _check_launches(f'{tag} render {i}', got, calls,
                    (F32_RENDER[0], F32_TRAIN[0][2:] + F32_RENDER[1]))
  if len(per_step) != DRIVER_STEPS or len(renders) != 2:
    raise SystemExit(f'FAIL {tag}: {len(per_step)} steps, {len(renders)} '
                     'renders counted.')

  # The host sampler alone: one 4,096-ray batch of the train split.
  config = configs.load_config(argparse.Namespace(
      gin_configs=[os.path.join(REPO, 'configs', '360.gin')],
      gin_bindings=["Config.dataset_loader = 'dummy_unbounded'",
                    f'Config.batch_size = {TRAIN_RAYS}']))
  dataset = datasets.load_dataset('train', None, config, seed=0)
  batch_ms = []
  for i in range(23):
    t0 = time.perf_counter()
    dataset._next_train()  # pylint: disable=protected-access
    if i >= 3:
      batch_ms.append((time.perf_counter() - t0) * 1e3)

  step_s = statistics.median(first['step_seconds'][5:] +
                             second['step_seconds'][5:])
  render_rays = first['test_rays_per_sec'] + second['test_rays_per_sec']
  log(f'{tag}: {train_s:.1f} s for two runs of {DRIVER_EVERY} steps (saves '
      f'at {steps}, first resumed step {second["init_step"]}, Adam state and '
      'parameters as saved); launches '
      f'{launches}, plain-version calls {plain}')
  log(f'{tag} ({card}): device plane, median step {step_s * 1e3:.3f} ms '
      f'over steps 6-30 and 36-60 (synchronised per step), '
      f'{TRAIN_RAYS / step_s:,.0f} train rays/s; host path (phase_train, '
      f'prefetching) {host_step_s * 1e3:.3f} ms, '
      f'{TRAIN_RAYS / host_step_s:,.0f} train rays/s; host sampler alone '
      f'{statistics.median(batch_ms):.3f} ms per {TRAIN_RAYS}-ray batch '
      f'(median of 20, _next_train); in-train render (64x64) '
      f'{", ".join(f"{r:,.0f}" for r in render_rays)} rays/s')
  log(f'{tag}: eval of {DRIVER_EVAL_VIEWS} views in {eval_s:.1f} s, '
      f'psnr {scores["psnr"]}, ssim {scores["ssim"]}, color-corrected psnr '
      f'{scores["cc_psnr"]}')
  return launches


# configs/blender_refnerf.gin at full width on the analytic Ref-NeRF scene.
REFNERF_STEPS = 30
REFNERF_EVAL_VIEWS = 3
REFNERF_FRAME_JOBS = 8  # Test views 0 and 8 of 16.


def phase_refnerf(card):
  """Ref-NeRF (``configs/blender_refnerf.gin``: NerfMLP 8 x 256 for both
  levels, 128 + 128 samples, density and predicted normals, reflections
  through the IDE at deg_view 5, roughness, diffuse/specular, tint, n.v,
  the orientation and predicted-normal losses, normal metrics) at full
  width on ``dummy_specular``, through the entry points a user calls:
  ``multinerf_tpu_torch.train.main`` for 30 steps of 4,096 rays (the loss
  must fall, a checkpoint must be written), ``eval.main`` over 3 test
  views (finite PSNR, SSIM and normal MAEs, the metric files written),
  ``render.main`` over 2 test views with their ``normals`` frames; then one
  256-ray step on the GPU against the CPU (``train_lib.leaf_gaps``, the
  f32 bounds of phase_train_reference).  The path runs no kernel of the
  port, as in the JAX package (density normals turn fusion off,
  mlp.py:281-289): K1-K6 and their plain versions must launch zero times
  in the whole phase.  Logs the median step, peak memory and the frames'
  seconds and rays/s beside the card's name and power limit."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch import train
  tag = 'refnerf'
  _reset_counts()
  with tempfile.TemporaryDirectory() as tmp:
    base = [
        f'--gin_configs={os.path.join(REPO, "configs", "blender_refnerf.gin")}',
        "--gin_bindings=Config.dataset_loader='dummy_specular'",
        f"--gin_bindings=Config.checkpoint_dir='{tmp}/ckpt'",
        f'--gin_bindings=Config.max_steps={REFNERF_STEPS}', '--device=cuda']
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trained = train.main(base + [f'--gin_bindings={b}' for b in (
        f'Config.batch_size={TRAIN_RAYS}', 'Config.lr_delay_steps=0',
        'Config.print_every=10')])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not trained['checkpoint'] or not os.path.exists(trained['checkpoint']):
      raise SystemExit(f'FAIL {tag}: no final checkpoint.')
    losses = np.array(trained['losses'])
    data = np.array(trained['data_losses'])
    if len(losses) != REFNERF_STEPS or not np.isfinite(losses).all():
      raise SystemExit(f'FAIL {tag}: losses {losses}')
    for key, val in trained['stats'].items():
      if not np.isfinite(np.asarray(val)).all():
        raise SystemExit(f'FAIL {tag}: non-finite stat {key} = {val}')
    first, last = float(data[:10].mean()), float(data[-10:].mean())
    log(f'{tag}: mean data loss, steps 1-10 {first:.5f}, steps '
        f'{REFNERF_STEPS - 9}-{REFNERF_STEPS} {last:.5f}; final psnr '
        f'{trained["stats"]["psnr"]:.3f}, normal MAEs (degrees, per level) '
        f'{trained["stats"]["normal_maes"]}, losses '
        f'{ {k: v for k, v in trained["stats"].items() if "losses/" in k} }')
    if not last < first:
      raise SystemExit(f'FAIL {tag}: the data loss did not fall.')

    t0 = time.perf_counter()
    evaluated = eval_lib.main(base + [
        f'--gin_bindings=Config.eval_dataset_limit={REFNERF_EVAL_VIEWS}'])
    eval_s = time.perf_counter() - t0
    names = sorted(os.listdir(evaluated['out_dir']))
    scores = {}
    for name in ('psnr', 'ssim', 'normals_mae', 'normals_pred_mae'):
      fname = f'metric_{name}_{REFNERF_STEPS}.txt'
      if fname not in names:
        raise SystemExit(f'FAIL {tag}: eval wrote no {fname} ({names})')
      with open(os.path.join(evaluated['out_dir'], fname)) as f:
        scores[name] = [float(v) for v in f.read().split()]
      if (len(scores[name]) != REFNERF_EVAL_VIEWS or
          not np.isfinite(scores[name]).all()):
        raise SystemExit(f'FAIL {tag}: {fname}: {scores[name]}')

    frames = render.main(base + [
        f"--gin_bindings=Config.render_dir='{tmp}/render'",
        f'--gin_bindings=Config.render_num_jobs={REFNERF_FRAME_JOBS}'])
    written = sorted(os.listdir(frames['out_dir']))
    if frames['frames'] != [0, REFNERF_FRAME_JOBS] or not {
        'normals_000.png', f'normals_{REFNERF_FRAME_JOBS:03d}.png'} <= set(
            written):
      raise SystemExit(f'FAIL {tag}: frames {frames["frames"]}, files '
                       f'{written}')
    for idx, rendering in frames['renderings'].items():
      for key in ('rgb', 'normals', 'normals_pred', 'roughness', 'acc'):
        if not np.isfinite(rendering[key]).all():
          raise SystemExit(f'FAIL {tag}: frame {idx} {key} not finite')
    frame_rays = 48 * 48  # The scene's resolution.

    phase_train_reference(f'{tag} train reference', gin='blender_refnerf.gin',
                          loader='dummy_specular')
    launches, plain = _counts()
  if max(launches.values()) or max(plain.values()):
    raise SystemExit(f'FAIL {tag}: launches {launches}, plain-version calls '
                     f'{plain}; the Ref-NeRF path runs no kernel.')
  step_s = statistics.median(trained['step_seconds'][5:])
  log(f'{tag} ({card}): {train_s:.1f} s for {REFNERF_STEPS} steps; median '
      f'step {step_s * 1e3:.3f} ms over steps 6-{REFNERF_STEPS} '
      f'(synchronised per step), {TRAIN_RAYS / step_s:,.0f} train rays/s, '
      f'max memory allocated {peak_gib:.2f} GiB; eval of '
      f'{REFNERF_EVAL_VIEWS} views in {eval_s:.1f} s, psnr '
      f'{scores["psnr"]}, ssim {scores["ssim"]}, normals MAE '
      f'{scores["normals_mae"]}, predicted normals MAE '
      f'{scores["normals_pred_mae"]}; 48x48 frames in '
      f'{", ".join(f"{s:.3f}" for s in frames["seconds"])} s, '
      f'{", ".join(f"{frame_rays / s:,.0f}" for s in frames["seconds"])} '
      'rays/s')
  log(f'{tag} launches {launches}, plain-version calls {plain}')
  return launches


# --- The real-capture data plane: configs/360.gin and configs/llff_256.gin
# on captures written here in the layout COLMAP and
# scripts/local_colmap_and_resize.sh leave, read by the port's llff loader.

CAPTURE_STEPS = 30
CAPTURE_FRAMES = 4
CAPTURE_EVAL_VIEWS = 3  # llffhold 8 of 24 (or 20) views: views 0, 8, 16.
CAPTURE_FACTOR = 4  # Both configs read images_4.
FULL_SIZE = (1024, 768)  # The originals, width x height; images_4 256 x 192.
# configs/360.gin's capture: 24 views on a ring around the dummy_unbounded
# scene, one OPENCV camera (fx, fy, cx, cy at the originals, k1, k2, p1, p2).
RING_VIEWS = 24
OPENCV = (4, (820.0, 815.0, 511.5, 383.5, 0.045, -0.012, 0.0008, -0.0006))
# configs/llff_256.gin's: 20 views on a plane facing the scene, PINHOLE.
PLANE_VIEWS = 20
PINHOLE = (1, (900.0, 900.0, 512.0, 384.0))
PLANE_BOUNDS = (3.0, 64.0)  # Nearest sphere and the shell, from the plane.
# llff_256.gin's kernel shapes: 96 features (octahedron, 16 degrees), a
# PropMLP 4 x 256 over 128 samples and a NerfMLP 8 x 256 over 32 samples of
# a 4,096-ray step, no contraction.
LLFF_K1 = 4096 * 128
LLFF_K2 = 4096 * 32
LLFF_DEG = 16
# The rays of one view cast on the card (torch, float32, full-f32 rotations)
# against the loader's host cast (numpy, float64): max |card - host| <=
# CAST_TOL * max(1, max |host|) per field, float32 rounding through the
# undistortion's Newton steps and the NDC division.
CAST_TOL = 1e-5
# The JPEG level of phase_llff_512's capture: 4:4:4 at quality 95.  The
# scene's saturated colors change within a few pixels, so at 4:2:0 (a
# quarter of the chroma samples) its views keep 28.1-28.7 dB, in Pillow's
# files as in the port's (the same bytes), and at 4:4:4 43.5 dB.
JPEG_QUALITY = 95


def _qvec(rot):
  """A rotation matrix as COLMAP's (w, x, y, z) quaternion."""
  tr = np.trace(rot)
  if tr > 0:
    s = 2 * np.sqrt(tr + 1.0)
    return np.array([s / 4, (rot[2, 1] - rot[1, 2]) / s,
                     (rot[0, 2] - rot[2, 0]) / s, (rot[1, 0] - rot[0, 1]) / s])
  i = int(np.argmax(np.diag(rot)))
  j, k = (i + 1) % 3, (i + 2) % 3
  s = 2 * np.sqrt(max(0.0, 1.0 + rot[i, i] - rot[j, j] - rot[k, k]))
  q = np.empty(4)
  q[0] = (rot[k, j] - rot[j, k]) / s
  q[1 + i] = s / 4
  q[1 + j] = (rot[j, i] + rot[i, j]) / s
  q[1 + k] = (rot[k, i] + rot[i, k]) / s
  return q


def write_colmap_model(sparse, poses, names, camera):
  """COLMAP's binary ``cameras.bin``, ``images.bin`` and ``points3D.bin``
  (reconstruction_io.cc): one shared camera (model id, params), one image
  per NeRF-convention camera-to-world pose, no points."""
  model_id, params = camera
  os.makedirs(sparse)
  with open(os.path.join(sparse, 'cameras.bin'), 'wb') as f:
    f.write(struct.pack('<Q', 1))
    f.write(struct.pack('<iiQQ', 1, model_id, *FULL_SIZE))
    f.write(struct.pack(f'<{len(params)}d', *params))
  with open(os.path.join(sparse, 'images.bin'), 'wb') as f:
    f.write(struct.pack('<Q', len(names)))
    for i, (name, pose) in enumerate(zip(names, poses)):
      # NeRF (right, up, back) -> COLMAP (right, down, forward) axes, then
      # world-to-camera.
      c2w = np.concatenate([pose @ np.diag([1.0, -1.0, -1.0, 1.0]),
                            [[0, 0, 0, 1.0]]], axis=0)
      w2c = np.linalg.inv(c2w)
      f.write(struct.pack('<i4d3di', i + 1, *_qvec(w2c[:3, :3]), *w2c[:3, 3],
                          1))
      f.write(name.encode() + b'\x00' + struct.pack('<Q', 0))
  with open(os.path.join(sparse, 'points3D.bin'), 'wb') as f:
    f.write(struct.pack('<Q', 0))


def exif_tiff(exposure, iso):
  """An Exif TIFF block: a little-endian IFD0 whose Exif sub-IFD holds
  ExposureTime (a RATIONAL) and ISOSpeedRatings (a SHORT)."""
  sub_at = 8 + 2 + 12 + 4
  rational_at = sub_at + 2 + 2 * 12 + 4
  return (b'II*\x00' + struct.pack('<IH', 8, 1) +
          struct.pack('<HHII', 0x8769, 4, 1, sub_at) + struct.pack('<I', 0) +
          struct.pack('<H', 2) +
          struct.pack('<HHII', 0x829A, 5, 1, rational_at) +
          struct.pack('<HHIHH', 0x8827, 3, 1, iso, 0) + struct.pack('<I', 0) +
          struct.pack('<II', *exposure))


def exif_jpeg(exposure, iso):
  """A JPEG container with no image, SOI + APP1 Exif + EOI.  At a pyramid
  level the llff loader reads only the originals' names and Exif."""
  app1 = b'Exif\x00\x00' + exif_tiff(exposure, iso)
  return (b'\xff\xd8\xff\xe1' + struct.pack('>H', len(app1) + 2) + app1 +
          b'\xff\xd9')


def write_capture(root, poses, camera, bounds=None, device='cuda',
                  level_jpeg=None):
  """A capture of the dummy_unbounded scene under `root`: ``sparse/0``,
  the originals under ``images/`` (Exif-only JPEGs, exposures 1/(100 + 20
  i) s at ISO 100-400) and the PNG level ``images_4/``, each pixel shaded
  by the scene's analytic color along the ray of the distorted camera at
  that level (cast on `device`, shaded on the host); with `bounds`,
  ``poses_bounds.npy``.  With `level_jpeg`, a dict, the level is written
  as JPEGs of that quality by ``utils/jpeg.encode_jpeg``, each with its
  original's Exif, and the dict gets the arrays encoded, {name: uint8}.
  Returns the seconds it took."""
  from multinerf_tpu_torch.data import cameras as camera_lib
  from multinerf_tpu_torch.data import colmap
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.utils import io as io_lib
  from multinerf_tpu_torch.utils import jpeg
  t0 = time.perf_counter()
  n = len(poses)
  names = [f'IMG_{i:04d}.JPG' for i in range(n)]
  write_colmap_model(os.path.join(root, 'sparse', '0'), poses, names, camera)
  model_id, params = camera
  cam = colmap.Camera(1, model_id, *FULL_SIZE, params)
  pixtocam = np.linalg.inv(camera_lib.intrinsic_matrix(
      cam.fx, cam.fy, cam.cx, cam.cy)) @ np.diag(
          [CAPTURE_FACTOR, CAPTURE_FACTOR, 1.0])
  width, height = (s // CAPTURE_FACTOR for s in FULL_SIZE)
  pix_x, pix_y = (p.to(device) for p in camera_lib.pixel_coordinates(
      width, height, xnp=torch))
  as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
  level = os.path.join(root, f'images_{CAPTURE_FACTOR}')
  os.makedirs(level)
  os.makedirs(os.path.join(root, 'images'))
  for i, (name, pose) in enumerate(zip(names, poses)):
    exposure, iso = (1, 100 + 20 * i), 100 * (1 + i % 4)
    with open(os.path.join(root, 'images', name), 'wb') as f:
      f.write(exif_jpeg(exposure, iso))
    origins, _, viewdirs, _, _ = camera_lib.pixels_to_rays(
        pix_x, pix_y, as_f32(pixtocam), as_f32(pose),
        distortion_params=cam.distortion(), xnp=torch)
    img = datasets.DummyUnbounded.shade(origins.cpu().numpy(),
                                        viewdirs.cpu().numpy())
    if level_jpeg is None:
      io_lib.save_img_u8(img, os.path.join(level, f'IMG_{i:04d}.png'))
    else:
      level_name = f'IMG_{i:04d}.jpg'
      level_jpeg[level_name] = io_lib.to_u8(img)
      with open(os.path.join(level, level_name), 'wb') as f:
        f.write(jpeg.encode_jpeg(level_jpeg[level_name], JPEG_QUALITY,
                                 exif=exif_tiff(exposure, iso),
                                 subsampling='4:4:4'))
  if bounds is not None:
    np.save(os.path.join(root, 'poses_bounds.npy'), np.concatenate(
        [np.zeros((n, 15)), np.tile([bounds], (n, 1))], -1))
  return time.perf_counter() - t0


def ring_poses():
  """Cameras around the scene at two heights, looking at its center."""
  from multinerf_tpu_torch.data import cameras as camera_lib
  poses = []
  for i in range(RING_VIEWS):
    theta = 2 * np.pi * i / RING_VIEWS
    pos = np.array([3.5 * np.cos(theta), 3.5 * np.sin(theta),
                    0.6 if i % 2 == 0 else 1.4])
    poses.append(camera_lib.viewmatrix(pos, np.array([0.0, 0.0, 1.0]), pos))
  return np.stack(poses)


def plane_poses():
  """A 5 x 4 grid of cameras on the plane z = 4.5, looking down -z."""
  from multinerf_tpu_torch.data import cameras as camera_lib
  poses = []
  for i in range(PLANE_VIEWS):
    pos = np.array([-0.6 + 0.3 * (i % 5), -0.45 + 0.3 * (i // 5), 4.5])
    poses.append(camera_lib.viewmatrix(np.array([0.0, 0.0, 1.0]),
                                       np.array([0.0, 1.0, 0.0]), pos))
  return np.stack(poses)


def _hold_capture_cast(tag, config):
  """Test view 0 of the capture cast on the card, as the renderer and the
  device sampler cast it (``cast_ray_batch(xnp=torch)``), against the
  loader's host cast: within CAST_TOL per field."""
  from multinerf_tpu_torch.data import cameras as camera_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.data import types
  with datasets.load_dataset('test', config.data_dir, config) as dataset:
    host = dataset.generate_ray_batch(0).rays
    pixtocams, camtoworlds, distortion, pixtocam_ndc = dataset.cameras
    as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device='cuda')
    cameras = (as_f32(pixtocams), as_f32(camtoworlds), distortion,
               None if pixtocam_ndc is None else as_f32(pixtocam_ndc))
    pix_x, pix_y = camera_lib.pixel_coordinates(dataset.width,
                                                dataset.height, xnp=torch)
    ones = torch.ones(pix_x.shape + (1,), device='cuda')
    pixels = types.Pixels(pix_x.cuda(), pix_y.cuda(), lossmult=ones,
                          near=ones, far=ones,
                          cam_idx=torch.zeros_like(ones, dtype=torch.int64))
    card = camera_lib.cast_ray_batch(cameras, pixels, dataset.camtype,
                                     xnp=torch)
    torch.cuda.synchronize()
  gaps = {}
  for key in ('origins', 'directions', 'viewdirs', 'radii', 'imageplane'):
    want = getattr(host, key)
    got = getattr(card, key).cpu().numpy().astype(np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
      raise SystemExit(f'FAIL {tag}: card rays {key} {got.shape}, host '
                       f'{want.shape}')
    gaps[key] = float(np.abs(got - want).max())
    bound = CAST_TOL * max(1.0, float(np.abs(want).max()))
    if not gaps[key] <= bound:
      raise SystemExit(f'FAIL {tag}: card rays {key} {gaps[key]:.3e} from '
                       f'the host cast (bound {bound:.3e})')
  log(f'{tag}: view 0 cast on the card vs the host cast, max |gap| per '
      f'field {gaps} (bound {CAST_TOL} * max(1, max|host|)); distortion '
      f'{distortion}, NDC {pixtocam_ndc is not None}')


def _capture_config(gin, data_dir):
  import argparse
  from multinerf_tpu_torch import configs
  return configs.load_config(argparse.Namespace(
      gin_configs=[os.path.join(REPO, 'configs', gin)],
      gin_bindings=[f"Config.data_dir = '{data_dir}'"]))


def _counted(fn, *args):
  """fn(*args) between two reads of the counters: (its result, launches,
  plain-version calls)."""
  _reset_counts()
  out = fn(*args)
  torch.cuda.synchronize()
  return (out, *_counts())


def _capture_eval_render(tag, key, argv, shape):
  """``eval.main`` over the test split's views and ``render.main`` over
  CAPTURE_FRAMES frames of the render path: metric files and finite PSNR,
  frames finite, K1/K2 (not K3-K6) launched in each, no plain version.
  Returns ({'<key>_eval': launches, '<key>_render': launches}, frame
  seconds)."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import render
  no_train = F32_TRAIN[0][2:] + F32_RENDER[1]
  evaluated, launches, plain = _counted(eval_lib.main, argv + [
      f'--gin_bindings=Config.eval_dataset_limit={CAPTURE_EVAL_VIEWS}'])
  _check_launches(f'{tag} eval', launches, plain, (F32_RENDER[0], no_train))
  scores = {}
  for name in ('psnr', 'ssim'):
    with open(os.path.join(evaluated['out_dir'],
                           f'metric_{name}_{CAPTURE_STEPS}.txt')) as f:
      scores[name] = [float(v) for v in f.read().split()]
    if (len(scores[name]) != CAPTURE_EVAL_VIEWS or
        not np.isfinite(scores[name]).all()):
      raise SystemExit(f'FAIL {tag} eval: {name} {scores[name]}')
  log(f'{tag} eval of {CAPTURE_EVAL_VIEWS} test views: psnr '
      f'{scores["psnr"]}, ssim {scores["ssim"]}')
  torch.cuda.reset_peak_memory_stats()
  frames, render_launches, plain = _counted(render.main, argv + [
      '--gin_bindings=Config.render_path=True',
      f'--gin_bindings=Config.render_path_frames={CAPTURE_FRAMES}'])
  _check_launches(f'{tag} render', render_launches, plain,
                  (F32_RENDER[0], no_train))
  if (frames['frames'] != list(range(CAPTURE_FRAMES)) or
      not os.path.basename(frames['out_dir']).startswith(
          f'path_renders_step_{CAPTURE_STEPS}')):
    raise SystemExit(f'FAIL {tag} render: frames {frames["frames"]} in '
                     f'{frames["out_dir"]}')
  _check_frames(f'{tag} render {shape[1]}x{shape[0]}', frames, shape)
  log(f'{tag} render: max memory allocated '
      f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
  return ({f'{key}_eval': launches, f'{key}_render': render_launches},
          frames['seconds'])


def phase_capture_360(card):
  """configs/360.gin at full width on a distorted capture: 24 views of the
  dummy_unbounded scene through one OPENCV camera, read by the llff loader
  (COLMAP model, images_4 PNGs, exposures from the originals' Exif, PCA
  alignment, ellipse path).  Holds a view's rays cast on the card against
  the host cast, trains 30 steps of 4,096 rays on the host path and 30 on
  the device plane (the loss must fall, K1-K4 every step), evaluates the
  test split and renders 4 ellipse frames (K1/K2 in each)."""
  tag = 'capture 360'
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, 'capture')
    write_s = write_capture(data, ring_poses(), OPENCV)
    config = _capture_config('360.gin', data)
    if config.dataset_loader != 'llff' or config.factor != CAPTURE_FACTOR:
      raise SystemExit(f'FAIL {tag}: 360.gin reads {config.dataset_loader} '
                       f'at factor {config.factor}')
    _hold_capture_cast(tag, config)
    paths = {}
    ckpt = os.path.join(tmp, 'ckpt')
    paths['capture_360_train'], step_s, _ = phase_train(
        f'{tag} train', (), CAPTURE_STEPS, F32_TRAIN,
        data=(f"Config.data_dir='{data}'",), ckpt_dir=ckpt)
    paths['capture_360_device_plane'], plane_s, _ = phase_train(
        f'{tag} train device plane', ('Config.device_data_plane=True',),
        CAPTURE_STEPS, F32_TRAIN, data=(f"Config.data_dir='{data}'",))
    argv = [f'--gin_configs={os.path.join(REPO, "configs", "360.gin")}',
            f"--gin_bindings=Config.data_dir='{data}'",
            f"--gin_bindings=Config.checkpoint_dir='{ckpt}'",
            f'--gin_bindings=Config.max_steps={CAPTURE_STEPS}',
            '--device=cuda']
    more, frame_s = _capture_eval_render(tag, 'capture_360', argv,
                                         (192, 256))
    paths.update(more)
  log(f'{tag} ({card}): capture written in {write_s:.1f} s; median step '
      f'{step_s * 1e3:.3f} ms host path, {plane_s * 1e3:.3f} ms device '
      f'plane ({TRAIN_RAYS / step_s:,.0f} and {TRAIN_RAYS / plane_s:,.0f} '
      'train rays/s); 256x192 ellipse frames in '
      f'{", ".join(f"{s:.3f}" for s in frame_s)} s')
  return paths


def _ndc_gaussians(n, seed):
  """Sample Gaussians of a forward-facing scene in NDC: means in
  [-1, 1]^3, small covariances (cylinders of a 256-pixel-wide view)."""
  rng = np.random.RandomState(seed)
  means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
  a = rng.randn(n, 3, 3).astype(np.float32) * 0.004
  covs = a @ np.swapaxes(a, -1, -2)
  return (torch.tensor(means, device='cuda'),
          torch.tensor(covs, device='cuda'))


def phase_llff_kernels():
  """K1-K4 against their plain versions at llff_256.gin's shapes (96
  features, PropMLP 4 x 256 over LLFF_K1 samples, NerfMLP 96 -> 256 over
  LLFF_K2, no contraction), with the kernel phases' bounds and two
  launches bitwise equal, at N and N - 37; each kernel's single-call time
  and its plain version's.  Returns {kernel: summary}."""
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  basis = np.array(geopoly.generate_basis('octahedron', 1)).T  # [3, 3]
  num_feats = 2 * LLFF_DEG * basis.shape[-1]
  if num_feats != 96:
    raise SystemExit(f'FAIL llff kernels: {num_feats} features')
  kw = dict(min_deg=0, max_deg=LLFF_DEG, use_contract=False)
  rng = np.random.RandomState(11)
  results = {}
  means, covs = _ndc_gaussians(LLFF_K1, seed=12)
  ws, bs, wd = _prop_trunk(rng, num_feats)
  bd = torch.tensor(np.float32(-0.3), device='cuda')
  args = lambda n: (means[:n], covs[:n], ws, bs, wd, bd, basis)
  results['density_mlp'] = _compare(
      'density_mlp llff_256', lambda n: dm.density_mlp(*args(n), **kw),
      lambda n: dm.density_mlp_plain(*args(n), **kw), LLFF_K1)
  g = torch.tensor(rng.randn(LLFF_K1).astype(np.float32), device='cuda')

  def k3(fn):
    def run(n):
      dws, dbs, dwd, dbd = fn(means[:n], covs[:n], ws, bs, wd, g[:n], basis,
                              **kw)
      return [*dws, *dbs, dwd, dbd]
    return run
  results['density_mlp_bwd'] = _compare_leaves(
      'density_mlp_bwd llff_256', k3(dm.density_mlp_backward),
      k3(dm.density_mlp_bwd_plain), LLFF_K1)

  means, covs = _ndc_gaussians(LLFF_K2, seed=13)
  w = _he_uniform(rng, num_feats, 256)
  b = torch.tensor(rng.randn(256).astype(np.float32) * 0.1, device='cuda')
  args = lambda n: (means[:n], covs[:n], w, b, basis)
  results['featurize_dense'] = _compare(
      'featurize_dense llff_256', lambda n: fd.featurize_dense(*args(n), **kw),
      lambda n: fd.featurize_dense_plain(*args(n), **kw), LLFF_K2)
  g = torch.tensor(rng.randn(LLFF_K2, 256).astype(np.float32), device='cuda')

  def k4(fn):
    return lambda n: [fn(means[:n], covs[:n], g[:n], basis, **kw)]
  results['featurize_dense_dw'] = _compare_leaves(
      'featurize_dense_dw llff_256', k4(fd.featurize_dense_dw),
      k4(fd.featurize_dense_dw_plain), LLFF_K2)
  bounds = kernel_bounds(f=num_feats, h=256, w=256, n1=LLFF_K1, n2=LLFF_K2)
  for name, summary in results.items():
    bound = bounds[name]
    summary.update(bound_ms=bound['bound_ms'], bound_by=bound['bound_by'],
                   **_achieved(summary, bound))
    log(f'{name} llff_256: {summary["ms"]:.3f} ms (plain '
        f'{summary["plain_ms"]:.3f} ms), bound {bound["bound_ms"]:.4f} ms '
        f'({bound["bound_by"]}), {summary["bound_share"]:.3f} of the bound')
  return results


def phase_capture_llff(card):
  """configs/llff_256.gin at full width on a forward-facing capture: 20
  views of the scene from a plane, one PINHOLE camera, poses_bounds.npy
  (NDC, spiral path).  First K1-K4 at its shapes against their plain
  versions (phase_llff_kernels); then a view's NDC rays cast on the card
  against the host cast, 30 train steps of 4,096 rays (the loss must fall,
  K1-K4 every step), eval of the test split and 4 spiral frames (K1/K2 in
  each).  Returns (kernel summaries, {path: launches})."""
  tag = 'capture llff'
  results = phase_llff_kernels()
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, 'capture')
    write_s = write_capture(data, plane_poses(), PINHOLE, PLANE_BOUNDS)
    config = _capture_config('llff_256.gin', data)
    if not config.forward_facing or config.factor != CAPTURE_FACTOR:
      raise SystemExit(f'FAIL {tag}: llff_256.gin is not forward-facing '
                       f'at factor {CAPTURE_FACTOR}')
    _hold_capture_cast(tag, config)
    paths = {}
    ckpt = os.path.join(tmp, 'ckpt')
    paths['capture_llff_train'], step_s, _ = phase_train(
        f'{tag} train', (), CAPTURE_STEPS, F32_TRAIN, gin='llff_256.gin',
        data=(f"Config.data_dir='{data}'",), ckpt_dir=ckpt)
    argv = [f'--gin_configs={os.path.join(REPO, "configs", "llff_256.gin")}',
            f"--gin_bindings=Config.data_dir='{data}'",
            f"--gin_bindings=Config.checkpoint_dir='{ckpt}'",
            f'--gin_bindings=Config.max_steps={CAPTURE_STEPS}',
            '--device=cuda']
    more, frame_s = _capture_eval_render(tag, 'capture_llff', argv,
                                         (192, 256))
    paths.update(more)
  log(f'{tag} ({card}): capture written in {write_s:.1f} s; median step '
      f'{step_s * 1e3:.3f} ms ({TRAIN_RAYS / step_s:,.0f} train rays/s); '
      '256x192 spiral frames in '
      f'{", ".join(f"{s:.3f}" for s in frame_s)} s; kernels at its shapes '
      + ', '.join(f'{k} {r["ms"]:.3f} ms (bound {r["bound_ms"]:.4f})'
                  for k, r in results.items()))
  return results, paths


# --- The rest of the model zoo: RawNeRF (configs/llff_raw.gin,
# llff_raw_test.gin), RobustNeRF (360_robustnerf.gin) and GLO
# (360_glo4.gin), at full width.

ZOO_STEPS = 30
ZOO_EVAL_VIEWS = 3
# RawNeRF's capture: 20 train views and the HDR+ test view (a 21st pose,
# shot as a bracket of 3 and merged), 1,024 x 768 RGGB mosaics, cut from
# the ~12 MP phone captures of RawNeRF's scenes.  llff_raw.gin trains on
# the full-resolution mosaic at its own 16,384 rays a step (one card takes
# the whole batch), and its one NerfMLP (8 x 256, 96 features) runs both
# levels of 128 samples: K2 and K4 at N = 16,384 x 128.
RAW_VIEWS = 20
RAW_RAYS = 16384
RAW_K2 = RAW_RAYS * 128
RAW_FRAMES = 2
RAW_SHUTTERS = ('1/30', '1/60', '1/120')  # Exposure values 1, 1/2, 1/4.
RAW_TEST_SHUTTERS = ('1/240', '1/60', '1/15')  # The test view's bracket.
RAW_BLACK, RAW_WHITE = 64, 1023
# A stuck kernel traps after 2^26 polls; this bounds the K2/K4 probe at
# llff_raw's N (outputs over 2^31 bytes) below the chip call's own limit.
PROBE_TIMEOUT_S = 300
# The launch sets of the RawNeRF path: no density-only MLP (single_mlp).
RAW_TRAIN = (('featurize_dense', 'featurize_dense_dw'),
             ('density_mlp', 'density_mlp_bwd', 'int8_trunk',
              'int8_trunk_bwd'))
RAW_RENDER = (('featurize_dense',), RAW_TRAIN[1] + ('featurize_dense_dw',))


class _Watchdog:
  """Ends the process, failing, if its block runs over `seconds`."""

  def __init__(self, what, seconds):
    import threading
    self._timer = threading.Timer(seconds, self._expire, (what, seconds))

  @staticmethod
  def _expire(what, seconds):
    print(f'FAIL {what}: over its {seconds} s limit.', flush=True)
    os._exit(3)  # pylint: disable=protected-access

  def __enter__(self):
    self._timer.start()
    return self

  def __exit__(self, *exc):
    self._timer.cancel()


def raw_poses():
  """The HDR+ test view at the middle of a 5 x 4 grid of train views on the
  plane z = 4.5, all looking down -z."""
  from multinerf_tpu_torch.data import cameras as camera_lib
  center = camera_lib.viewmatrix(np.array([0.0, 0.0, 1.0]),
                                 np.array([0.0, 1.0, 0.0]),
                                 np.array([0.05, -0.02, 4.5]))
  return np.concatenate([center[None], plane_poses()])


def _write_raw(raw_dir, name, mosaic, shutter):
  """One raw shot in RawNeRF's layout: a DNG stub, its ``.npy`` sidecar
  (the decoder's mosaic) and exiftool's JSON."""
  from multinerf_tpu_torch.data import raw
  os.makedirs(raw_dir, exist_ok=True)
  base = os.path.join(raw_dir, os.path.splitext(name)[0])
  np.save(base + '.npy', mosaic)
  with open(base + '.dng', 'wb') as f:
    f.write(b'DNG decoded into the .npy sidecar')
  # The color matrix maps XYZ back to linear RGB: the camera sees sRGB
  # primaries, white-balanced, so the tonemap shows the scene.
  xyz_to_rgb = np.linalg.inv(raw._RGB2XYZ)  # pylint: disable=protected-access
  with open(base + '.json', 'w') as f:
    json.dump([{'BlackLevel': RAW_BLACK, 'WhiteLevel': RAW_WHITE,
                'AsShotNeutral': '1.0 1.0 1.0',
                'ColorMatrix2': ' '.join(f'{v:.7f}'
                                         for v in xyz_to_rgb.ravel()),
                'NoiseProfile': '0.00002 0.000001',
                'ShutterSpeed': shutter}], f)


def write_raw_capture(root, device='cuda'):
  """RawNeRF's HDR+ test-scene layout under `root`: ``sparse/0`` (the test
  view first, then RAW_VIEWS train views, PINHOLE at 1,024 x 768),
  ``poses_bounds.npy``, ``raw/train`` (one shot per view, shutters cycling
  over RAW_SHUTTERS), ``raw/test`` (the test view's bracket) and
  ``hdrplus_test/merged.dng`` (its merge, with HDR+'s 2 extra bits).  Each
  pixel's linear color is the dummy_unbounded scene's along its ray (cast
  on `device`), on the RGGB mosaic, times the shot's exposure, plus 2
  counts of read noise.  Returns the seconds it took."""
  from multinerf_tpu_torch.data import cameras as camera_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.data import raw
  t0 = time.perf_counter()
  poses = raw_poses()
  names = [f'IMG_{i:04d}.dng' for i in range(len(poses))]
  write_colmap_model(os.path.join(root, 'sparse', '0'), poses, names,
                     PINHOLE)
  np.save(os.path.join(root, 'poses_bounds.npy'), np.concatenate(
      [np.zeros((len(poses), 15)), np.tile([PLANE_BOUNDS], (len(poses), 1))],
      -1))
  _, params = PINHOLE
  pixtocam = np.linalg.inv(camera_lib.intrinsic_matrix(*params))
  width, height = FULL_SIZE
  pix_x, pix_y = camera_lib.pixel_coordinates(width, height)
  bayer = raw.pixels_to_bayer_mask(pix_x, pix_y)
  rng = np.random.RandomState(31)
  as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)

  def linear(pose):
    origins, _, viewdirs, _, _ = camera_lib.pixels_to_rays(
        torch.tensor(pix_x, device=device), torch.tensor(pix_y, device=device),
        as_f32(pixtocam), as_f32(pose), xnp=torch)
    rgb = datasets.DummyUnbounded.shade(origins.cpu().numpy(),
                                        viewdirs.cpu().numpy())
    return (rgb * bayer).sum(-1)  # One channel per pixel.

  def counts(color, shutter):
    """A shot's sensor counts: exposure relative to the brightest train
    bucket (1/30 s), read noise, clipped at the white level."""
    scale = 30 / float(shutter[2:])
    noisy = RAW_BLACK + (RAW_WHITE - RAW_BLACK) * scale * color + (
        2.0 * rng.randn(*color.shape))
    return np.clip(np.round(noisy), 0, RAW_WHITE).astype(np.uint16)

  for i, (name, pose) in enumerate(zip(names[1:], poses[1:])):
    shutter = RAW_SHUTTERS[i % len(RAW_SHUTTERS)]
    _write_raw(os.path.join(root, 'raw', 'train'), name,
               counts(linear(pose), shutter), shutter)
  test = linear(poses[0])
  for i, shutter in enumerate(RAW_TEST_SHUTTERS):
    _write_raw(os.path.join(root, 'raw', 'test'), f'burst_{i}.dng',
               counts(test, shutter), shutter)
  # The loader takes the merge over 4 (HDR+'s extra bits) and scales it by
  # the bracket's shortest:longest shutter ratio: so this merge holds the
  # test view's colors at the train views' brightest exposure.
  ratio = float(RAW_TEST_SHUTTERS[0][2:]) / float(RAW_TEST_SHUTTERS[-1][2:])
  merged = 4 * (RAW_BLACK + (RAW_WHITE - RAW_BLACK) * ratio * test)
  os.makedirs(os.path.join(root, 'hdrplus_test'))
  np.save(os.path.join(root, 'hdrplus_test', 'merged.npy'),
          np.round(merged).astype(np.uint16))
  with open(os.path.join(root, 'hdrplus_test', 'merged.dng'), 'wb') as f:
    f.write(b'DNG decoded into the .npy sidecar')
  return time.perf_counter() - t0


def phase_raw_kernels():
  """K2 and K4 against their plain versions at llff_raw.gin's shape: 96
  features (octahedron, 16 degrees), 96 -> 256 over RAW_K2 = 2,097,152
  samples, no contraction: K2's f32 output and K4's cotangent are 2.15 GB,
  over 2^31 bytes.  Held with the kernel phases' bounds, two launches
  bitwise equal, at N and N - 37, under a watchdog; then each kernel's
  single-call time and its plain version's, and its bound.  Returns
  {kernel: summary}."""
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  basis = np.array(geopoly.generate_basis('octahedron', 1)).T
  num_feats = 2 * LLFF_DEG * basis.shape[-1]
  kw = dict(min_deg=0, max_deg=LLFF_DEG, use_contract=False)
  rng = np.random.RandomState(41)
  results = {}
  with _Watchdog('K2/K4 at llff_raw shapes', PROBE_TIMEOUT_S):
    means, covs = _ndc_gaussians(RAW_K2, seed=42)
    w = _he_uniform(rng, num_feats, 256)
    b = torch.tensor(rng.randn(256).astype(np.float32) * 0.1, device='cuda')
    args = lambda n: (means[:n], covs[:n], w, b, basis)
    results['featurize_dense'] = _compare(
        'featurize_dense llff_raw',
        lambda n: fd.featurize_dense(*args(n), **kw),
        lambda n: fd.featurize_dense_plain(*args(n), **kw), RAW_K2)
    g = torch.tensor(rng.randn(RAW_K2, 256).astype(np.float32),
                     device='cuda')
    k4 = lambda fn: lambda n: [fn(means[:n], covs[:n], g[:n], basis, **kw)]
    results['featurize_dense_dw'] = _compare_leaves(
        'featurize_dense_dw llff_raw', k4(fd.featurize_dense_dw),
        k4(fd.featurize_dense_dw_plain), RAW_K2)
    del means, covs, g
    torch.cuda.empty_cache()
  bounds = kernel_bounds(f=num_feats, h=256, w=256, n1=RAW_K2, n2=RAW_K2)
  for name, summary in results.items():
    bound = bounds[name]
    summary.update(bound_ms=bound['bound_ms'], bound_by=bound['bound_by'],
                   **_achieved(summary, bound))
    log(f'{name} llff_raw (N = {RAW_K2}): {summary["ms"]:.3f} ms (plain '
        f'{summary["plain_ms"]:.3f} ms), bound {bound["bound_ms"]:.4f} ms '
        f'({bound["bound_by"]}), {summary["bound_share"]:.3f} of the bound')
  return results


def _zoo_argv(gin, ckpt_dir, data):
  return [f'--gin_configs={os.path.join(REPO, "configs", gin)}',
          f"--gin_bindings=Config.checkpoint_dir='{ckpt_dir}'",
          f'--gin_bindings=Config.max_steps={ZOO_STEPS}', '--device=cuda'] + [
              f'--gin_bindings={b}' for b in data]


def _eval_scores(tag, evaluated, names, views, step=ZOO_STEPS):
  """The metric files of eval.main's output, each `views` finite values."""
  scores = {}
  for name in names:
    path = os.path.join(evaluated['out_dir'], f'metric_{name}_{step}.txt')
    if not os.path.exists(path):
      raise SystemExit(f'FAIL {tag} eval: no {os.path.basename(path)}')
    with open(path) as f:
      scores[name] = [float(v) for v in f.read().split()]
    if len(scores[name]) != views or not np.isfinite(scores[name]).all():
      raise SystemExit(f'FAIL {tag} eval: {name} {scores[name]}')
  return scores


def phase_rawnerf(card):
  """RawNeRF at full width on a raw capture in the HDR+ test-scene layout
  (write_raw_capture): K2/K4 at its shapes first (phase_raw_kernels), then
  ``configs/llff_raw.gin`` trained 30 steps of 16,384 rays through
  ``multinerf_tpu_torch.train.main`` (the rawnerf loss on the Bayer mask,
  density noise 1.0 from the step's generator, learned exposure scaling;
  the loss must fall, the exposure offsets of the darker buckets must leave
  0, K2/K4 every step and K1/K3 never; the raw tonemap ladder of an
  in-train render logged), ``eval.main`` under ``llff_raw_test.gin`` on the
  merged HDR+ view (affine color correction, 16 border pixels cropped),
  ``render.main`` over 2 spiral frames through the raw tonemap, and one
  256-ray step (noise off) on the GPU against the CPU.  Returns (kernel
  summaries, {path: launches})."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch.utils import summary as summary_lib
  tag = 'rawnerf'
  results = phase_raw_kernels()
  paths = {}
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, 'capture')
    write_s = write_raw_capture(data)
    ckpt = os.path.join(tmp, 'ckpt')
    paths['rawnerf_train'], step_s, trained = phase_train(
        f'{tag} train', (f'Config.train_render_every={ZOO_STEPS}',),
        ZOO_STEPS, RAW_TRAIN, gin='llff_raw.gin',
        data=(f"Config.data_dir='{data}'",), ckpt_dir=ckpt, rays=RAW_RAYS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    events = summary_lib.read_events(ckpt)
    tags = {e['tag'] for e in events}
    need = {'train_exposure_idx', 'test_unique_shutters',
            'test_output_color_raw', 'test_output_color_auto',
            'test_true_auto', 'test_output_color/97', 'test_true_color/97'}
    if not need <= tags:
      raise SystemExit(f'FAIL {tag}: the summaries lack {need - tags}')
    offsets = {(int(e['tag'].split('_')[-2]), int(e['tag'].split('_')[-1])):
               e['value'] for e in events
               if e['tag'].startswith('exposure/scaling_') and
               e['step'] == ZOO_STEPS}
    if len(offsets) != 9 or any(offsets[(0, j)] != 0 for j in range(3)) or (
        not any(offsets[(i, j)] != 0 for i in (1, 2) for j in range(3))):
      raise SystemExit(f'FAIL {tag}: exposure offsets at step {ZOO_STEPS} '
                       f'{offsets}')

    argv = _zoo_argv('llff_raw_test.gin', ckpt, (f"Config.data_dir='{data}'",))
    t0 = time.perf_counter()
    evaluated, launches, plain = _counted(eval_lib.main, argv)
    eval_s = time.perf_counter() - t0
    _check_launches(f'{tag} eval', launches, plain, RAW_RENDER)
    paths['rawnerf_eval'] = launches
    scores = _eval_scores(tag, evaluated, ('psnr', 'ssim', 'cc_psnr',
                                           'cc_ssim'), 1)
    frames, launches, plain = _counted(
        render.main, _zoo_argv('llff_raw.gin', ckpt, (
            f"Config.data_dir='{data}'", 'Config.render_path=True',
            f'Config.render_path_frames={RAW_FRAMES}',
            f"Config.render_dir='{tmp}/render'")))
    _check_launches(f'{tag} render', launches, plain, RAW_RENDER)
    paths['rawnerf_render'] = launches
    if frames['frames'] != list(range(RAW_FRAMES)):
      raise SystemExit(f'FAIL {tag} render: frames {frames["frames"]}')
    _check_frames(f'{tag} render 256x192', frames, (192, 256))
    phase_train_reference(f'{tag} train reference', gin='llff_raw.gin',
                          loader='llff', data_dir=data)
  raw_steps = paths['rawnerf_train']
  log(f'{tag} ({card}): capture written in {write_s:.1f} s; median step '
      f'{step_s * 1e3:.3f} ms at {RAW_RAYS} rays ({RAW_RAYS / step_s:,.0f} '
      f'train rays/s), max memory allocated {peak_gib:.2f} GiB; data loss '
      f'{np.mean(trained["data_losses"][:10]):.5f} (steps 1-10) -> '
      f'{np.mean(trained["data_losses"][-10:]):.5f} (steps 21-30); exposure '
      f'offsets at step {ZOO_STEPS} {offsets}; launches in {ZOO_STEPS} '
      f'steps {raw_steps}; eval of the HDR+ view in {eval_s:.1f} s: psnr '
      f'{scores["psnr"]}, ssim {scores["ssim"]}, affine-corrected psnr '
      f'{scores["cc_psnr"]}, ssim {scores["cc_ssim"]}; 256x192 frames in '
      f'{", ".join(f"{s:.3f}" for s in frames["seconds"])} s')
  return results, paths


def _distractor_shares(config, ckpt_dir, threshold, batches=8,
                       device='cuda'):
  """The trained model's RobustNeRF mask on `batches` device-plane batches
  of the train split: (the inlier share, the share of distractor pixels
  masked out, the share of clean pixels masked out)."""
  from multinerf_tpu_torch import robust
  from multinerf_tpu_torch import train
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.data import device_sampler
  from multinerf_tpu_torch.utils import checkpoints as ckpt_lib
  model, state, _, _, _ = train_lib.setup_model(config, train.SEED,
                                                torch.device(device))
  ckpt_lib.CheckpointManager(ckpt_dir).restore_latest(
      ckpt_lib.TrainState(step=0, params=state.params))
  generator = torch.Generator(device=device).manual_seed(0)
  kept, distractor, clean = [], [], []
  with datasets.load_dataset('train', None, config) as dataset:
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
    marks = torch.tensor(dataset.distractor_masks, device=device)
    for _ in range(batches):
      pix_x, pix_y, cam_idx = plane.draw(generator)
      batch = plane.make_batch(pix_x, pix_y, cam_idx)
      rays, unflatten = train_lib.flatten_patches(batch, config)
      with torch.inference_mode():
        rgb = unflatten(model(rays, 1.0, False)[0][-1]['rgb'])
        mask, _ = robust.robustnerf_mask((rgb - batch.rgb)**2, threshold,
                                         config)
      mask = mask[..., 0] > 0
      on = marks[cam_idx.expand_as(pix_x), pix_y, pix_x]
      kept.append(mask.float().mean())
      distractor.append((~mask[on]).float().sum() / on.sum().clamp(min=1))
      clean.append((~mask[~on]).float().sum() / (~on).sum().clamp(min=1))
  return tuple(float(torch.stack(v).mean()) for v in (kept, distractor,
                                                       clean))


def phase_robustnerf(card):
  """RobustNeRF: ``configs/360_robustnerf.gin`` at full width on
  ``dummy_distractor`` (5 solid squares pasted into each train view), 30
  steps of 4,096 rays (16 patches of 16 x 16) on the host path and 30 on
  the device plane, the loss threshold fed back from each step to the next
  as a device tensor; K1-K4 every step.  Logs the mask's inlier share and,
  from the trained model, the share of distractor and of clean pixels
  masked out (recorded, not bounded), and holds one 256-ray step (one
  patch) on the GPU against the CPU.  Returns {path: launches}."""
  import argparse
  from multinerf_tpu_torch import configs
  tag = 'robustnerf'
  data = ("Config.dataset_loader='dummy_distractor'",)
  paths = {}
  with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, 'ckpt')
    seen = []
    paths['robustnerf_train'], step_s, trained = phase_train(
        f'{tag} train', (), ZOO_STEPS, F32_TRAIN, gin='360_robustnerf.gin',
        data=data, ckpt_dir=ckpt, thresholds=seen)
    if seen[0] != 1.0 or not all(
        torch.is_tensor(t) and t.is_cuda and t.dim() == 0 for t in seen[1:]):
      raise SystemExit(f'FAIL {tag}: thresholds {seen[:3]}')
    seen_plane = []
    paths['robustnerf_device_plane'], plane_s, on_plane = phase_train(
        f'{tag} train device plane', ('Config.device_data_plane=True',),
        ZOO_STEPS, F32_TRAIN, gin='360_robustnerf.gin', data=data,
        thresholds=seen_plane)
    if not all(torch.is_tensor(t) and t.is_cuda for t in seen_plane[1:]):
      raise SystemExit(f'FAIL {tag} device plane: thresholds '
                       f'{seen_plane[:3]}')
    config = configs.load_config(argparse.Namespace(
        gin_configs=[os.path.join(REPO, 'configs', '360_robustnerf.gin')],
        gin_bindings=["Config.dataset_loader = 'dummy_distractor'",
                      f'Config.batch_size = {TRAIN_RAYS}']))
    threshold = trained['stats']['loss_threshold']
    kept, distractor, clean = _distractor_shares(config, ckpt, threshold)
  phase_train_reference(f'{tag} train reference', gin='360_robustnerf.gin',
                        loader='dummy_distractor', loss_tol=ZOO_LOSS_TOL)
  stats = trained['stats']
  log(f'{tag} ({card}): median step {step_s * 1e3:.3f} ms host path, '
      f'{plane_s * 1e3:.3f} ms device plane ({TRAIN_RAYS / step_s:,.0f} and '
      f'{TRAIN_RAYS / plane_s:,.0f} train rays/s); thresholds fed back '
      f'{", ".join(f"{float(t):.4g}" for t in seen[:4])} ... '
      f'{float(seen[-1]):.4g}; last step: mask inlier share '
      f'{stats["mask"]:.4f}, is_inlier_loss {stats["is_inlier_loss"]:.4f}, '
      f'has_inlier_neighbors {stats["has_inlier_neighbors"]:.4f}, '
      f'is_inlier_patch {stats["is_inlier_patch"]:.4f} (device plane '
      f'{on_plane["stats"]["mask"]:.4f}); trained model, 8 batches: inlier '
      f'share {kept:.4f}, distractor pixels masked {distractor:.4f}, clean '
      f'pixels masked {clean:.4f}')
  return paths


def phase_glo(card):
  """GLO: ``configs/360_glo4.gin`` at full width on ``dummy_unbounded``,
  30 steps of 4,096 rays (each ray's camera row of the GLO table; K1-K4
  every step), ``eval.main`` over 3 test views and ``render.main`` over 2
  (zero GLO vectors, K1/K2 in each), and one 256-ray step on the GPU
  against the CPU.  Returns {path: launches}."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import render
  tag = 'glo'
  data = ("Config.dataset_loader='dummy_unbounded'",)
  no_train = F32_TRAIN[0][2:] + F32_RENDER[1]
  paths = {}
  with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, 'ckpt')
    paths['glo_train'], step_s, _ = phase_train(
        f'{tag} train', (), ZOO_STEPS, F32_TRAIN, gin='360_glo4.gin',
        data=data, ckpt_dir=ckpt)
    glo = torch.load(os.path.join(ckpt, f'checkpoint_{ZOO_STEPS}.pt'),
                     weights_only=True)['params']['Embed_0/embedding']
    first = torch.load(os.path.join(ckpt, 'checkpoint_1.pt'),
                       weights_only=True)['params']['Embed_0/embedding']
    moved = float((glo[:48] - first[:48]).norm() / first[:48].norm())
    argv = _zoo_argv('360_glo4.gin', ckpt, data)
    evaluated, launches, plain = _counted(eval_lib.main, argv + [
        f'--gin_bindings=Config.eval_dataset_limit={ZOO_EVAL_VIEWS}'])
    _check_launches(f'{tag} eval', launches, plain,
                    (F32_RENDER[0], no_train))
    paths['glo_eval'] = launches
    scores = _eval_scores(tag, evaluated, ('psnr', 'ssim'), ZOO_EVAL_VIEWS)
    frames, launches, plain = _counted(render.main, argv + [
        f"--gin_bindings=Config.render_dir='{tmp}/render'",
        '--gin_bindings=Config.render_num_jobs=24'])
    _check_launches(f'{tag} render', launches, plain,
                    (F32_RENDER[0], no_train))
    paths['glo_render'] = launches
    if frames['frames'] != [0, 24]:
      raise SystemExit(f'FAIL {tag} render: frames {frames["frames"]}')
    _check_frames(f'{tag} render 64x64', frames, (64, 64))
  phase_train_reference(f'{tag} train reference', gin='360_glo4.gin',
                        loss_tol=ZOO_LOSS_TOL)
  log(f'{tag} ({card}): median step {step_s * 1e3:.3f} ms '
      f'({TRAIN_RAYS / step_s:,.0f} train rays/s); the train views\' GLO '
      f'rows moved {moved:.3e} (relative L2) from step 1; eval (zero GLO) '
      f'psnr {scores["psnr"]}, ssim {scores["ssim"]}; 64x64 frames in '
      f'{", ".join(f"{s:.3f}" for s in frames["seconds"])} s')
  return paths


# --- The 512-wide configs: configs/blender_512.gin and llff_512.gin.  672
# features (16 degrees on the icosahedron basis, no contraction), PropMLP
# 4 x 256 over one proposal level of 128 samples, NerfMLP 8 x 512 over 32,
# 16,384 rays a step (Config.batch_size's default; neither gin sets it).

DEG_512 = 16
RAYS_512 = 16384
K1_512 = RAYS_512 * 128
K2_512 = RAYS_512 * 32
STEPS_512 = 30
# Launches of one step: the proposal level's K1 and K3, the NerfMLP's layer
# 0 and skip layer through K2 and K4.
PER_STEP_512 = {'density_mlp': 1, 'featurize_dense': 2, 'density_mlp_bwd': 1,
                'featurize_dense_dw': 2, 'int8_trunk': 0, 'int8_trunk_bwd': 0}
# The Blender layout's cut: 20 / 3 / 4 views (train / val / test) at the
# scenes' 800 x 800 against their 100 / 100 / 200.
BLENDER_SIZE = 800
BLENDER_VIEWS = {'train': 20, 'val': 3, 'test': 4}
BLENDER_EVAL_VIEWS = 3
BLENDER_ANGLE_X = 0.6911112070083618  # The lego scene's camera_angle_x.
# LPIPS of one view on the card against the host: float32 convolutions
# with TF32 off on both, summed in other orders.
LPIPS_TOL = 1e-4
JPEG_PSNR_MIN = 40.0  # dB: the level's JPEGs at JPEG_QUALITY.
LLFF_FRAME = (1008, 756)  # An LLFF images_4 frame, width x height.
# llff_512.gin trains with the config's learning-rate warmup
# (Config.lr_delay_steps, 512 steps from 1% of lr_init), where phase_train
# takes it out: without it, its first steps at 2e-3 sent the density of
# the forward-facing capture to zero within 10 steps (the data loss rose
# from 0.31 to 0.42, the black of the opaque background, and stayed).
LLFF_512_WARMUP = ('Config.lr_delay_steps = 512',)


def _bounded_gaussians(n, seed):
  """Samples of a bounded scene: means in [-2, 2]^3, covariances from
  ~1e-10 to ~1e-4 (the high degrees attenuated for some, not others)."""
  rng = np.random.RandomState(seed)
  means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
  a = rng.randn(n, 3, 3).astype(np.float32) * (
      10.0**rng.uniform(-5, -2, (n, 1, 1))).astype(np.float32)
  return (torch.tensor(means, device='cuda'),
          torch.tensor(a @ np.swapaxes(a, -1, -2), device='cuda'))


def _hold_k3_parts(basis, kw):
  """K3's two-part layout of layer 0 against its one-part layout, where
  both fit (672 features, width 128): every leaf bitwise equal.  The two
  sum the same products in the same order; the padding adds zeros."""
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import plans
  rng = np.random.RandomState(53)
  ws = [_he_uniform(rng, 2 * DEG_512 * 21, 128)] + [
      _he_uniform(rng, 128, 128) for _ in range(3)]
  bs = [torch.tensor(rng.randn(128).astype(np.float32) * 0.1, device='cuda')
        for _ in ws]
  wd = _he_uniform(rng, 128, 1)
  plan = plans.density_mlp_bwd_plan
  for n in (300, K1_SAMPLES):
    means, covs = _bounded_gaussians(n, seed=54)
    g = torch.tensor(rng.randn(n).astype(np.float32), device='cuda')
    out = []
    for parts in (1, 2):
      plans.density_mlp_bwd_plan = (
          lambda *a, parts=parts: plan(*a, parts=parts))
      try:
        dws, dbs, dwd, dbd = dm.density_mlp_backward(means, covs, ws, bs, wd,
                                                     g, basis, **kw)
      finally:
        plans.density_mlp_bwd_plan = plan
      out.append([*dws, *dbs, dwd, dbd])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*out)):
      raise SystemExit(f'FAIL density_mlp_bwd 512: the two-part layout '
                       f'differs from the one-part layout at N={n}')
  log('density_mlp_bwd 512: layer 0 in two K-parts bitwise equal to one '
      'part (672 features, width 128, N = 300 and 262,144, every leaf)')


def phase_512_kernels():
  """K1-K4 against their plain versions at the 512 configs' shapes: K1 and
  K3 672 -> 4 x 256 over K1_512 samples, K2 and K4 672 -> 512 over K2_512
  (no contraction), with the kernel phases' bounds (K3 with a cotangent
  g >= 0, whose sums do not cancel, then with a random-signed one by
  train_lib.leaf_gaps against the plain version's own move), two launches
  bitwise equal, at N and N - 37; K3's two layouts bitwise; each kernel's
  single-call time, its plain version's and its bound.  Returns {kernel:
  summary}."""
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
  num_feats = 2 * DEG_512 * basis.shape[-1]
  if num_feats != 672:
    raise SystemExit(f'FAIL 512 kernels: {num_feats} features')
  kw = dict(min_deg=0, max_deg=DEG_512, use_contract=False)
  log_forward_plans(num_feats, basis.shape[-1], 512, K1_512, K2_512)
  log_backward_plans(num_feats, basis.shape[-1], 512, K1_512, K2_512)
  rng = np.random.RandomState(51)
  results = {}
  with _Watchdog('K1-K4 at the 512 shapes', PROBE_TIMEOUT_S):
    _hold_k3_parts(basis, kw)
    means, covs = _bounded_gaussians(K1_512, seed=52)
    ws, bs, wd = _prop_trunk(rng, num_feats)
    bd = torch.tensor(np.float32(-0.3), device='cuda')
    args = lambda n: (means[:n], covs[:n], ws, bs, wd, bd, basis)
    results['density_mlp'] = _compare(
        'density_mlp 512', lambda n: dm.density_mlp(*args(n), **kw),
        lambda n: dm.density_mlp_plain(*args(n), **kw), K1_512)
    g = torch.tensor(np.abs(rng.randn(K1_512)).astype(np.float32),
                     device='cuda')

    def k3(fn, g):
      def run(n, m=None):
        dws, dbs, dwd, dbd = fn(means[:n] if m is None else m, covs[:n], ws,
                                bs, wd, g[:n], basis, **kw)
        return [*dws, *dbs, dwd, dbd]
      return run
    results['density_mlp_bwd'] = _compare_leaves(
        'density_mlp_bwd 512 (g >= 0)', k3(dm.density_mlp_backward, g),
        k3(dm.density_mlp_bwd_plain, g), K1_512)
    g = torch.tensor(rng.randn(K1_512).astype(np.float32), device='cuda')
    leaves = lambda fn, m: {f'leaf {i}': t.cpu() for i, t in enumerate(
        k3(fn, g)(K1_512, m))}
    gaps = train_lib.leaf_gaps(
        leaves(dm.density_mlp_backward, means),
        leaves(dm.density_mlp_bwd_plain, means),
        leaves(dm.density_mlp_bwd_plain, means * (1 + train_lib.NUDGE)),
        cap=TRAIN_GAP_CAP)
    log('density_mlp_bwd 512, random-signed cotangent: relative L2 to '
        'plain (plain nudged) per leaf: ' + ', '.join(
            f'{gap:.2e} ({sens:.2e})' for gap, sens, _ in gaps.values()))
    over = {k: v for k, v in gaps.items() if not v[0] <= v[2]}
    if over:
      raise SystemExit(f'FAIL density_mlp_bwd 512: over train_lib.leaf_gaps '
                       f'bounds: {over}')
    del means, covs, g

    means, covs = _bounded_gaussians(K2_512, seed=55)
    w = _he_uniform(rng, num_feats, 512)
    b = torch.tensor(rng.randn(512).astype(np.float32) * 0.1, device='cuda')
    args = lambda n: (means[:n], covs[:n], w, b, basis)
    results['featurize_dense'] = _compare(
        'featurize_dense 512', lambda n: fd.featurize_dense(*args(n), **kw),
        lambda n: fd.featurize_dense_plain(*args(n), **kw), K2_512)
    g = torch.tensor(rng.randn(K2_512, 512).astype(np.float32), device='cuda')
    k4 = lambda fn: lambda n: [fn(means[:n], covs[:n], g[:n], basis, **kw)]
    results['featurize_dense_dw'] = _compare_leaves(
        'featurize_dense_dw 512', k4(fd.featurize_dense_dw),
        k4(fd.featurize_dense_dw_plain), K2_512)
    del means, covs, g
    torch.cuda.empty_cache()
  bounds = kernel_bounds(f=num_feats, h=256, w=512, n1=K1_512, n2=K2_512)
  for name, summary in results.items():
    bound = bounds[name]
    summary.update(bound_ms=bound['bound_ms'], bound_by=bound['bound_by'],
                   **_achieved(summary, bound))
    log(f'{name} 512: {summary["ms"]:.3f} ms (plain '
        f'{summary["plain_ms"]:.3f} ms), bound {bound["bound_ms"]:.4f} ms '
        f'({bound["bound_by"]}), {summary["bound_share"]:.3f} of the bound')
  return results


def _check_launches_512(tag, launches, steps):
  """Exactly PER_STEP_512 launches a step over `steps` steps."""
  want = {k: v * steps for k, v in PER_STEP_512.items()}
  if launches != want:
    raise SystemExit(f'FAIL {tag}: launches {launches}, expected {want}')


def write_blender_scene(root, device='cuda'):
  """A scene in the Blender layout under `root`: transforms_{train,val,
  test}.json (cameras on a sphere of radius 4 looking at the origin) and
  800 x 800 RGBA PNGs of a textured unit sphere on a transparent
  background; the val and test views also as linear _R/_G/_B/_A.tiff
  channels and a _disp.tiff (1 / (1 + t), t the hit's distance along the
  ray's direction; 1 / (1 + far) at misses).  Returns the seconds it
  took."""
  from multinerf_tpu_torch.data import cameras as camera_lib
  from multinerf_tpu_torch.ops import image_ops
  from multinerf_tpu_torch.utils import io as io_lib
  t0 = time.perf_counter()
  size = BLENDER_SIZE
  focal = 0.5 * size / np.tan(0.5 * BLENDER_ANGLE_X)
  pixtocam = torch.tensor(camera_lib.get_pixtocam(focal, size, size),
                          dtype=torch.float32, device=device)
  pix_x, pix_y = (p.to(device) for p in camera_lib.pixel_coordinates(
      size, size, xnp=torch))
  for k, (split, views) in enumerate(BLENDER_VIEWS.items()):
    os.makedirs(os.path.join(root, split))
    frames = []
    for i in range(views):
      theta = 2 * np.pi * i / views + 0.37 * k
      pos = 4.0 * np.array([np.cos(theta) * np.cos(0.5),
                            np.sin(theta) * np.cos(0.5), np.sin(0.5)])
      pose = np.eye(4)
      pose[:3] = camera_lib.viewmatrix(pos, np.array([0.0, 0.0, 1.0]), pos)
      origins, directions, _, _, _ = camera_lib.pixels_to_rays(
          pix_x, pix_y, pixtocam,
          torch.tensor(pose[:3], dtype=torch.float32, device=device),
          xnp=torch)
      a = (directions * directions).sum(-1)
      b = 2 * (origins * directions).sum(-1)
      c = (origins * origins).sum(-1) - 1.0
      disc = b * b - 4 * a * c
      t = (-b - torch.sqrt(torch.clamp(disc, min=0))) / (2 * a)
      hit = (disc > 0) & (t > 0)
      p = origins + torch.where(hit, t, 0)[..., None] * directions
      color = torch.where(hit[..., None], 0.5 + 0.5 * torch.sin(4 * p), 1.0)
      alpha = hit.float()
      color, alpha = color.cpu().numpy(), alpha.cpu().numpy()
      name = f'{split}/r_{i}'
      prefix = os.path.join(root, name)
      io_lib.write_png(prefix + '.png', io_lib.to_u8(
          np.concatenate([color, alpha[..., None]], -1)))
      if split != 'train':
        linear = image_ops.srgb_to_linear(color)
        for c_idx, ch in enumerate('RGB'):
          io_lib.save_img_f32(linear[..., c_idx], f'{prefix}_{ch}.tiff')
        io_lib.save_img_f32(alpha, prefix + '_A.tiff')
        disp = torch.where(hit, 1 / (1 + t), 1 / (1 + 6.0))
        io_lib.save_img_f32(disp.cpu().numpy(), prefix + '_disp.tiff')
      frames.append({'file_path': f'./{name}',
                     'transform_matrix': pose.tolist()})
    with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
      json.dump({'camera_angle_x': BLENDER_ANGLE_X, 'frames': frames}, f)
  return time.perf_counter() - t0


def _check_videos(tag, rendered, frames):
  """The render's videos: one AVI per channel, its RIFF parsed, `frames`
  JPEG frames each; the color video's first frame, decoded by
  utils/jpeg.py, is the quality-90 JPEG of color_000.png (bitwise), and
  its PSNR to the PNG is logged."""
  from multinerf_tpu_torch.utils import io as io_lib
  from multinerf_tpu_torch.utils import jpeg
  from multinerf_tpu_torch.utils import video as video_lib
  videos = rendered['videos']
  names = [os.path.basename(v) for v in videos]
  if not videos or any(not v.endswith('.avi') for v in videos):
    raise SystemExit(f'FAIL {tag}: videos {videos}')
  for path in videos:
    stored = {k: len(v) for k, v in video_lib.read_avi_frames(path).items()}
    if stored != {b'00dc': frames}:
      raise SystemExit(f'FAIL {tag}: {path} holds the chunks {stored}')
  color = [v for v in videos if v.endswith('_color.avi')]
  if len(color) != 1:
    raise SystemExit(f'FAIL {tag}: no color video in {videos}')
  first = video_lib.read_avi_frames(color[0])[b'00dc'][0]
  png = io_lib.read_image(os.path.join(rendered['out_dir'], 'color_000.png'))
  got = jpeg.decode_jpeg(first)
  if not np.array_equal(got, jpeg.decode_jpeg(jpeg.encode_jpeg(png, 90))):
    raise SystemExit(f'FAIL {tag}: the first color frame is not the '
                     'quality-90 JPEG of its PNG.')
  mse = np.mean((got.astype(np.float64) - png)**2)
  psnr = 10 * np.log10(255.0**2 / max(mse, 1e-12))
  log(f'{tag} videos: {len(videos)} AVIs ({", ".join(names)}), {frames} '
      f'frames each; the first color frame decodes to the quality-90 JPEG '
      f'of its PNG, {psnr:.2f} dB from it')


def _lpips_view(tag, card, weights, img0, img1):
  """LPIPS of one view on the card (timed, after one warm-up call) and on
  the host, within LPIPS_TOL relative.  Returns the card's seconds."""
  from multinerf_tpu_torch.ops import lpips
  on_card = lpips.LPIPS(weights, 'cuda')
  on_card(img0, img1)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  got = on_card(img0, img1)
  seconds = time.perf_counter() - t0
  t0 = time.perf_counter()
  want = lpips.LPIPS(weights, 'cpu')(img0, img1)
  host_s = time.perf_counter() - t0
  rel = abs(got - want) / abs(want)
  log(f'{tag} LPIPS of one {img0.shape[1]}x{img0.shape[0]} view: card '
      f'{got:.6f} in {seconds:.3f} s, host {want:.6f} in {host_s:.1f} s, '
      f'relative gap {rel:.2e} (bound {LPIPS_TOL}) ({card})')
  if not (np.isfinite(got) and rel <= LPIPS_TOL):
    raise SystemExit(f'FAIL {tag}: LPIPS card {got} vs host {want}')
  return seconds


def phase_blender_512(card):
  """configs/blender_512.gin at full width on write_blender_scene's scene:
  30 train steps of 16,384 rays through ``multinerf_tpu_torch.train.main``
  (the loss must fall; 1 K1 + 2 K2 + 1 K3 + 2 K4 a step, no plain call),
  one 256-ray step on the GPU against the CPU, ``eval.main`` over 3 test
  views with ``Config.use_tiffs``, ``compute_disp_metrics`` and LPIPS on
  random weights (PSNR, SSIM, LPIPS and the disparity MSEs written and
  read back; one view's LPIPS on the card against the host), and
  ``render.main`` over the 4 test views with their videos read back.
  Returns {path: launches}."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch.ops import lpips
  from multinerf_tpu_torch.utils import io as io_lib
  tag = 'blender_512'
  paths = {}
  no_train = F32_TRAIN[0][2:] + F32_RENDER[1]
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, 'scene')
    write_s = write_blender_scene(data)
    ckpt = os.path.join(tmp, 'ckpt')
    torch.cuda.reset_peak_memory_stats()
    paths[f'{tag}_train'], step_s, trained = phase_train(
        f'{tag} train', (), STEPS_512, F32_TRAIN, gin='blender_512.gin',
        data=(f"Config.data_dir='{data}'",), ckpt_dir=ckpt, rays=RAYS_512)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_launches_512(f'{tag} train', paths[f'{tag}_train'], STEPS_512)
    phase_train_reference(f'{tag} train reference', gin='blender_512.gin',
                          loader='blender', data_dir=data)
    weights = os.path.join(tmp, 'lpips.npz')
    np.savez(weights, **lpips.random_params(np.random.RandomState(0)))
    argv = _zoo_argv('blender_512.gin', ckpt, (f"Config.data_dir='{data}'",))
    t0 = time.perf_counter()
    evaluated, launches, plain = _counted(eval_lib.main, argv + [
        '--gin_bindings=Config.use_tiffs=True',
        '--gin_bindings=Config.compute_disp_metrics=True',
        f"--gin_bindings=Config.lpips_weights_path='{weights}'",
        f'--gin_bindings=Config.eval_dataset_limit={BLENDER_EVAL_VIEWS}'])
    eval_s = time.perf_counter() - t0
    _check_launches(f'{tag} eval', launches, plain, (F32_RENDER[0], no_train))
    paths[f'{tag}_eval'] = launches
    scores = _eval_scores(tag, evaluated, (
        'psnr', 'ssim', 'lpips', 'disparity_mean_mse',
        'disparity_median_mse'), BLENDER_EVAL_VIEWS)
    rendered_0 = io_lib.read_image(os.path.join(
        evaluated['out_dir'], f'color_000.png')) / 255.0
    rgba = io_lib.read_image(os.path.join(data, 'test', 'r_0.png')) / 255.0
    truth = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
    lpips_s = _lpips_view(tag, card, weights, rendered_0.astype(np.float32),
                          truth.astype(np.float32))
    rendered, launches, plain = _counted(render.main, argv + [
        f"--gin_bindings=Config.render_dir='{tmp}/render'"])
    _check_launches(f'{tag} render', launches, plain,
                    (F32_RENDER[0], no_train))
    paths[f'{tag}_render'] = launches
    views = BLENDER_VIEWS['test']
    if rendered['frames'] != list(range(views)):
      raise SystemExit(f'FAIL {tag} render: frames {rendered["frames"]}')
    _check_frames(f'{tag} render', rendered, (BLENDER_SIZE, BLENDER_SIZE))
    _check_videos(f'{tag} render', rendered, views)
  data_losses = trained['data_losses']
  log(f'{tag} ({card}): scene written in {write_s:.1f} s; median step '
      f'{step_s * 1e3:.3f} ms at {RAYS_512} rays ({RAYS_512 / step_s:,.0f} '
      f'train rays/s), max memory allocated {peak_gib:.2f} GiB; data loss '
      f'{np.mean(data_losses[:10]):.5f} (steps 1-10) -> '
      f'{np.mean(data_losses[-10:]):.5f} (steps 21-30); launches in '
      f'{STEPS_512} steps {paths[f"{tag}_train"]}; eval of '
      f'{BLENDER_EVAL_VIEWS} 800x800 views in {eval_s:.1f} s: psnr '
      f'{scores["psnr"]}, ssim {scores["ssim"]}, lpips (random weights) '
      f'{scores["lpips"]}, disparity mse (mean, median) '
      f'{scores["disparity_mean_mse"]}, {scores["disparity_median_mse"]}; '
      f'LPIPS {lpips_s:.3f} s a view on the card; 800x800 frames in '
      f'{", ".join(f"{s:.3f}" for s in rendered["seconds"])} s')
  return paths


def _time_llff_frame_decode():
  """Seconds (median of 3) to decode one LLFF_FRAME 4:2:0 JPEG at
  JPEG_QUALITY: a smooth image with mild noise, encoded by encode_jpeg."""
  from multinerf_tpu_torch.utils import jpeg
  w, h = LLFF_FRAME
  y, x = np.mgrid[0:h, 0:w] / 37.0
  rng = np.random.RandomState(56)
  img = np.stack([np.sin(x + 0.3 * y), np.cos(0.7 * x - y),
                  np.sin(0.5 * x * y / 20)], -1) * 100 + 128
  img = np.clip(img + rng.randn(h, w, 3) * 3, 0, 255).astype(np.uint8)
  data = jpeg.encode_jpeg(img, JPEG_QUALITY)
  times = []
  for _ in range(3):
    t0 = time.perf_counter()
    jpeg.decode_jpeg(data)
    times.append(time.perf_counter() - t0)
  return statistics.median(times), len(data)


def phase_llff_512(card):
  """configs/llff_512.gin at full width on the forward-facing PINHOLE
  capture of phase_capture_llff, its images_4 level written as JPEGs by
  encode_jpeg (4:4:4, quality 95, each with its original's Exif): the
  decoder held against the arrays encoded (PSNR >= 40 dB, two decodes
  identical), the capture's load timed, 30 train steps of 16,384 rays (1
  K1 + 2 K2 + 1 K3 + 2 K4 a step; the config's warmup kept), one 256-ray
  step on the GPU against the CPU, eval of the test split and 4 spiral
  frames with their videos.  Returns {path: launches}."""
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.utils import jpeg
  tag = 'llff_512'
  decode_s, frame_bytes = _time_llff_frame_decode()
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, 'capture')
    level = {}
    write_s = write_capture(data, plane_poses(), PINHOLE, PLANE_BOUNDS,
                            level_jpeg=level)
    psnrs, seconds = [], []
    for name, want in level.items():
      with open(os.path.join(data, f'images_{CAPTURE_FACTOR}', name),
                'rb') as f:
        encoded = f.read()
      t0 = time.perf_counter()
      got = jpeg.decode_jpeg(encoded)
      seconds.append(time.perf_counter() - t0)
      if got.tobytes() != jpeg.decode_jpeg(encoded).tobytes():
        raise SystemExit(f'FAIL {tag}: two decodes of {name} differ.')
      mse = np.mean((got.astype(np.float64) - want)**2)
      psnrs.append(10 * np.log10(255.0**2 / max(mse, 1e-12)))
    if min(psnrs) < JPEG_PSNR_MIN:
      raise SystemExit(f'FAIL {tag}: JPEG level PSNR {min(psnrs):.2f} dB < '
                       f'{JPEG_PSNR_MIN}')
    config = _capture_config('llff_512.gin', data)
    t0 = time.perf_counter()
    with datasets.load_dataset('train', data, config) as dataset:
      load_s = time.perf_counter() - t0
      shape = dataset.images.shape
    paths = {}
    ckpt = os.path.join(tmp, 'ckpt')
    torch.cuda.reset_peak_memory_stats()
    paths[f'{tag}_train'], step_s, trained = phase_train(
        f'{tag} train', LLFF_512_WARMUP, STEPS_512, F32_TRAIN,
        gin='llff_512.gin', data=(f"Config.data_dir='{data}'",),
        ckpt_dir=ckpt, rays=RAYS_512)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_launches_512(f'{tag} train', paths[f'{tag}_train'], STEPS_512)
    phase_train_reference(f'{tag} train reference', gin='llff_512.gin',
                          loader='llff', data_dir=data)
    argv = [f'--gin_configs={os.path.join(REPO, "configs", "llff_512.gin")}',
            f"--gin_bindings=Config.data_dir='{data}'",
            f"--gin_bindings=Config.checkpoint_dir='{ckpt}'",
            f'--gin_bindings=Config.max_steps={STEPS_512}',
            f"--gin_bindings=Config.render_dir='{tmp}/render'",
            '--device=cuda']
    more, frame_s = _capture_eval_render(tag, tag, argv, (192, 256))
    paths.update(more)
    render_dir = os.path.join(tmp, 'render')
    videos = sorted(os.path.join(render_dir, f) for f in os.listdir(render_dir)
                    if f.endswith('.avi'))
    out_dir = [os.path.join(render_dir, d) for d in os.listdir(render_dir)
               if d.startswith('path_renders')]
    _check_videos(f'{tag} render', {'videos': videos, 'out_dir': out_dir[0]},
                  CAPTURE_FRAMES)
  data_losses = trained['data_losses']
  log(f'{tag} ({card}): capture written in {write_s:.1f} s, its '
      f'{len(level)} images_4 JPEGs (4:4:4, quality {JPEG_QUALITY}) within '
      f'{min(psnrs):.2f}-{max(psnrs):.2f} dB of the arrays encoded, decoded '
      f'in {statistics.median(seconds) * 1e3:.1f} ms each (median), the '
      f'train split ({shape[0]} views of {shape[2]}x{shape[1]}) loaded in '
      f'{load_s:.2f} s; one {LLFF_FRAME[0]}x{LLFF_FRAME[1]} 4:2:0 JPEG '
      f'({frame_bytes:,} bytes) decoded in {decode_s:.3f} s on the host; '
      f'median step {step_s * 1e3:.3f} ms at {RAYS_512} rays '
      f'({RAYS_512 / step_s:,.0f} train rays/s), max memory allocated '
      f'{peak_gib:.2f} GiB; data loss {np.mean(data_losses[:10]):.5f} '
      f'(steps 1-10) -> {np.mean(data_losses[-10:]):.5f} (steps 21-30); '
      f'256x192 spiral frames in {", ".join(f"{s:.3f}" for s in frame_s)} s')
  return paths


# --- Occupancy culling and the multi-step window: configs/360.gin at full
# width with the bf16 trunk, as the JAX bench's culled arm runs it
# (bench.py:459-502), on the sparse dummy_scatter scene.

CULL_LADDER = (0.33, 0.5, 0.67)
CULL_STEPS = 40
CULL_FORCED_STEPS = 10
CULL_EVAL_VIEWS = 3
CULL_DATA = ("Config.dataset_loader='dummy_scatter'",)
CULL_BINDINGS = BF16_BINDINGS + (
    'Config.occupancy_culling = True',
    f'Config.occupancy_capacity_ladder = {CULL_LADDER}',
    'Config.occupancy_warmup_steps = 8',
    'Config.occupancy_grid_refresh_every = 8')
# Engages the lowest rung at the first refresh and holds it: no density
# the weights reach in these few steps comes near the threshold, so the
# keep fraction is 0 on an unculled step and 1/32 on a culled one (the
# terminal sample, which opaque_background keeps).
CULL_ENGAGED = ('Config.occupancy_threshold = 1000.0',)
CULL_FORCED = CULL_ENGAGED + ('Config.occupancy_warmup_steps = 2',
                              'Config.occupancy_grid_refresh_every = 4')
WEIGHT_DECAY = ("Config.weight_decay_mults = "
                "{'NerfMLP_0': 1e-5, 'PropMLP_0': 1e-4}",)
SCAN_WINDOW = 8
SCAN_STEPS = 40
SCAN_BINDINGS = ('Config.device_data_plane = True',
                 f'Config.steps_per_jit_call = {SCAN_WINDOW}',
                 f'Config.print_every = {SCAN_WINDOW}')


def _launch_sizes():
  """{kernel: [N of each launch]} of K2, K4, K5 and K6 while inside."""
  from multinerf_tpu_torch import ddp_probe
  return ddp_probe.launch_sizes()


def _by_n(sizes):
  """{kernel: {N: launches}} of _launch_sizes' record."""
  return {k: dict(sorted(collections.Counter(v).items()))
          for k, v in sizes.items() if v}


def _check_engaged(tag, summary, sizes, steps=CULL_STEPS, warmup=8):
  """Fails unless the run (CULL_BINDINGS + CULL_ENGAGED, `sizes` its
  _launch_sizes record) ran unculled through step `warmup` and at the
  lowest rung after it, K2 and K4 launched at that rung's capacity as
  often a culled step as at the full N an unculled step, and K2 probed the
  R^3 cells at every refresh.  Returns the median ms of the unculled steps
  3 to `warmup` and of the culled steps after the first."""
  from multinerf_tpu_torch.models import culling
  rungs = summary['rungs']
  want = {s: CULL_LADDER[0] for s in range(warmup + 1, steps + 1)}
  if rungs != want:
    raise SystemExit(f'FAIL {tag}: culled steps {rungs}, expected {want}')
  cap = culling.round_capacity(K2_SAMPLES, CULL_LADDER[0])
  by_n = _by_n(sizes)
  for name in ('featurize_dense', 'featurize_dense_dw'):
    counts = by_n.get(name, {})
    per_step = counts.get(K2_SAMPLES, 0) // warmup
    if not per_step or counts.get(cap, 0) != per_step * len(rungs):
      raise SystemExit(f'FAIL {tag}: {name} launches by N {counts} over '
                       f'{warmup} unculled and {len(rungs)} culled steps')
  probes = by_n['featurize_dense'].get(64**3, 0)
  refreshes = len(summary['keep_fracs'])
  if refreshes != steps // 8 or not probes or probes % refreshes:
    raise SystemExit(f'FAIL {tag}: {probes} K2 launches at R^3 over '
                     f'{refreshes} refreshes')
  seconds = summary['step_seconds']
  # The first two steps and the first culled one are first calls.
  return (statistics.median(seconds[2:warmup]) * 1e3,
          statistics.median(seconds[warmup + 1:]) * 1e3)


def _cull_config(bindings=()):
  import argparse
  from multinerf_tpu_torch import configs
  return configs.load_config(argparse.Namespace(
      gin_configs=[os.path.join(REPO, 'configs', '360.gin')],
      gin_bindings=["Config.dataset_loader = 'dummy_scatter'",
                    f'Config.batch_size = {TRAIN_RAYS}',
                    'Config.lr_delay_steps = 0', *CULL_BINDINGS,
                    *bindings]))


def _culled_steps(model, config, device):
  """{capacity or None: train step} over the ladder."""
  from multinerf_tpu_torch import train_lib
  steps = {None: train_lib.create_train_step(model, config, device)}
  for cap in CULL_LADDER:
    steps[cap] = train_lib.create_train_step(model, config, device, cull=cap)
  return steps


def _culled_k2_k4(n, tag='culled'):
  """K2 and K4 against their plain versions at a compact N = `n` (and
  N - RAGGED) of 360.gin's NerfMLP, with their bounds: {kernel:
  summary}."""
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T
  num_feats = 2 * 12 * basis.shape[-1]
  rng = np.random.RandomState(7)
  means, covs = _gaussians(n, seed=8)
  w = _he_uniform(rng, num_feats, 1024)
  b = torch.tensor(rng.randn(1024).astype(np.float32) * 0.1, device='cuda')
  g = torch.tensor(rng.randn(n, 1024).astype(np.float32), device='cuda')
  args = lambda k: (means[:k], covs[:k], w, b, basis)
  results = {'featurize_dense': _compare(
      f'featurize_dense ({tag})',
      lambda k: fd.featurize_dense(*args(k), use_contract=True),
      lambda k: fd.featurize_dense_plain(*args(k), use_contract=True), n)}
  k4 = lambda fn: lambda k: [fn(means[:k], covs[:k], g[:k], basis)]
  results['featurize_dense_dw'] = _compare_leaves(
      f'featurize_dense_dw ({tag})', k4(fd.featurize_dense_dw),
      k4(fd.featurize_dense_dw_plain), n)
  bounds = kernel_bounds(n2=n)
  for name, summary in results.items():
    summary.update(n=n, **_achieved(summary, bounds[name]),
                   bound_ms=bounds[name]['bound_ms'],
                   bound_by=bounds[name]['bound_by'])
    log(f'{name} ({tag}) N={n}: bound {summary["bound_ms"]:.4f} ms (set by '
        f'{summary["bound_by"]}), {summary["ms"]:.3f} ms')
  return results


def phase_cull_kernels():
  """K2 and K4 against their plain versions at the compact N of the 0.33
  rung: 43,008 of a 4,096-ray step's 131,072 final-level samples."""
  from multinerf_tpu_torch.models import culling
  n = culling.round_capacity(K2_SAMPLES, CULL_LADDER[0])
  results = _culled_k2_k4(n)
  # The compaction's overflow on the card: a keep share of 1/2 over the
  # rung of 0.33, one mask on both sides, the maps bitwise.
  keep = torch.tensor(np.random.RandomState(9).rand(TRAIN_RAYS, 32) < 0.5)
  slot, inv = culling.compact_slots(keep.cuda(), n)
  want_slot, want_inv = culling.compact_slots(keep, n)
  same = (torch.equal(slot.cpu(), want_slot) and
          torch.equal(inv.cpu(), want_inv))
  log(f'compaction at N={K2_SAMPLES}, cap {n}, keep share '
      f'{float(keep.float().mean()):.4f}: slot and inverse maps on the card '
      f'{"bitwise equal to" if same else "differ from"} the CPU\'s')
  if not same:
    raise SystemExit('FAIL compaction: the card\'s maps differ from the CPU\'s')
  return results


def _forced_ladder(tag, ckpt_dir):
  """From the state saved in `ckpt_dir`: CULL_FORCED_STEPS steps at each
  rung and unculled, each run restored to that state first and given the
  same batches; ({capacity: median ms} (synchronised per step, the batch
  drawn on the device beforehand), {capacity: mean loss})."""
  from multinerf_tpu_torch import train
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.data import device_sampler
  from multinerf_tpu_torch.utils import checkpoints as ckpt_lib
  device = torch.device('cuda')
  config = _cull_config()
  manager = ckpt_lib.CheckpointManager(ckpt_dir)
  with datasets.load_dataset('train', None, config, seed=0) as dataset:
    model, state, _, _, _ = train_lib.setup_model(config, train.SEED, device)
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
  ms, losses = {}, {}
  for cap, step_fn in _culled_steps(model, config, device).items():
    state = manager.restore_latest(state)
    generator = torch.Generator(device).manual_seed(0)
    times, cap_losses = [], []
    for i in range(CULL_FORCED_STEPS + 2):
      batch = plane.sample_batch(generator)
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      state, stats = step_fn(generator, state, batch, 1.0, False)
      torch.cuda.synchronize()
      if i >= 2:
        times.append((time.perf_counter() - t0) * 1e3)
      cap_losses.append(float(stats['loss']))
    if not np.isfinite(cap_losses).all():
      raise SystemExit(f'FAIL {tag}: non-finite loss at rung {cap}')
    ms[cap] = statistics.median(times)
    losses[cap] = float(np.mean(cap_losses))
  return ms, losses


def _forced_int8(tag):
  """CULL_FORCED_STEPS int8_hybrid steps forced at the 0.33 rung from a
  fresh state on the device plane: (launches, sizes, losses)."""
  from multinerf_tpu_torch import train
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.data import device_sampler
  device = torch.device('cuda')
  config = _cull_config(int8_bindings('int8_hybrid'))
  with datasets.load_dataset('train', None, config, seed=0) as dataset:
    model, state, _, _, _ = train_lib.setup_model(config, train.SEED, device)
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
  step_fn = train_lib.create_train_step(model, config, device,
                                        cull=CULL_LADDER[0])
  generator = torch.Generator(device).manual_seed(0)
  losses = []
  _reset_counts()
  with _launch_sizes() as sizes:
    for i in range(CULL_FORCED_STEPS):
      state, stats = step_fn(generator, state, plane.sample_batch(generator),
                             i / CULL_FORCED_STEPS, False)
      losses.append(float(stats['loss']))
  launches, plain = _counts()
  if not np.isfinite(losses).all():
    raise SystemExit(f'FAIL {tag}: losses {losses}')
  _check_launches(tag, launches, plain, INT8_TRAIN)
  return launches, _by_n(sizes), losses


def phase_culling(card):
  """Occupancy culling on the host path: configs/360.gin at full width
  (bf16 trunk, CULL_BINDINGS) trained CULL_STEPS steps of 4,096 rays on
  dummy_scatter through ``python -m multinerf_tpu_torch.train``'s entry
  point, unculled for 8 steps, the grid refreshed every 8 and the ladder's
  rung gated on the keep fraction, as the scene gives it; the same run
  under CULL_ENGAGED, which must cull steps 9-40 at the lowest rung
  (_check_engaged); eval of 3 views (unculled, as JAX's
  eval renders); from the saved state CULL_FORCED_STEPS steps forced at
  each rung beside as many unculled (bench.py:484-502); K2 and K4 held at
  the 0.33 rung's N; a 256-ray culled step and a weight-decay step on the
  GPU against the CPU; CULL_FORCED_STEPS int8_hybrid steps forced at 0.33
  (K5/K6 at N = capacity).  Returns ({path: launches}, {kernel: summary})."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch.models import culling
  tag = 'culling'
  refresh_ms = []
  refresh_grid = culling.refresh_grid

  def timed_refresh(*args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refresh_grid(*args, **kwargs)
    torch.cuda.synchronize()
    refresh_ms.append((time.perf_counter() - t0) * 1e3)

  paths = {}
  with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, 'ckpt')
    culling.refresh_grid = timed_refresh
    try:
      with _launch_sizes() as sizes:
        paths['culling_train'], _, summary = phase_train(
            f'{tag} train', CULL_BINDINGS, CULL_STEPS, F32_TRAIN,
            data=CULL_DATA, ckpt_dir=ckpt)
    finally:
      culling.refresh_grid = refresh_grid
    train_sizes = _by_n(sizes)
    with _launch_sizes() as sizes:
      paths['culling_train_engaged'], _, engaged = phase_train(
          f'{tag} train (engaged)', CULL_BINDINGS + CULL_ENGAGED, CULL_STEPS,
          F32_TRAIN, data=CULL_DATA)
    engaged_ms = _check_engaged(f'{tag} train (engaged)', engaged, sizes)
    engaged_sizes = _by_n(sizes)
    argv = [f'--gin_configs={os.path.join(REPO, "configs", "360.gin")}',
            f"--gin_bindings=Config.checkpoint_dir='{ckpt}'",
            f'--gin_bindings=Config.max_steps={CULL_STEPS}',
            f'--gin_bindings=Config.eval_dataset_limit={CULL_EVAL_VIEWS}',
            '--device=cuda'] + [f'--gin_bindings={b}'
                                for b in CULL_DATA + CULL_BINDINGS]
    evaluated, launches, plain = _counted(eval_lib.main, argv)
    _check_launches(f'{tag} eval', launches, plain,
                    (F32_RENDER[0], F32_TRAIN[0][2:] + F32_RENDER[1]))
    paths['culling_eval'] = launches
    scores = _eval_scores(tag, evaluated, ('psnr', 'ssim'), CULL_EVAL_VIEWS,
                          step=CULL_STEPS)
    with _launch_sizes() as sizes:
      forced_ms, forced_losses = _forced_ladder(tag, ckpt)
    forced_sizes = _by_n(sizes)
  kernels = phase_cull_kernels()
  # The top rung: its spare slots take every kept sample (keep ~0.55).
  phase_train_reference(f'{tag} train reference', CULL_BINDINGS,
                        loader='dummy_scatter', cull=CULL_LADDER[-1])
  phase_train_reference('train reference weight decay', WEIGHT_DECAY)
  paths['culling_int8_hybrid'], int8_sizes, int8_losses = _forced_int8(
      f'{tag} int8_hybrid')
  cap = culling.round_capacity(K2_SAMPLES, CULL_LADDER[0])
  if set(int8_sizes['int8_trunk']) != {cap} or set(
      int8_sizes['int8_trunk_bwd']) != {cap}:
    raise SystemExit(f'FAIL {tag} int8_hybrid: K5/K6 sizes {int8_sizes}')

  rungs = summary['rungs']
  seconds = summary['step_seconds']
  unculled = [seconds[s - 1] for s in range(6, CULL_STEPS + 1)
              if s not in rungs]
  culled = [seconds[s - 1] for s in rungs]
  median = lambda xs: (f'{statistics.median(xs) * 1e3:.3f} ms ({len(xs)} '
                       'steps)' if xs else 'no step')
  log(f'{tag} ({card}): keep fraction at each refresh '
      f'{summary["keep_fracs"]}; rungs engaged {sorted(set(rungs.values()))} '
      f'over {len(rungs)} of {CULL_STEPS} steps (from step '
      f'{min(rungs) if rungs else None}); median step unculled '
      f'{median(unculled)}, culled {median(culled)} (synchronised per '
      f'step, steps 6-{CULL_STEPS}); refresh probe at R = 64 (262,144 '
      f'cells) {", ".join(f"{t:.3f}" for t in refresh_ms)} ms')
  log(f'{tag}: K2/K4 launches by N in the run (host path, refreshes '
      f'included) {train_sizes}; eval psnr {scores["psnr"]}, ssim '
      f'{scores["ssim"]}')
  log(f'{tag} ({card}): the engaged run (occupancy_threshold 1000): keep '
      f'fraction at each refresh {engaged["keep_fracs"]}; rung '
      f'{CULL_LADDER[0]} over steps 9-{CULL_STEPS}; median step unculled '
      f'{engaged_ms[0]:.3f} ms (steps 3-8), culled {engaged_ms[1]:.3f} ms '
      f'(steps 10-{CULL_STEPS}); K2/K4 launches by N {engaged_sizes}')
  log(f'{tag} ({card}): from the saved state, median of '
      f'{CULL_FORCED_STEPS} steps: unculled {forced_ms[None]:.3f} ms, '
      + ', '.join(f'rung {c} {forced_ms[c]:.3f} ms' for c in CULL_LADDER)
      + '; mean loss over the same batches ' + ', '.join(
          f'{c or "unculled"} {loss:.6f}' for c, loss in forced_losses.items())
      + f'; K2/K4 launches by N {forced_sizes}')
  log(f'{tag} int8_hybrid: {CULL_FORCED_STEPS} steps forced at rung '
      f'{CULL_LADDER[0]}, K5/K6 launches by N {int8_sizes}, loss '
      f'{int8_losses[0]:.5f} -> {int8_losses[-1]:.5f}')
  return paths, kernels


def _hold_window(tag, card):
  """One window of SCAN_WINDOW steps against as many single steps of the
  device plane, from the same state and generator on the card, under
  CULL_FORCED (the gate engages inside the window); the single steps run
  a second time on nudged rays for train_lib.leaf_gaps."""
  from multinerf_tpu_torch import train
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.data import device_sampler
  device = torch.device('cuda')
  config = _cull_config(CULL_FORCED + SCAN_BINDINGS)
  with datasets.load_dataset('train', None, config, seed=0) as dataset:
    plane = device_sampler.DeviceDataPlane(dataset, config, device)

  def run(windowed, nudge=False):
    model, state, _, _, _ = train_lib.setup_model(config, train.SEED, device)
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    steps = _culled_steps(model, config, device)
    gate = train_lib.CullingGate(model, config)
    sample = plane.sample_batch
    if nudge:
      plane.sample_batch = lambda g: train_lib.nudge_origins(sample(g))
    generator = torch.Generator(device).manual_seed(3)
    try:
      if windowed:
        window = device_sampler.create_scan_train_step(
            steps, plane, config, SCAN_WINDOW, gate)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, _ = window(generator, state, 1)
      else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(1, SCAN_WINDOW + 1):
          single = device_sampler.create_device_train_step(
              steps[gate.cull(step)], plane)
          state, stats = single(generator, state,
                                (step - 1) / (config.max_steps - 1),
                                step % config.print_every == 0 or step == 1)
          gate.after_step(step, stats)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
    finally:
      plane.sample_batch = sample
    moved = {k: (v.detach() - params0[k]).cpu() for k, v in
             state.params.items()}
    return moved, gate, seconds

  window, gate_w, window_s = run(True)
  single, gate_s, single_s = run(False)
  nudged, _, _ = run(False, nudge=True)
  bitwise = all(torch.equal(window[k], single[k]) for k in window)
  grid = window.pop('occupancy/grid')
  grid_s = single.pop('occupancy/grid')
  nudged.pop('occupancy/grid')
  gaps = train_lib.leaf_gaps(window, single, nudged, cap=TRAIN_GAP_CAP)
  over = {k: g for k, (g, _, bound) in gaps.items() if not g <= bound}
  worst = max((g / bound, k) for k, (g, _, bound) in gaps.items())
  log(f'{tag} ({card}): one window of {SCAN_WINDOW} steps vs '
      f'{SCAN_WINDOW} single steps from the same state and generator: '
      f'{"bitwise equal" if bitwise else "not bitwise equal"}; worst '
      f'update gap {worst[0]:.2f} of its leaf_gaps bound ({worst[1]}); '
      f'grid max|window - single| {float((grid - grid_s).abs().max()):.3e}; '
      f'rungs {gate_w.rungs} / {gate_s.rungs}, keep fractions '
      f'{gate_w.keep_fracs} / {gate_s.keep_fracs}; {window_s:.3f} s / '
      f'{single_s:.3f} s (first calls)')
  if over or gate_w.rungs != gate_s.rungs or not gate_w.rungs:
    raise SystemExit(f'FAIL {tag}: over the bounds {over}; rungs '
                     f'{gate_w.rungs} vs {gate_s.rungs}')


def phase_scan(card):
  """The device plane with steps_per_jit_call = 8: CULL_BINDINGS and
  CULL_ENGAGED trained SCAN_STEPS steps (5 windows) through the train
  entry point, which must cull windows 2-5 (_check_engaged), then the
  same without culling, then single device-plane steps without culling,
  for the window's ms per step beside the single step's (one call); one
  window held against single steps (_hold_window).  Returns {path:
  launches}."""
  tag = 'scan'
  paths = {}
  with _launch_sizes() as sizes:
    paths['scan_culled'], _, summary = phase_train(
        f'{tag} train (culled)', CULL_BINDINGS + CULL_ENGAGED + SCAN_BINDINGS,
        SCAN_STEPS, F32_TRAIN, data=CULL_DATA)
  culled_ms = _check_engaged(f'{tag} train (culled)', summary, sizes,
                             SCAN_STEPS)
  paths['scan'], window_s, _ = phase_train(
      f'{tag} train', BF16_BINDINGS + SCAN_BINDINGS, SCAN_STEPS, F32_TRAIN,
      data=CULL_DATA)
  paths['scan_single'], single_s, _ = phase_train(
      f'{tag} single steps', BF16_BINDINGS + (
          'Config.device_data_plane = True',), SCAN_STEPS, F32_TRAIN,
      data=CULL_DATA)
  log(f'{tag} ({card}): device plane at 4,096 rays, bf16 trunk: window of '
      f'{SCAN_WINDOW} / {SCAN_WINDOW} = {window_s * 1e3:.3f} ms a step, '
      f'single steps {single_s * 1e3:.3f} ms (medians, steps 6-'
      f'{SCAN_STEPS}); with culling engaged (occupancy_threshold 1000) '
      f'{culled_ms[0]:.3f} ms a step unculled (window 1), '
      f'{culled_ms[1]:.3f} ms culled (windows 2-5, rung {CULL_LADDER[0]}), '
      f'keep fractions {summary["keep_fracs"]}; K2/K4 launches by N '
      f'{_by_n(sizes)}')
  _hold_window(tag, card)
  return paths


# --- Pano rendering, render_many, the int8 Ref-NeRF trunk with density
# normals, and configs/blender_256.gin and debug.gin.

PANO_SIZE = (128, 64)  # render_resolution, width x height.
PANO_FRAMES = 4
PANO_REFERENCE_SIZE = (16, 8)
PANO_BINDINGS = ('Config.render_path = True', "Config.render_camtype = 'pano'")
# The renderers' casts: the host's float64 rays rounded to float32 are
# within 1.6e-7 of the card's float32 cast on this capture (the gap
# phase_capture_360 logs; CAST_TOL holds it at 1e-5).  Through the model
# such a gap moves the argument of a feature at 2^15 times the position
# by ~5e-3, and the kernels round every feature to bf16 (2^-8 of its
# value), so the two renderers differ where a bf16 rounding flips, as the
# GPU and the CPU do: the frame takes REFERENCE_BOUNDS.
RENDER_MANY_K = 8
RENDER_MANY_REPEATS = 3
REFNERF_INT8_STEPS = 20
REFNERF_INT8_RAYS = 2048
# The int8 Ref-NeRF step's GPU-vs-CPU bounds are the int8 step's
# (INT8_TRAIN_GAP_CAP, INT8_LOSS_TOL), with two changes.  The roughness
# head's bias, a scalar, gets a gradient that is the sum of many cancelling
# per-sample terms, each through int8 products: under the nudge the CPU
# step's value of it moves by 0.44 (int8) and 0.28 (int8_hybrid) of
# itself, and by 3.5 and 4.0 under a nudge of the other sign, its sign
# flipping, where the f32 Ref-NeRF step's moves by 6.3e-3; the GPU step's
# is 1.03 and 1.24 from the CPU's (PERF.md §6, "NVIDIA H100 80GB HBM3,
# 700.00 W").  No bound relative to its own value holds such a leaf, so it
# is held in the norm of its layer's whole gradient (REFNERF_BY_LAYER), by
# leaf_gaps' rule and cap there.  The loss terms get INT8_LOSS_TOL plus twice their
# own move under the nudge, leaf_gaps' 2 x sens: the orientation term, a
# sum over the few samples whose normals face away from the camera, moves
# by 3.8e-4 of itself (3.1e-3 under the other sign), and the GPU step is
# 5.1e-3 from the CPU's.
REFNERF_BY_LAYER = ('NerfMLP_0/Dense_12/bias',)
# Steps of blender_256.gin and debug.gin, test views evaluated, frames.
SHORT_STEPS = 20
SHORT_EVAL_VIEWS = 2


def phase_pano(card):
  """configs/360.gin at full width on the distorted 24-view capture of
  phase_capture_360, rendered as a pano path (``render_camtype = 'pano'``,
  128 x 64, 4 frames of the ellipse) through ``render.main``: the frames,
  their AVIs, exactly 2 K1 + 2 K2 per chunk (one chunk a frame) and no
  plain call; a 16 x 8 pano frame on the GPU against the CPU, both from
  the host-cast rays through ImageRenderer (REFERENCE_BOUNDS); and one
  perspective test view rendered from host-cast rays (ImageRenderer)
  against the device cast (DeviceImageRenderer) on the card.  Returns
  {path: launches}."""
  import argparse
  from multinerf_tpu_torch import configs
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.models import nerf
  tag = 'pano'
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, 'capture')
    write_capture(data, ring_poses(), OPENCV)
    gin = [os.path.join(REPO, 'configs', '360.gin')]
    argv = [f'--gin_configs={gin[0]}', '--device=cuda'] + [
        f'--gin_bindings={b}' for b in (
            f"Config.data_dir='{data}'", f"Config.checkpoint_dir='{tmp}/ckpt'",
            f"Config.render_dir='{tmp}/render'", *PANO_BINDINGS,
            f'Config.render_resolution = {PANO_SIZE}',
            f'Config.render_path_frames = {PANO_FRAMES}')]
    torch.cuda.reset_peak_memory_stats()
    frames, launches, plain = _counted(render.main, argv)
    width, height = PANO_SIZE
    if frames['frames'] != list(range(PANO_FRAMES)):
      raise SystemExit(f'FAIL {tag}: frames {frames["frames"]}')
    _check_frames(f'{tag} render {width}x{height}', frames, (height, width))
    _check_videos(tag, frames, PANO_FRAMES)
    # 8,192 rays: one chunk a frame; 2 K1 (proposal levels) and 2 K2
    # (layer 0 and the skip layer) each.
    want = dict.fromkeys(launches, 0)
    want.update(density_mlp=2 * PANO_FRAMES, featurize_dense=2 * PANO_FRAMES)
    if launches != want or max(plain.values()):
      raise SystemExit(f'FAIL {tag}: launches {launches}, plain-version '
                       f'calls {plain}; expected {want} and none.')
    log(f'{tag} render: launches {launches}, plain-version calls {plain}, '
        f'max memory allocated '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')

    config = configs.load_config(argparse.Namespace(
        gin_configs=gin, gin_bindings=[
            f"Config.data_dir = '{data}'", *PANO_BINDINGS,
            f'Config.render_resolution = {PANO_REFERENCE_SIZE}']))
    pano = {}
    with datasets.load_dataset('test', data, config) as dataset:
      for device in ('cuda', 'cpu'):
        render_fn = train_lib.setup_model(config, render.SEED,
                                          torch.device(device))[2]
        pano[device] = nerf.ImageRenderer(render_fn, config, dataset,
                                          device)(1.0, 0)
    _hold_frames(f'{tag} (GPU kernels vs CPU plain versions, 16x8 pano '
                 'frame)', pano['cuda'], pano['cpu'], config.near)

    config = _capture_config('360.gin', data)
    render_fn = train_lib.setup_model(config, render.SEED,
                                      torch.device('cuda'))[2]
    with datasets.load_dataset('test', data, config) as dataset:
      host = nerf.ImageRenderer(render_fn, config, dataset, 'cuda')(1.0, 0)
      card_cast = nerf.DeviceImageRenderer(render_fn, config, dataset,
                                           'cuda')(1.0, 0)
    _hold_frames(f'{tag}: test view 0 ({dataset.width}x{dataset.height}), '
                 'host-cast rays (ImageRenderer) vs the card\'s cast '
                 '(DeviceImageRenderer)', host, card_cast, config.near)
  log(f'{tag} ({card}): {width}x{height} pano frames in '
      f'{", ".join(f"{s:.3f}" for s in frames["seconds"])} s, '
      f'{", ".join(f"{width * height / s:,.0f}" for s in frames["seconds"])} '
      'rays/s')
  return {'pano_render': launches}


def phase_render_many(card):
  """``DeviceImageRenderer.render_many`` of RENDER_MANY_K test views of
  configs/360.gin at full width (64 x 64, one chunk a frame) against as
  many single calls on the card: bitwise equal, 2 K1 + 2 K2 a frame, no
  plain call; the ms a frame of both ways, in turns (the port's
  counterpart of scripts/render_many_probe.py).  Returns {path:
  launches}."""
  import argparse
  from multinerf_tpu_torch import configs
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.models import nerf
  tag = 'render_many'
  config = configs.load_config(argparse.Namespace(
      gin_configs=[os.path.join(REPO, 'configs', '360.gin')],
      gin_bindings=["Config.dataset_loader = 'dummy_unbounded'"]))
  with datasets.load_dataset('test', None, config) as dataset:
    render_fn = train_lib.setup_model(config, render.SEED,
                                      torch.device('cuda'))[2]
    renderer = nerf.DeviceImageRenderer(render_fn, config, dataset, 'cuda')
  cams = list(range(RENDER_MANY_K))
  renderer(1.0, 0)  # Warm-up.
  stacked, launches, plain = _counted(renderer.render_many, 1.0, cams)
  want = dict.fromkeys(launches, 0)
  want.update(density_mlp=2 * len(cams), featurize_dense=2 * len(cams))
  if launches != want or max(plain.values()):
    raise SystemExit(f'FAIL {tag}: launches {launches}, plain-version calls '
                     f'{plain}; expected {want} and none.')
  for row, cam_idx in enumerate(cams):
    single = renderer(1.0, cam_idx)
    for key, value in single.items():
      rows = ([b[row] for b in stacked[key]] if isinstance(value, list)
              else [stacked[key][row]])
      for got, ref in zip(rows, value if isinstance(value, list) else [value]):
        if not np.array_equal(got, ref):
          raise SystemExit(f'FAIL {tag}: frame {cam_idx} {key} differs '
                           'from its single call.')
  many_ms, single_ms = [], []
  for _ in range(RENDER_MANY_REPEATS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.render_many(1.0, cams)
    many_ms.append((time.perf_counter() - t0) * 1e3 / len(cams))
    t0 = time.perf_counter()
    for cam_idx in cams:
      renderer(1.0, cam_idx)
    single_ms.append((time.perf_counter() - t0) * 1e3 / len(cams))
  log(f'{tag} ({card}): {len(cams)} 64x64 frames of 360.gin, bitwise equal '
      f'to single calls; ms a frame, render_many {many_ms}, single calls '
      f'{single_ms} (host clock, each ending in the copy to the host; '
      f'medians {statistics.median(many_ms):.3f} and '
      f'{statistics.median(single_ms):.3f})')
  return {'render_many': launches}


def phase_refnerf_int8(card):
  """configs/blender_refnerf.gin at full width on ``dummy_specular`` with
  ``NerfMLP.trunk_dtype`` 'int8' and then 'int8_hybrid': the density and
  predicted normals and the Ref-NeRF losses through the int8 trunk
  (unfused, under the density normals' double backward).  For each,
  REFNERF_INT8_STEPS steps of REFNERF_INT8_RAYS rays through
  ``train.main`` (the data loss must fall), ``eval.main`` of one test view
  with its normal MAEs, ``render.main`` of one frame, and a 256-ray step
  on the GPU against the CPU (INT8_TRAIN_GAP_CAP, REFNERF_BY_LAYER).  No
  kernel runs on this path, as in the JAX package: K1-K6 and their plain
  versions launch zero times.  Returns
  {path: launches}."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch import train
  paths = {}
  for mode in INT8_MODES:
    tag = f'refnerf {mode}'
    binding = f"NerfMLP.trunk_dtype = '{mode}'"
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
      base = [f'--gin_configs='
              f'{os.path.join(REPO, "configs", "blender_refnerf.gin")}',
              '--device=cuda'] + [f'--gin_bindings={b}' for b in (
                  "Config.dataset_loader='dummy_specular'",
                  f"Config.checkpoint_dir='{tmp}/ckpt'",
                  f'Config.max_steps={REFNERF_INT8_STEPS}', binding)]
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      trained = train.main(base + [f'--gin_bindings={b}' for b in (
          f'Config.batch_size={REFNERF_INT8_RAYS}', 'Config.lr_delay_steps=0',
          'Config.print_every=10')])
      peak_gib = torch.cuda.max_memory_allocated() / 2**30
      data = np.array(trained['data_losses'])
      if (len(data) != REFNERF_INT8_STEPS or
          not np.isfinite(trained['losses']).all()):
        raise SystemExit(f'FAIL {tag}: losses {trained["losses"]}')
      first, last = float(data[:10].mean()), float(data[-10:].mean())
      if not last < first:
        raise SystemExit(f'FAIL {tag}: the data loss did not fall '
                         f'({first:.5f} -> {last:.5f}).')
      evaluated = eval_lib.main(base + [
          '--gin_bindings=Config.eval_dataset_limit=1'])
      scores = _eval_scores(tag, evaluated, ('psnr', 'ssim', 'normals_mae',
                                             'normals_pred_mae'), 1,
                            step=REFNERF_INT8_STEPS)
      frames = render.main(base + [
          f"--gin_bindings=Config.render_dir='{tmp}/render'",
          '--gin_bindings=Config.render_num_jobs=16'])
      if frames['frames'] != [0]:
        raise SystemExit(f'FAIL {tag}: frames {frames["frames"]}')
      for key in ('rgb', 'normals', 'normals_pred', 'roughness'):
        if not np.isfinite(frames['renderings'][0][key]).all():
          raise SystemExit(f'FAIL {tag}: frame 0 {key} not finite')
    phase_train_reference(f'{tag} train reference', (binding,),
                          INT8_TRAIN_GAP_CAP, INT8_LOSS_TOL,
                          gin='blender_refnerf.gin', loader='dummy_specular',
                          loss_sens=2.0, by_layer=REFNERF_BY_LAYER)
    launches, plain = _counts()
    if max(launches.values()) or max(plain.values()):
      raise SystemExit(f'FAIL {tag}: launches {launches}, plain-version '
                       f'calls {plain}; the path runs no kernel.')
    step_s = statistics.median(trained['step_seconds'][5:])
    log(f'{tag} ({card}): median step {step_s * 1e3:.3f} ms over steps '
        f'6-{REFNERF_INT8_STEPS} at {REFNERF_INT8_RAYS} rays '
        f'({REFNERF_INT8_RAYS / step_s:,.0f} train rays/s), '
        f'max memory allocated {peak_gib:.2f} GiB; mean data loss, steps '
        f'1-10 {first:.5f}, steps {REFNERF_INT8_STEPS - 9}-'
        f'{REFNERF_INT8_STEPS} {last:.5f}; losses '
        f'{ {k: v for k, v in trained["stats"].items() if "losses/" in k} }; '
        f'eval of one view: psnr {scores["psnr"]}, ssim {scores["ssim"]}, '
        f'normals MAE {scores["normals_mae"]}, predicted normals MAE '
        f'{scores["normals_pred_mae"]}; a 48x48 frame in '
        f'{frames["seconds"][0]:.3f} s')
    paths[f'refnerf_{mode}'] = launches
  return paths


# K1-K4 at the shapes of configs/blender_256.gin and debug.gin, which no
# other kernel phase gives: (basis, min_deg, max_deg, use_contract),
# PropMLP depth x width over the K1/K3 samples of one proposal level,
# NerfMLP width over the K2/K4 samples, and the samples' Gaussians.
# blender_256: 96 features (16 degrees on the octahedron basis, 3
# directions), 4 x 256 over 16,384 x 128, 96 -> 256 over 16,384 x 32, no
# contraction.  debug.gin over 360.gin: 504 features, 2 x 64 over
# 2,048 x 64, 504 -> 128 over 2,048 x 32, contracted.
SHORT_SHAPES = {
    'blender_256': (('octahedron', 1), 0, 16, False, 4, 256, RAYS_512 * 128,
                    256, RAYS_512 * 32, _bounded_gaussians),
    'debug': (('icosahedron', 2), 0, 12, True, 2, 64, 2048 * 64, 128,
              2048 * 32, _gaussians),
}


def phase_short_kernels():
  """K1-K4 against their plain versions at SHORT_SHAPES, with the kernel
  phases' bounds, two launches bitwise equal, at N and N - 37: K1 and K2
  by _compare (and at the tile edges N = 1, 129, 300), K3 with a cotangent
  g >= 0 to TOL and with a random-signed one by train_lib.leaf_gaps
  against the plain version's own move (as phase_512_kernels), K4 by
  _compare_leaves; each kernel's single-call time, its plain version's and
  its bound.  Returns {config: {kernel: summary}}."""
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import density_mlp as dm
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  out = {}
  rng = np.random.RandomState(61)
  for key, (shape, min_deg, max_deg, contract, depth, h, n1, w, n2,
            gaussians) in SHORT_SHAPES.items():
    basis = np.array(geopoly.generate_basis(*shape)).T
    num_feats = 2 * (max_deg - min_deg) * basis.shape[-1]
    kw = dict(min_deg=min_deg, max_deg=max_deg, use_contract=contract)
    results = {}
    with _Watchdog(f'K1-K4 at the {key} shapes', PROBE_TIMEOUT_S):
      means, covs = gaussians(n1, seed=62)
      ws = [_he_uniform(rng, num_feats if l == 0 else h, h)
            for l in range(depth)]
      bs = [torch.tensor(rng.randn(h).astype(np.float32) * 0.1,
                         device='cuda') for _ in ws]
      wd = _he_uniform(rng, h, 1)
      bd = torch.tensor(np.float32(-0.3), device='cuda')
      args = lambda n: (means[:n], covs[:n], ws, bs, wd, bd, basis)
      run = lambda n: dm.density_mlp(*args(n), **kw)
      plain = lambda n: dm.density_mlp_plain(*args(n), **kw)
      tag = f'density_mlp {key} ({num_feats} -> {depth} x {h})'
      _hold_edges(tag, lambda n, _: run(n), lambda n, _: plain(n),
                  [(n, h) for n in EDGE_N])
      results['density_mlp'] = _compare(tag, run, plain, n1)

      def k3(fn, g):
        def grads(n, m=None):
          dws, dbs, dwd, dbd = fn(means[:n] if m is None else m, covs[:n],
                                  ws, bs, wd, g[:n], basis, **kw)
          return [*dws, *dbs, dwd, dbd]
        return grads
      g = torch.tensor(np.abs(rng.randn(n1)).astype(np.float32),
                       device='cuda')
      tag = f'density_mlp_bwd {key} ({num_feats} -> {depth} x {h})'
      results['density_mlp_bwd'] = _compare_leaves(
          f'{tag} (g >= 0)', k3(dm.density_mlp_backward, g),
          k3(dm.density_mlp_bwd_plain, g), n1)
      g = torch.tensor(rng.randn(n1).astype(np.float32), device='cuda')
      leaves = lambda fn, m: {f'leaf {i}': t.cpu() for i, t in enumerate(
          k3(fn, g)(n1, m))}
      gaps = train_lib.leaf_gaps(
          leaves(dm.density_mlp_backward, means),
          leaves(dm.density_mlp_bwd_plain, means),
          leaves(dm.density_mlp_bwd_plain, means * (1 + train_lib.NUDGE)),
          cap=TRAIN_GAP_CAP)
      log(f'{tag}, random-signed cotangent: relative L2 to plain (plain '
          'nudged) per leaf: ' + ', '.join(
              f'{gap:.2e} ({sens:.2e})' for gap, sens, _ in gaps.values()))
      over = {k: v for k, v in gaps.items() if not v[0] <= v[2]}
      if over:
        raise SystemExit(f'FAIL {tag}: over train_lib.leaf_gaps bounds: '
                         f'{over}')
      del means, covs, g

      means, covs = gaussians(n2, seed=63)
      kernel = _he_uniform(rng, num_feats, w)
      b = torch.tensor(rng.randn(w).astype(np.float32) * 0.1, device='cuda')
      args = lambda n: (means[:n], covs[:n], kernel, b, basis)
      run = lambda n: fd.featurize_dense(*args(n), **kw)
      plain = lambda n: fd.featurize_dense_plain(*args(n), **kw)
      tag = f'featurize_dense {key} ({num_feats} -> {w})'
      _hold_edges(tag, lambda n, _: run(n), lambda n, _: plain(n),
                  [(n, w) for n in EDGE_N])
      results['featurize_dense'] = _compare(tag, run, plain, n2)
      g = torch.tensor(rng.randn(n2, w).astype(np.float32), device='cuda')
      k4 = lambda fn: lambda n: [fn(means[:n], covs[:n], g[:n], basis, **kw)]
      results['featurize_dense_dw'] = _compare_leaves(
          f'featurize_dense_dw {key} ({num_feats} x {w})',
          k4(fd.featurize_dense_dw), k4(fd.featurize_dense_dw_plain), n2)
      del means, covs, g
      torch.cuda.empty_cache()
    bounds = kernel_bounds(f=num_feats, h=h, w=w, n1=n1, n2=n2, depth=depth)
    for name, summary in results.items():
      bound = bounds[name]
      summary.update(n=n1 if name.startswith('density') else n2,
                     bound_ms=bound['bound_ms'], bound_by=bound['bound_by'],
                     **_achieved(summary, bound))
      log(f'{name} {key}: {summary["ms"]:.3f} ms (plain '
          f'{summary["plain_ms"]:.3f} ms), bound {bound["bound_ms"]:.4f} ms '
          f'({bound["bound_by"]}), {summary["bound_share"]:.3f} of the bound')
    out[key] = results
  return out


def _short_config(tag, key, gins, data, rays, shape, render_jobs, card,
                  bindings=()):
  """SHORT_STEPS steps of the configs `gins` (in order, then `bindings`)
  at full width through ``train.main`` (K1-K4 every step), ``eval.main`` over
  SHORT_EVAL_VIEWS test views and ``render.main`` over the frames
  0, `render_jobs`, ... of the test views (K1/K2 in both, no plain call).
  Returns {path: launches}."""
  from multinerf_tpu_torch import eval as eval_lib
  from multinerf_tpu_torch import render
  no_train = F32_TRAIN[0][2:] + F32_RENDER[1]
  paths = {}
  with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, 'ckpt')
    paths[f'{key}_train'], step_s, summary = phase_train(
        f'{tag} train', bindings, SHORT_STEPS, F32_TRAIN, gin=gins,
        data=data, ckpt_dir=ckpt, rays=rays)
    argv = [f'--gin_configs={os.path.join(REPO, "configs", g)}'
            for g in gins] + ['--device=cuda'] + [
                f'--gin_bindings={b}' for b in (
                    *data, f"Config.checkpoint_dir='{ckpt}'",
                    f'Config.max_steps={SHORT_STEPS}')]
    evaluated, launches, plain = _counted(eval_lib.main, argv + [
        f'--gin_bindings=Config.eval_dataset_limit={SHORT_EVAL_VIEWS}'])
    _check_launches(f'{tag} eval', launches, plain,
                    (F32_RENDER[0], no_train))
    paths[f'{key}_eval'] = launches
    scores = _eval_scores(tag, evaluated, ('psnr', 'ssim'),
                          SHORT_EVAL_VIEWS, step=SHORT_STEPS)
    frames, launches, plain = _counted(render.main, argv + [
        f"--gin_bindings=Config.render_dir='{tmp}/render'",
        f'--gin_bindings=Config.render_num_jobs={render_jobs}'])
    _check_launches(f'{tag} render', launches, plain,
                    (F32_RENDER[0], no_train))
    paths[f'{key}_render'] = launches
    if len(frames['frames']) != 2:
      raise SystemExit(f'FAIL {tag} render: frames {frames["frames"]}')
    _check_frames(f'{tag} render {shape[1]}x{shape[0]}', frames, shape)
  log(f'{tag} ({card}): median step {step_s * 1e3:.3f} ms at {rays} rays '
      f'({rays / step_s:,.0f} train rays/s); launches in {SHORT_STEPS} steps '
      f'{paths[f"{key}_train"]}; eval of {SHORT_EVAL_VIEWS} views: psnr '
      f'{scores["psnr"]}, ssim {scores["ssim"]}; {shape[1]}x{shape[0]} '
      f'frames in {", ".join(f"{s:.3f}" for s in frames["seconds"])} s')
  return paths


def phase_blender_256(card):
  """configs/blender_256.gin (96 features, PropMLP 4 x 256 over one level
  of 128 samples, NerfMLP 8 x 256, single_image batching) on the 800 x 800
  Blender-layout scene of phase_blender_512, at its 16,384 rays a step;
  then a 256-ray step on the GPU against the CPU."""
  with tempfile.TemporaryDirectory() as tmp:
    data = os.path.join(tmp, 'blender')
    write_blender_scene(data)
    paths = _short_config('blender_256', 'blender_256', ('blender_256.gin',),
                          (f"Config.data_dir='{data}'",), RAYS_512,
                          (BLENDER_SIZE, BLENDER_SIZE), 2, card)
    phase_train_reference('blender_256 train reference',
                          gin='blender_256.gin', loader='blender',
                          data_dir=data)
  return paths


DEBUG_GINS = ('360.gin', 'debug.gin')


def phase_debug(card):
  """configs/debug.gin over 360.gin (504 features, PropMLP 2 x 64 over two
  levels, NerfMLP 4 x 128, 2,048 rays a step and a render chunk) on
  ``dummy_unbounded``, its early exit at step 3,000 moved to the run's
  last step; then a 16 x 16 frame and a 256-ray step on the GPU against
  the CPU."""
  paths = _short_config('debug', 'debug', DEBUG_GINS,
                        ("Config.dataset_loader='dummy_unbounded'",), 2048,
                        (64, 64), 24, card,
                        (f'Config.early_exit_steps = {SHORT_STEPS}',))
  phase_reference('debug reference', gins=DEBUG_GINS)
  phase_train_reference('debug train reference', gin=DEBUG_GINS)
  return paths


# Data parallelism (multinerf_tpu_torch/parallel/mesh.py) through
# ``python -m torch.distributed.run``, each launch running
# ``multinerf_tpu_torch.ddp_probe``'s parts under its own time limit.
DDP_TIMEOUT_S = 150
DDP_STEPS = 20
DDP_PARITY_STEPS = 3
DDP_EVAL_VIEWS = 3
# The fixed-batch step's losses against one process's: step 1 within
# ddp_probe.LOSS_RTOL (1e-5); steps 2-3 (bf16 trunk; int8 on two cards)
# within ddp_probe.LATER_LOSS_RTOL, which the control (the same steps with
# rank 1's share of the gradient dropped, run in every launch) must miss.
DDP_BASE = ("Config.dataset_loader='dummy_unbounded'",
            f'Config.batch_size={TRAIN_RAYS}', f'Config.max_steps={DDP_STEPS}',
            'Config.lr_delay_steps=0', 'Config.print_every=10')


def _gin_argv(bindings):
  return [f'--gin_configs={os.path.join(REPO, "configs", "360.gin")}'] + [
      f'--gin_bindings={b}' for b in bindings]


def _start_ranks(tag, nproc, spec, out_dir):
  """Start ddp_probe's parts of `spec` at `nproc` ranks; _finish_ranks
  waits for them."""
  from multinerf_tpu_torch import ddp_probe
  return tag, nproc, spec, out_dir, ddp_probe.start_parts(nproc, spec,
                                                          out_dir)


def _finish_ranks(launch):
  """The results of a _start_ranks launch, {part name: [each rank's
  result]}; its whole process group is killed DDP_TIMEOUT_S after its
  start."""
  from multinerf_tpu_torch import ddp_probe
  tag, nproc, spec, out_dir, ranks = launch
  try:
    ranks.wait(DDP_TIMEOUT_S)
  except ddp_probe.LaunchError as e:
    raise SystemExit(f'FAIL {tag}: {e}') from None
  results = ddp_probe.part_results(nproc, spec, out_dir)
  log(f'{tag}: {nproc} rank(s), {time.perf_counter() - ranks.started:.1f} s '
      'from the launch; rank 0\'s parts ' + ', '.join(
          f'{k} {v[0]["seconds"]:.1f} s' for k, v in results.items()))
  return results


def _ddp_train_checks(tag, ranks, ckpt_dir):
  """Every rank launched K1-K4 in every step and no plain version; only
  rank 0 wrote checkpoints, config.gin and the event file; every rank's
  losses are the global batch's.  Returns the launches summed over the
  ranks."""
  for r, res in enumerate(ranks):
    if len(res['per_step']) != DDP_STEPS:
      raise SystemExit(f'FAIL {tag}: rank {r} counted '
                       f'{len(res["per_step"])} steps.')
    fewest = {k: min(c[k] for c in res['per_step'])
              for k in res['per_step'][0]}
    _check_launches(f'{tag} rank {r} (every step)', fewest, res['plain'],
                    (F32_TRAIN[0], ()))
  if any(res['writes'] for res in ranks[1:]):
    raise SystemExit(f'FAIL {tag}: ranks > 0 wrote '
                     f'{[res["writes"] for res in ranks[1:]]}')
  mine = {os.path.basename(p) for p in ranks[0]['writes']}
  events = [f for f in os.listdir(ckpt_dir) if f.startswith('events.')]
  want = {'config.gin', 'checkpoint_1.pt.tmp',
          f'checkpoint_{DDP_STEPS}.pt.tmp'}
  if (not want <= mine or len(events) != 1 or
      not events[0].endswith(f'.{ranks[0]["pid"]}')):
    raise SystemExit(f'FAIL {tag}: rank 0 wrote {sorted(mine)}; event '
                     f'files {events}')
  if any(res['losses'] != ranks[0]['losses'] for res in ranks[1:]):
    raise SystemExit(f'FAIL {tag}: the ranks report other losses.')
  step_ms = [1e3 * statistics.median(res['step_seconds'][5:])
             for res in ranks]
  log(f'{tag}: K1-K4 every step on each rank, only rank 0 wrote; median '
      f'step per rank {", ".join(f"{ms:.3f}" for ms in step_ms)} ms at '
      f'{TRAIN_RAYS // len(ranks)} rays a rank; data losses '
      f'{ranks[0]["losses"][0]:.5f} -> {ranks[0]["losses"][-1]:.5f}')
  return {k: sum(sum(c[k] for c in res['per_step']) for res in ranks)
          for k in ranks[0]['per_step'][0]}


def _eval_frames(out_dir, views):
  from multinerf_tpu_torch.utils import io as io_lib
  frames = []
  for i in range(views):
    name = lambda key, ext: os.path.join(out_dir, f'{key}_{i:03d}.{ext}')
    frames.append({'rgb': io_lib.load_img(name('color', 'png')) / 255.0,
                   **{k: io_lib.load_img(name(k, 'tiff')) for k in (
                       'acc', 'distance_mean', 'distance_median')}})
  return frames


def _hold_parity(tag, results, part, refs, cap, later_rtol, kernels,
                 rays=TRAIN_RAYS, control="rank 1's gradient dropped"):
  """ddp_probe.hold_parity of the fixed-batch `part` of `rays` rays (and
  its control, `part`_drop) against one process's steps `refs` (plain,
  nudged); every rank launched `kernels` in every step.  Returns the
  launches summed over the ranks."""
  from multinerf_tpu_torch import ddp_probe
  for r, res in enumerate(results[part]):
    _check_launches(f'{tag} {part} rank {r} (every step)',
                    {k: min(c[k] for c in res['per_step'])
                     for k in res['per_step'][0]}, res['plain'], kernels)
  held = ddp_probe.hold_parity(results[part], *refs, cap, later_rtol,
                               results[f'{part}_drop'])
  first = results[part][0]
  per_rank = rays * first['model_size'] // first['world_size']
  log(f'{tag} {part}: {len(held["losses"])} steps of {per_rank} rays a '
      f'rank, losses {held["losses"]} vs one process '
      f'{held["one_process_losses"]}: relative gaps {held["loss_gaps"]}, '
      f'bounds {held["loss_bounds"]}; with {control} '
      f'{held["control_loss_gaps"]}; step 1\'s gradient, worst leaf '
      f'{held["worst_gradient_leaf"][1]:.3f} of its bound '
      f'({held["worst_gradient_leaf"][0]}); the ranks\' parameters bitwise '
      f'equal {held["replicated"]}')
  if not held['ok']:
    raise SystemExit(f'FAIL {tag} {part}: {held}')
  return {k: sum(sum(c[k] for c in res['per_step']) for res in results[part])
          for k in results[part][0]['per_step'][0]}


def _ddp_checks(tag, results, refs, ckpt_dir, eval_argv, device):
  """The parity, train and eval parts of an N-rank launch against one
  process: _hold_parity of each fixed-batch step (``refs``: {part: (cap,
  later bound, kernels, one process's steps, nudged)}); _ddp_train_checks;
  eval's frames against one rank's eval of the same checkpoint within
  REFERENCE_BOUNDS.  Returns {path: launches}."""
  from multinerf_tpu_torch import configs
  from multinerf_tpu_torch import ddp_probe
  from multinerf_tpu_torch import eval as eval_lib
  paths = {f'{tag} {part}': _hold_parity(tag, results, part, ref, cap,
                                         later_rtol, kernels)
           for part, (cap, later_rtol, kernels, *ref) in refs.items()}
  paths[f'{tag} train'] = _ddp_train_checks(f'{tag} train', results['train'],
                                            ckpt_dir)
  evaluated = results['eval']
  for r, res in enumerate(evaluated):
    _check_launches(f'{tag} eval rank {r}', res['launches'], res['plain'],
                    (F32_RENDER[0], F32_TRAIN[0][2:] + F32_RENDER[1]))
  one_rank = ckpt_dir + '_one_rank'
  os.makedirs(one_rank)
  for f in os.listdir(ckpt_dir):
    if f.startswith('checkpoint_'):
      shutil.copy(os.path.join(ckpt_dir, f), one_rank)
  eval_lib.main(eval_argv(one_rank) + [f'--device={device}'])
  near = configs.load_config(ddp_probe.configs_args(eval_argv(one_rank))).near
  for i, (got, want) in enumerate(zip(
      _eval_frames(os.path.join(ckpt_dir, 'test_preds'), DDP_EVAL_VIEWS),
      _eval_frames(os.path.join(one_rank, 'test_preds'), DDP_EVAL_VIEWS))):
    _hold_frames(f'{tag} eval view {i} ({len(evaluated)} ranks vs 1)', got,
                 want, near)
  paths[f'{tag} eval'] = {k: sum(res['launches'][k] for res in evaluated)
                          for k in evaluated[0]['launches']}
  return paths


def phase_ddp(card, device='cuda', bindings=()):
  """Data parallelism through ``python -m torch.distributed.run``, with
  360.gin at full width: (1) NCCL at world size 1, the train driver for
  DDP_STEPS steps of 4,096 rays, its losses bitwise equal to the same run
  with no launcher; (2) two ranks sharing cuda:0 over gloo, bf16 trunk,
  2,048 rays a rank: DDP_PARITY_STEPS steps on one fixed batch with no
  jitter held against one process's steps on the 4,096-ray batch (and the
  control, rank 1's gradient dropped, caught), the train driver for
  DDP_STEPS steps on the device plane and eval of DDP_EVAL_VIEWS views,
  against one rank's; (3) where there are two cards or more, the same with
  NCCL and one rank on each of two cards, and the int8 trunk's
  fixed-batch step too.
  `device` and `bindings` (more gin bindings) let the phase be rehearsed
  on the CPU at small widths.  Returns {path: launches}."""
  from multinerf_tpu_torch import ddp_probe
  from multinerf_tpu_torch import train
  t0 = time.perf_counter()
  paths = {}
  base = DDP_BASE + tuple(bindings)
  bf16 = BF16_BINDINGS + base
  parity_argv = {
      'parity': _gin_argv(bf16 + ('Config.randomized=False',)),
      'parity_int8': _gin_argv(tuple(int8_bindings('int8')) + base + (
          'Config.randomized=False',))}
  eval_argv = lambda ckpt_dir: _gin_argv(bf16 + (
      f"Config.checkpoint_dir='{ckpt_dir}'",
      f'Config.eval_dataset_limit={DDP_EVAL_VIEWS}'))

  def ranks(tag, nproc, where, ckpt_dir, parities):
    spec = dict(where, parts=[
        {'name': name + drop, 'kind': 'step', 'argv': parity_argv[name],
         'rays': TRAIN_RAYS, 'steps': DDP_PARITY_STEPS,
         **({'drop_rank': 1} if drop else {})}
        for name in parities for drop in ('', '_drop')] + [
        {'name': 'train', 'kind': 'train', 'argv': _gin_argv(
            bf16 + ('Config.device_data_plane=True',
                    f"Config.checkpoint_dir='{ckpt_dir}'"))},
        {'name': 'eval', 'kind': 'eval', 'argv': eval_argv(ckpt_dir)}])
    return _start_ranks(tag, nproc, spec, f'{ckpt_dir}_out')

  def one_process(name, cap, later_rtol, kernels):
    return (cap, later_rtol, kernels) + tuple(
        ddp_probe.run_steps(parity_argv[name], torch.device(device),
                            TRAIN_RAYS, DDP_PARITY_STEPS, nudge=nudge)
        for nudge in (False, True))

  cards = torch.cuda.device_count() if device == 'cuda' else 0
  if device == 'cuda':
    torch.cuda.empty_cache()  # The card is shared with the launched ranks.
  with tempfile.TemporaryDirectory() as tmp:
    # The world-size-1 launch and the two gloo ranks share the card with
    # this process, which meanwhile runs the references.
    shared = 'cuda:0' if device == 'cuda' else device
    gloo = ranks(f'ddp gloo x2 {shared}', 2,
                 {'device': shared, 'backend': 'gloo'}, f'{tmp}/gloo',
                 ('parity',))
    tag = 'ddp nccl x1'
    nccl1 = _start_ranks(tag, 1, {'device': device, 'parts': [
        {'name': 'train', 'kind': 'train', 'argv': _gin_argv(
            base + (f"Config.checkpoint_dir='{tmp}/nccl1'",))}]},
                         f'{tmp}/nccl1_out')
    plain = train.main(_gin_argv(base + (
        f"Config.checkpoint_dir='{tmp}/plain'",)) + [f'--device={device}'])
    refs = {'parity': one_process('parity', TRAIN_GAP_CAP,
                                  ddp_probe.LATER_LOSS_RTOL, F32_TRAIN)}

    results = _finish_ranks(nccl1)
    got = results['train'][0]['losses']
    if got != plain['losses']:
      raise SystemExit(f'FAIL {tag}: losses {got} under the launcher, '
                       f'{plain["losses"]} without it.')
    log(f'{tag}: {DDP_STEPS} losses bitwise equal to the run with no '
        'launcher')
    paths[f'{tag} train'] = _ddp_train_checks(f'{tag} train',
                                              results['train'],
                                              f'{tmp}/nccl1')
    paths.update(_ddp_checks(gloo[0], _finish_ranks(gloo), refs,
                             f'{tmp}/gloo', eval_argv, device))
    if cards >= 2:
      tag = 'ddp nccl x2'
      nccl = ranks(tag, 2, {'device': 'cuda'}, f'{tmp}/nccl',
                   ('parity', 'parity_int8'))
      refs['parity_int8'] = one_process('parity_int8', INT8_TRAIN_GAP_CAP,
                                        ddp_probe.LATER_LOSS_RTOL,
                                        INT8_TRAIN)
      paths.update(_ddp_checks(tag, _finish_ranks(nccl), refs,
                               f'{tmp}/nccl', eval_argv, device))
    else:
      log('ddp nccl x2: one card, not run')
  log(f'ddp ({card}): {time.perf_counter() - t0:.1f} s')
  return paths


# Tensor parallelism (multinerf_tpu_torch/parallel/tensor.py): 360.gin's
# NerfMLP split over a model group of 2 (mesh.create_mesh(model_parallel=2)),
# each rank running K2 and K4 over its 512 of the 1,024 columns.
TP_GLOO_RAYS = 1024  # Two ranks on one card: 7 all-reduces of [N, 1024] f32
# a step go through pinned host memory (134 MB each at 1,024 rays).
TP_NCCL_RAYS = TRAIN_RAYS
TP_STEPS = 3
TP_WIDTH = 512  # A rank's columns of the 1,024-wide trunk.
# Every step of each rank: K1-K4 twice (two proposal levels; Dense_0 and
# the skip layer's feature rows), K5/K6 once under int8.
TP_PER_STEP = {'parity': {'density_mlp': 2, 'featurize_dense': 2,
                          'density_mlp_bwd': 2, 'featurize_dense_dw': 2,
                          'int8_trunk': 0, 'int8_trunk_bwd': 0},
               'parity_int8': {'density_mlp': 2, 'featurize_dense': 0,
                               'density_mlp_bwd': 2, 'featurize_dense_dw': 0,
                               'int8_trunk': 1, 'int8_trunk_bwd': 1}}
TP_BYTES_SHARE = 0.75  # tests/test_train_e2e.py:186's bound.


def phase_tp_kernels():
  """K2 and K4 against their plain versions at a model rank's shape under
  model_parallel = 2: 504 features -> 512 columns over 131,072 samples."""
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T
  num_feats = 2 * 12 * basis.shape[-1]
  n = K2_SAMPLES
  log_forward_plans(num_feats, basis.shape[-1], w=TP_WIDTH)
  rng = np.random.RandomState(11)
  means, covs = _gaussians(n, seed=12)
  w = _he_uniform(rng, num_feats, TP_WIDTH)
  b = torch.tensor(rng.randn(TP_WIDTH).astype(np.float32) * 0.1,
                   device='cuda')
  g = torch.tensor(rng.randn(n, TP_WIDTH).astype(np.float32), device='cuda')
  args = lambda k: (means[:k], covs[:k], w, b, basis)
  results = {'featurize_dense': _compare(
      'featurize_dense (504 -> 512)',
      lambda k: fd.featurize_dense(*args(k), use_contract=True),
      lambda k: fd.featurize_dense_plain(*args(k), use_contract=True), n)}
  k4 = lambda fn: lambda k: [fn(means[:k], covs[:k], g[:k], basis)]
  results['featurize_dense_dw'] = _compare_leaves(
      'featurize_dense_dw (504 -> 512)', k4(fd.featurize_dense_dw),
      k4(fd.featurize_dense_dw_plain), n)
  bounds = kernel_bounds(w=TP_WIDTH)
  for name, summary in results.items():
    summary.update(n=n, width=TP_WIDTH, **_achieved(summary, bounds[name]),
                   bound_ms=bounds[name]['bound_ms'],
                   bound_by=bounds[name]['bound_by'])
    log(f'{name} (504 -> 512) N={n}: bound {summary["bound_ms"]:.4f} ms '
        f'(set by {summary["bound_by"]}), {summary["ms"]:.3f} ms')
  return results


def _tp_checks(tag, results, refs, frame, near, rays):
  """A model-parallel launch's parts against one process's (`refs`:
  {part: (cap, later bound, kernels, steps, nudged steps)}, `frame` its
  render): hold_parity with the model-rank control; each rank's launches
  in every step (TP_PER_STEP) with K2/K4 (and K5/K6) at `rays` x 32
  samples; the bytes a rank holds; the frame.  Returns {path: launches}."""
  paths = {}
  for part, (cap, later_rtol, kernels, *ref) in refs.items():
    paths[f'{tag} {part}'] = _hold_parity(
        tag, results, part, ref, cap, later_rtol, kernels, rays,
        "model rank 1's part zeroed in its first collective")
    one = ref[0]['bytes']
    for r, res in enumerate(results[part]):
      for i, counted in enumerate(res['per_step']):
        if counted != TP_PER_STEP[part]:
          raise SystemExit(f'FAIL {tag} {part} rank {r} step {i + 1}: '
                           f'launches {counted}, want {TP_PER_STEP[part]}')
      n = rays * 32
      want = {k: {n: c * TP_STEPS} for k, c in TP_PER_STEP[part].items()
              if c and k in ('featurize_dense', 'featurize_dense_dw',
                             'int8_trunk', 'int8_trunk_bwd')}
      if res['sizes'] != want:
        raise SystemExit(f'FAIL {tag} {part} rank {r}: launch sizes '
                         f'{res["sizes"]}, want {want}')
      if not res['bytes'] < TP_BYTES_SHARE * one:
        raise SystemExit(f'FAIL {tag} {part} rank {r}: {res["bytes"]:,} '
                         f'bytes of parameters and Adam state, one process '
                         f'{one:,}')
    first = results[part][0]
    log(f'{tag} {part}: {res["bytes"]:,} bytes of parameters and Adam '
        f'state a rank, {res["bytes"] / one:.4f} of one process\'s {one:,}; '
        f'step ms per rank ' + '; '.join(
            ', '.join(f'{ms:.1f}' for ms in r['step_ms'])
            for r in results[part]) + ' (one process: ' +
        ', '.join(f'{ms:.1f}' for ms in ref[0]['step_ms']) + ')' + (
            f'; NCCL kernels of the last step on rank 0: '
            f'{first["allreduce_ms"]:.3f} ms of device time'
            if 'allreduce_ms' in first else ''))
  renders = results['render']
  for r, res in enumerate(renders):
    _check_launches(f'{tag} render rank {r}', res['launches'], res['plain'],
                    F32_RENDER)
    _hold_frames(f'{tag} render rank {r} (64x64 test view vs one process)',
                 res['frame'], frame, near)
  paths[f'{tag} render'] = {k: sum(res['launches'][k] for res in renders)
                            for k in renders[0]['launches']}
  return paths


def phase_tp(card, device='cuda', bindings=(), min_dim_to_shard=512):
  """Tensor parallelism through ``python -m torch.distributed.run`` at
  model size 2, 360.gin at full width: (1) two gloo ranks sharing cuda:0,
  the bf16 trunk's fixed-batch step (TP_GLOO_RAYS rays, no jitter,
  TP_STEPS steps) and the int8 trunk's held against one process's (step
  1's loss within ddp_probe.LOSS_RTOL, the later steps within
  ddp_probe.LATER_LOSS_RTOL, which the control with model rank 1's part
  dropped must miss, step 1's gradient by ``leaf_gaps``), K1-K4 (K1, K3,
  K5, K6 under int8) in every step of each rank, the bytes a rank holds,
  and a 64 x 64 test view against one process's; (2) where there are two
  cards or more, the same with NCCL, one rank a card, at TP_NCCL_RAYS
  rays, with the NCCL kernels' device time of a step.  `device`,
  `bindings` and `min_dim_to_shard` let the phase be rehearsed on the CPU
  at small widths.
  Returns {path: launches}."""
  from multinerf_tpu_torch import configs
  from multinerf_tpu_torch import ddp_probe
  t0 = time.perf_counter()
  base = DDP_BASE + tuple(bindings)
  parity_argv = {
      'parity': _gin_argv(BF16_BINDINGS + base + ('Config.randomized=False',)),
      'parity_int8': _gin_argv(tuple(int8_bindings('int8')) + base + (
          'Config.randomized=False',))}
  render_argv = _gin_argv(BF16_BINDINGS + base)
  near = configs.load_config(ddp_probe.configs_args(render_argv)).near

  def spec(where, rays, profile):
    parts = [{'name': name + drop, 'kind': 'step', 'argv': parity_argv[name],
              'rays': rays, 'steps': TP_STEPS,
              **({'drop_model_rank': 1} if drop else {'profile': profile})}
             for name in parity_argv for drop in ('', '_drop')]
    return dict(where, model_parallel=2, min_dim_to_shard=min_dim_to_shard,
                parts=parts + [
        {'name': 'render', 'kind': 'render', 'argv': render_argv}])

  def one_process(rays):
    refs = {}
    for name, cap, kernels in (('parity', TRAIN_GAP_CAP, F32_TRAIN),
                               ('parity_int8', INT8_TRAIN_GAP_CAP,
                                INT8_TRAIN)):
      refs[name] = (cap, ddp_probe.LATER_LOSS_RTOL, kernels) + tuple(
          ddp_probe.run_steps(parity_argv[name], torch.device(device), rays,
                              TP_STEPS, nudge=nudge) for nudge in (False, True))
    return refs, ddp_probe.run_render(render_argv, torch.device(device))['frame']

  paths = {}
  cards = torch.cuda.device_count() if device == 'cuda' else 0
  if device == 'cuda':
    torch.cuda.empty_cache()  # The card is shared with the launched ranks.
  with tempfile.TemporaryDirectory() as tmp:
    shared = 'cuda:0' if device == 'cuda' else device
    tag = f'tp gloo 1x2 {shared}'
    gloo = _start_ranks(tag, 2, spec({'device': shared, 'backend': 'gloo'},
                                     TP_GLOO_RAYS, False), f'{tmp}/gloo')
    refs, frame = one_process(TP_GLOO_RAYS)
    paths.update(_tp_checks(tag, _finish_ranks(gloo), refs, frame, near,
                            TP_GLOO_RAYS))
    if cards >= 2:
      tag = 'tp nccl 1x2'
      nccl = _start_ranks(tag, 2, spec({'device': 'cuda'}, TP_NCCL_RAYS,
                                       True), f'{tmp}/nccl')
      refs, frame = one_process(TP_NCCL_RAYS)
      paths.update(_tp_checks(tag, _finish_ranks(nccl), refs, frame, near,
                              TP_NCCL_RAYS))
    else:
      log('tp nccl 1x2: one card, not run')
  log(f'tp ({card}): {time.perf_counter() - t0:.1f} s')
  return paths


# --- Grid-culled rendering and the quality harnesses.

CULL_RENDER_RUNGS = (0.5, 0.33)
CULL_RENDER_TRUNKS = (('bfloat16', BF16_BINDINGS, F32_RENDER,
                       'featurize_dense', REFERENCE_BOUNDS),
                      ('int8', tuple(int8_bindings('int8')), INT8_RENDER,
                       'int8_trunk', INT8_REFERENCE_BOUNDS))
CULL_RENDER_SIZE = 64  # dummy_unbounded's test views: one 4,096-ray chunk.
CULL_CHUNK_RAYS = 16384  # A whole render chunk of 360.gin.
HARNESS_TIMEOUT_S = 240
HARNESS_STEPS = 32
# The harness smoke's culled arm: refresh every 8 steps and a density
# threshold no weights reach (CULL_ENGAGED), so the one rung engages at the
# first refresh and culls steps 9-32 (warmup HARNESS_STEPS // 8).
HARNESS_CULL_SETTINGS = ('occupancy_grid_refresh_every=8, '
                         'occupancy_threshold=1000.0')


def _cull_render_config(bindings):
  import argparse
  from multinerf_tpu_torch import configs
  return configs.load_config(argparse.Namespace(
      gin_configs=[os.path.join(REPO, 'configs', '360.gin')],
      gin_bindings=["Config.dataset_loader = 'dummy_unbounded'",
                    'Config.occupancy_culling = True', *bindings]))


# (b)'s keep masks on the card and on the CPU: a sample within a rounding
# error of a cell face may land in the neighbouring cell (the bound of
# tests/test_torch_culling.py's cell ids), and its keep decision with it.
KEEP_FLIP_SHARE = 1e-3


@contextlib.contextmanager
def _keep_masks(replay=None):
  """``culling.apply_culled`` with each call's keep mask, as the Model
  computed it, recorded on the host into the list yielded; given `replay`
  (such a list), each call culls by its mask in turn instead."""
  from multinerf_tpu_torch.models import culling
  apply_culled = culling.apply_culled
  masks = []

  def hooked(mlp, means, covs, keep, capacity_frac, **kwargs):
    masks.append(keep.detach().cpu())
    if replay is not None:
      keep = replay[len(masks) - 1].to(keep.device)
    return apply_culled(mlp, means, covs, keep, capacity_frac, **kwargs)

  culling.apply_culled = hooked
  try:
    yield masks
  finally:
    culling.apply_culled = apply_culled


def _cull_render_kernels(sizes_by_kernel):
  """K2 and K5 against their plain versions at each compact N the culled
  frames launched them at, and at the rungs' N of a whole render chunk
  (CULL_CHUNK_RAYS x 32 samples).  Returns {kernel: [summary]}."""
  from multinerf_tpu_torch.models import culling
  from multinerf_tpu_torch.ops import geopoly
  from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
  from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T
  num_feats = 2 * 12 * basis.shape[-1]
  chunk_ns = {culling.round_capacity(CULL_CHUNK_RAYS * 32, c)
              for c in CULL_RENDER_RUNGS}
  rng = np.random.RandomState(13)
  w = _he_uniform(rng, num_feats, 1024)
  b = torch.tensor(rng.randn(1024).astype(np.float32) * 0.1, device='cuda')
  ws, bs = _nerf_trunk(rng, num_feats)
  kw = dict(use_contract=True, skip_layers=NERF_SKIP)
  results = {}
  for name in ('featurize_dense', 'int8_trunk'):
    out = results[name] = []
    for n in sorted(set(sizes_by_kernel[name]) | chunk_ns):
      means, covs = _gaussians(n, seed=n % 1000)
      if name == 'featurize_dense':
        args = lambda k: (means[:k], covs[:k], w, b, basis)
        summary = _compare(
            f'{name} (culled render)',
            lambda k: fd.featurize_dense(*args(k), use_contract=True),
            lambda k: fd.featurize_dense_plain(*args(k), use_contract=True),
            n)
      else:
        k5 = lambda fn: lambda k: [fn(means[:k], covs[:k], ws, bs, basis,
                                      **kw)]
        summary = _compare_rel(f'{name} (culled render)',
                               k5(i8t.int8_trunk), k5(i8t.int8_trunk_plain),
                               n, I8_TOL)
      bound = kernel_bounds(n2=n)[name]
      summary.update(n=n, whole_chunk=n in chunk_ns,
                     **_achieved(summary, bound), bound_ms=bound['bound_ms'],
                     bound_by=bound['bound_by'])
      log(f'{name} (culled render) N={n}: bound {summary["bound_ms"]:.4f} '
          f'ms (set by {summary["bound_by"]}), {summary["ms"]:.3f} ms')
      out.append(summary)
      del means, covs
  return results


def phase_cull_render(card, device='cuda', bindings=()):
  """Grid-culled rendering (``train_lib.create_render_fn(model, cull=)``)
  of 360.gin at full width under the bf16 and the int8 trunk, on the
  DeviceImageRenderer: (a) a grid whose every cell clears the threshold,
  at capacity 1.0, bitwise equal to the unculled frame of the 64 x 64
  test view; (b) the half-empty grid at the rungs 0.5 and 0.33 (at least
  one overflowing: more samples kept than the capacity), the 64 x 64 view
  on the card, and a 16 x 16 path frame on the card against the CPU's
  culled frame on the same weights, grid and keep masks (REFERENCE_BOUNDS;
  the int8 trunk's, as phase_reference's), the masks the two compute
  differing in at most KEEP_FLIP_SHARE of the samples.  K2 (K5 under
  int8) must launch at N = capacity in each culled frame; then both are
  held against their plain versions at those N and at a whole render
  chunk's.  Returns ({'render_cull': launches of the culled 64 x 64
  frames}, {kernel: [summary]}).  `device` and `bindings` let the phase be
  rehearsed on the CPU at small widths."""
  from multinerf_tpu_torch import render
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.data import datasets
  from multinerf_tpu_torch.models import culling
  from multinerf_tpu_torch.models import nerf
  t0 = time.perf_counter()
  card_device = torch.device(device)
  n = CULL_RENDER_SIZE**2 * 32
  launches = collections.Counter()
  compact = collections.defaultdict(list)
  for trunk, trunk_bindings, kernels, kernel, bounds in CULL_RENDER_TRUNKS:
    tag = f'cull render {trunk}'
    trunk_bindings += tuple(bindings)
    config = _cull_render_config(trunk_bindings)
    dataset = datasets.load_dataset('test', None, config)
    model, _, render_fn, _, _ = train_lib.setup_model(config, render.SEED,
                                                      card_device)
    grid = model.occupancy.grid
    unculled = nerf.DeviceImageRenderer(render_fn, config, dataset,
                                        card_device)(1.0, 0)
    frames, keeps = {}, {}
    _reset_counts()
    with _launch_sizes() as sizes:
      for cap in (1.0,) + CULL_RENDER_RUNGS:
        # Every cell over the density threshold (5e-3) for (a), then the
        # half-empty grid.
        grid.copy_(torch.ones_like(grid) if cap == 1.0 else
                   culling.half_space_grid(
                       config.occupancy_grid_resolution, card_device))
        with _keep_masks() as keeps[cap]:
          frames[cap] = nerf.DeviceImageRenderer(
              train_lib.create_render_fn(model, cull=cap), config, dataset,
              card_device)(1.0, 0)
    counted, plain = _counts()
    _check_launches(tag, counted, plain, kernels)
    launches.update(counted)
    per_chunk = 2 if kernel == 'featurize_dense' else 1
    want = {culling.round_capacity(n, cap): per_chunk
            for cap in (1.0,) + CULL_RENDER_RUNGS}
    got = _by_n(sizes).get(kernel, {})
    if got != want:
      raise SystemExit(f'FAIL {tag}: {kernel} launches by N {got}, want '
                       f'{want}')
    compact[kernel] += list(got)
    for name, frame in frames.items():
      if not all(np.isfinite(v).all() for k, v in frame.items()
                 if not k.startswith('ray_')):
        raise SystemExit(f'FAIL {tag} capacity {name}: non-finite output')
    # (a): the compaction only permutes the samples and every product is
    # per sample, so the frame is the unculled one bit for bit (measured
    # so under both trunks).
    same = all(np.array_equal(frames[1.0][k], unculled[k]) for k in (
        'rgb', 'acc', 'distance_mean', 'distance_median'))
    log(f'{tag} (a): every cell kept, capacity 1.0: the 64x64 frame '
        f'{"bitwise equal to" if same else "differs from"} the unculled one '
        f'({_frame_gaps(frames[1.0], unculled, config.near)})')
    if not same:
      raise SystemExit(f'FAIL {tag} (a): the culled frame differs')
    overflow = {}
    for cap in CULL_RENDER_RUNGS:
      keep = float(keeps[cap][0].float().mean())
      overflow[cap] = keep > culling.round_capacity(n, cap) / n
      log(f'{tag} (b) rung {cap}: kept share {keep:.4f} of {n:,} samples, '
          f'capacity {culling.round_capacity(n, cap):,}'
          f'{" (overflow)" if overflow[cap] else ""}; rgb '
          f'{np.abs(frames[cap]["rgb"] - unculled["rgb"]).max():.4f} from '
          'the unculled frame at most')
    if not any(overflow.values()):
      raise SystemExit(f'FAIL {tag} (b): no rung overflows')
    # (b) on the card against the CPU: the same seed draws the same
    # weights on both, and both get the same grid.  The CPU culls by the
    # card's keep masks, so that both compact the same samples; the masks
    # each side computes are held apart.
    small = _cull_render_config(trunk_bindings + (
        'Config.render_path = True', 'Config.render_resolution = (16, 16)'))
    small_data = datasets.load_dataset('test', None, small)
    for cap in CULL_RENDER_RUNGS:
      pair, masks = [], None
      for d in (card_device, torch.device('cpu')):
        model_d = train_lib.setup_model(small, render.SEED, d)[0]
        model_d.occupancy.grid.copy_(culling.half_space_grid(
            small.occupancy_grid_resolution, d))
        with _keep_masks(replay=masks) as recorded:
          pair.append(nerf.DeviceImageRenderer(
              train_lib.create_render_fn(model_d, cull=cap), small,
              small_data, d)(1.0, 0))
        masks = masks or recorded
      flips = sum(int((a != b).sum()) for a, b in zip(masks, recorded))
      total = sum(m.numel() for m in masks)
      log(f'{tag} (b) rung {cap}: keep masks on the card and the CPU differ '
          f'in {flips} of {total:,} samples (bound {KEEP_FLIP_SHARE} of '
          'them); the CPU culls by the card\'s')
      if not flips <= KEEP_FLIP_SHARE * total:
        raise SystemExit(f'FAIL {tag} (b) rung {cap}: {flips} keep decisions '
                         'differ')
      _hold_frames(f'{tag} (b) rung {cap} (GPU vs CPU, 16x16 culled frame, '
                   'the same keep masks)', *pair, small.near, bounds)
    del model, grid
  log(f'cull render: launches of the culled 64x64 frames {dict(launches)}, '
      f'compact N {dict(compact)}')
  kernels = _cull_render_kernels(compact)
  log(f'cull render ({card}): {time.perf_counter() - t0:.1f} s')
  return {'render_cull': dict(launches)}, kernels


def _run_harness(tag, args):
  """`python3 args` from the repository root, killed at
  HARNESS_TIMEOUT_S; its standard output."""
  t0 = time.perf_counter()
  try:
    proc = subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True,
                          timeout=HARNESS_TIMEOUT_S, check=False)
  except subprocess.TimeoutExpired:
    raise SystemExit(f'FAIL {tag}: no end within {HARNESS_TIMEOUT_S} s'
                     ) from None
  log(f'{tag}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s')
  if proc.returncode:
    raise SystemExit(f'FAIL {tag}: {proc.stdout[-2000:]}{proc.stderr[-4000:]}')
  return proc.stdout


def _keys(tag, got, want):
  if set(got) != set(want):
    raise SystemExit(f'FAIL {tag}: keys {sorted(got)}, want {sorted(want)}')


def phase_harnesses(card, device='cuda', setup='', bindings=()):
  """The quality harnesses through their entry points' ``main``, each in a
  process of its own killed at HARNESS_TIMEOUT_S, at 360.gin widths for a
  few dozen steps: ``cull_quality`` (--flagship, bf16, dummy_scatter, the
  full arm and rung 0.33, HARNESS_STEPS steps with HARNESS_CULL_SETTINGS
  so that the gate engages: steps 9-32 culled), ``int8_eval_decision`` (16
  steps a 360 arm, 4 Ref-NeRF steps) and ``keep_frac_probe`` (its four
  default rules) on the checkpoint of a 20-step 360.gin run of the train
  entry point (bf16, dummy_unbounded).  Checks each output's keys and the
  card's line in it.  `device`, `setup` (Python run first in each process)
  and `bindings` (of the train run) let the phase be rehearsed on the CPU
  at small widths."""
  from multinerf_tpu_torch import train
  t0 = time.perf_counter()

  def run(module, argv, prelude=''):
    return _run_harness(f'harness {module}', ['-c', '\n'.join([
        setup, 'from multinerf_tpu_torch import harness', prelude,
        f'from multinerf_tpu_torch import {module}',
        f'{module}.main({argv!r}, device={device!r})'])])

  entry = {'step', 'test_psnr', 'train_psnr', 'keep_frac', 'cull_steps'}
  with tempfile.TemporaryDirectory() as tmp:
    out = run('cull_quality', [
        '--flagship', '--trunk_dtype', 'bfloat16', '--loader',
        'dummy_scatter', '--capacities', '0.33', '--steps',
        str(HARNESS_STEPS), '--eval_every', '16', '--tag', 'smoke', '--out',
        tmp], f'harness.TRAIN_SETTINGS.update({HARNESS_CULL_SETTINGS})')
    log(out.strip())
    with open(os.path.join(tmp, 'cull_quality_dummy_scatter_smoke.json')) as f:
      cull = json.load(f)
    _keys('harness cull_quality', cull, ('steps', 'batch', 'loader',
                                         'flagship', 'trunk_dtype',
                                         'keep_rule', 'alpha_eps', 'runs',
                                         'device'))
    runs = cull['runs']
    _keys('harness cull_quality runs', runs, ('full', 'cull_0.33'))
    last = runs['cull_0.33'][-1]
    _keys('harness cull_quality culled entry', last, entry | {
        'test_psnr_cull_render', 'train_time_s', 'keep_frac_trace'})
    _keys('harness cull_quality full entry', runs['full'][-1],
          entry | {'train_time_s'})
    trace = [s for s, _ in last['keep_frac_trace']]
    if (cull['device'] != card or last['cull_steps'] != HARNESS_STEPS - 8 or
        trace != [8, 16, 24, 32] or not all(
            np.isfinite(e[k]) for e in runs['full'] + runs['cull_0.33']
            for k in e if 'psnr' in k)):
      raise SystemExit(f'FAIL harness cull_quality: {cull}')

    out = run('int8_eval_decision', ['--steps', '16', '--refnerf_steps', '4',
                                     '--out', tmp])
    log(out.strip())
    with open(os.path.join(tmp, 'INT8_EVAL_DECISION.json')) as f:
      decision = json.load(f)
    _keys('harness int8_eval_decision', decision, (
        'measurements', 'min_psnr_delta_360', 'refnerf_psnr_delta',
        'refnerf_render_speedup', 'decision', 'device'))
    arms = [m['arm'] for m in decision['measurements']]
    if (decision['device'] != card or decision['decision'] not in (
        'default-on', 'opt-in') or arms != [
            '360_dummy_sphere', '360_dummy_scatter', '360_dummy_unbounded',
            'refnerf_dummy_sphere']):
      raise SystemExit(f'FAIL harness int8_eval_decision: {decision}')

    ckpt = os.path.join(tmp, 'ckpt')
    train.main(_gin_argv(BF16_BINDINGS + (
        "Config.dataset_loader='dummy_unbounded'",
        f'Config.batch_size={TRAIN_RAYS}', 'Config.max_steps=20',
        'Config.print_every=10', f"Config.checkpoint_dir='{ckpt}'") +
                         tuple(bindings)) + [f'--device={device}'])
    out = run('keep_frac_probe', ['--checkpoint_dir', ckpt])
    log(out.strip())
    probe = json.loads(out.strip().splitlines()[-1])
    _keys('harness keep_frac_probe', probe,
          ('checkpoint', 'loader', 'keep_fracs', 'device'))
    fracs = probe['keep_fracs']
    if (probe['device'] != card or len(fracs) != 4 or
        not all(0 <= v <= 1 for v in fracs.values())):
      raise SystemExit(f'FAIL harness keep_frac_probe: {probe}')
  log(f'harnesses ({card}): {time.perf_counter() - t0:.1f} s')


# profile_step's culled rungs and windows (phase_profile_cull): bf16 at
# 360.gin's full width, 4,096 rays a step, a few steps each.
PROFILE_ARGV = ('--gin_configs=configs/360.gin',
                "--gin_bindings=Config.dataset_loader='dummy_unbounded'",
                f'--gin_bindings=Config.batch_size={TRAIN_RAYS}') + tuple(
                    f'--gin_bindings={b}' for b in BF16_BINDINGS)
PROFILE_RUNS = (  # (capacity or None, window, extra flags)
    (0.33, 1, ('--cull', '--warmup=4', '--steps=2')),
    (0.5, 1, ('--cull=0.5', '--warmup=4', '--steps=2')),
    (None, 8, ('--window=8', '--warmup=2', '--steps=1',
               '--gin_bindings=Config.device_data_plane=True')),
    (0.33, 8, ('--cull', '--window=8', '--warmup=2', '--steps=1',
               '--gin_bindings=Config.device_data_plane=True')),
)
PROFILE_KEYS = {'wall_ms', 'busy_ms', 'idle', 'step_ms', 'allreduce_ms',
                'world_size', 'capacity', 'compact_n', 'keep_frac', 'window',
                'compaction_ms', 'span_ms', 'idle_ms', 'kernels'}
# The rungs whose compact N no other phase holds K2/K4 at.
PROFILE_HELD_RUNGS = (0.5, 0.67)
RENDER_BENCH_FRAMES = 2
RENDER_BENCH_KEYS = {'trunk_dtype', 'checkpoint_step', 'frame_hw',
                     'sec_per_frame', 'rays_per_sec', 'first_frame_s', 'psnr',
                     'frames', 'device'}
# The stability run cut short: windows of 10 on the device plane, the
# ladder engaged from the first refresh (CULL_ENGAGED), killed past step
# 110 after checkpoint_100.pt, so phase 2 resumes at 101 (90 steps before
# the next checkpoint could overtake the kill); eval of 4 test views.
STABILITY_STEPS = 200
STABILITY_KILL = (100, 110)
STABILITY_BINDINGS = (f'Config.max_steps={STABILITY_STEPS}',
                      'Config.steps_per_jit_call=10', 'Config.print_every=10',
                      'Config.checkpoint_every=100',
                      'Config.train_render_every=100',
                      'Config.eval_dataset_limit=4',
                      'Config.occupancy_warmup_steps=20',
                      'Config.occupancy_grid_refresh_every=20',
                      'Config.occupancy_threshold=1000.0')
STABILITY_TIMEOUT_S = 300


def _run_counted(tag, code):
  """`python3 -c code` from the repository root under HARNESS_TIMEOUT_S
  (_run_harness), `code` wrapped so that it resets the launch counts,
  records K2/K4/K5/K6's N, and prints them as its last line: (the run's
  standard output, {'launches', 'plain', 'sizes' ({kernel: {N: count}})})."""
  out = _run_harness(tag, ['-c', '\n'.join([
      'import json', 'import chip_smoke as c', 'c._reset_counts()',
      'with c._launch_sizes() as sizes:',
      *('  ' + line for line in code.splitlines()),
      'launches, plain = c._counts()',
      "print(json.dumps({'launches': launches, 'plain': plain, "
      "'sizes': c._by_n(sizes)}))"])])
  lines = out.strip().splitlines()
  counted = json.loads(lines[-1])
  counted['sizes'] = {k: {int(n): v for n, v in by_n.items()}
                      for k, by_n in counted['sizes'].items()}
  return '\n'.join(lines[:-1]), counted


def phase_profile_cull(card):
  """``python -m multinerf_tpu_torch.profile_step`` at 360.gin's full width
  (bf16, 4,096 rays), the four runs in processes of their own at once
  (their times are not measurements): forced rungs 0.33 (``--cull``) and
  0.5 on the half grid on the host path, then ``--window=8`` on the device
  plane unculled and at 0.33.  Checks each JSON's keys, ``compact_n`` =
  ``culling.round_capacity`` of the rung, a culled step's compaction time,
  the device time by span (``train/step``'s above 0, all of it charged to
  spans: no ``trace.UNLINKED``; ``compaction_ms`` that of
  ``culling.COMPACTION``'s span), and the launches: K1-K4 2 a step, K2/K4 at N = compact_n in a culled
  step.  Returns {'profile_cull': launches}."""
  from multinerf_tpu_torch.models import culling
  from multinerf_tpu_torch.utils import trace
  t0 = time.perf_counter()
  runs = {}
  with concurrent.futures.ThreadPoolExecutor(len(PROFILE_RUNS)) as pool:
    for cap, window, flags in PROFILE_RUNS:
      tag = f'profile_step cull {cap} window {window}'
      code = ('from multinerf_tpu_torch import profile_step\n'
              f'profile_step.main({list(PROFILE_ARGV + flags)!r})')
      runs[tag] = (cap, window, flags, pool.submit(_run_counted, tag, code))
  launches = collections.Counter()
  for tag, (cap, window, flags, future) in runs.items():
    out, counted = future.result()
    log(out)
    result = json.loads(out.strip().splitlines()[-1])
    _keys(tag, result, PROFILE_KEYS)
    compact_n = None if cap is None else culling.round_capacity(K2_SAMPLES,
                                                                cap)
    if (result['capacity'] != cap or result['compact_n'] != compact_n or
        result['window'] != window or not result['kernels'] or
        not 0 < result['busy_ms'] <= result['wall_ms']):
      raise SystemExit(f'FAIL {tag}: {result}')
    if cap is not None and not (result['compaction_ms'] > 0 and
                                0 <= result['keep_frac'] <= 1):
      raise SystemExit(f'FAIL {tag}: compaction {result["compaction_ms"]} '
                       f'ms, keep {result["keep_frac"]}')
    span_ms = result['span_ms']
    if (trace.UNLINKED in span_ms or
        not span_ms.get('train/step', 0) > 0 or
        result['compaction_ms'] != span_ms.get(culling.COMPACTION)):
      raise SystemExit(f'FAIL {tag}: device ms by span {span_ms}, '
                       f'compaction {result["compaction_ms"]} ms')
    steps = window * sum(int(f.split('=')[1]) for f in flags
                         if f.startswith(('--warmup=', '--steps=')))
    plain = {k: v for k, v in counted['plain'].items() if v}
    want = {k: 2 * steps for k in ('density_mlp', 'featurize_dense',
                                   'density_mlp_bwd', 'featurize_dense_dw')}
    got = {k: v for k, v in counted['launches'].items() if v}
    if got != want or plain:
      raise SystemExit(f'FAIL {tag}: launches {got}, want {want}; plain '
                       f'calls {plain}')
    for name in ('featurize_dense', 'featurize_dense_dw'):
      by_n = counted['sizes'][name]
      if by_n != {compact_n or K2_SAMPLES: 2 * steps}:
        raise SystemExit(f'FAIL {tag}: {name} launches by N {by_n}')
    launches.update(got)
    log(f'{tag}: compact N {compact_n}, compaction '
        f'{result["compaction_ms"]} ms, keep {result["keep_frac"]} a step')
  log(f'profile cull ({card}): launches {dict(launches)}, '
      f'{time.perf_counter() - t0:.1f} s')
  return {'profile_cull': dict(launches)}


def phase_profile_kernels():
  """K2 and K4 against their plain versions at the compact N of the rungs
  0.5 and 0.67, which ``profile_step --cull=0.5`` / ``--cull=0.67`` launch
  and no other phase holds: {kernel: [summary]}."""
  from multinerf_tpu_torch.models import culling
  kernels = collections.defaultdict(list)
  for cap in PROFILE_HELD_RUNGS:
    n = culling.round_capacity(K2_SAMPLES, cap)
    for name, summary in _culled_k2_k4(n, f'culled {cap}').items():
      kernels[name].append(dict(summary, capacity=cap))
  return dict(kernels)


def phase_render_bench(card, device='cuda', bindings=()):
  """``multinerf_tpu_torch.render_bench`` with the bf16 and int8 arms,
  RENDER_BENCH_FRAMES frames each, on the checkpoint of a 20-step 360.gin
  run of the train entry point (bf16, dummy_unbounded).  Its own check
  (frame 0's replay within 1e-6) runs inside it; here: the keys, the step,
  the comparison, and the launches, counted around it: a 64 x 64 frame is
  one chunk, rendered once to warm up and once timed, 2 K1 and 2 K2 (bf16)
  or 1 K5 (int8) a frame.  Returns {'render_bench': launches}.  `device`
  and `bindings` let the phase be rehearsed on the CPU at small widths."""
  from multinerf_tpu_torch import render_bench
  from multinerf_tpu_torch import train
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as ckpt:
    train.main(_gin_argv(BF16_BINDINGS + (
        "Config.dataset_loader='dummy_unbounded'",
        f'Config.batch_size={TRAIN_RAYS}', 'Config.max_steps=20',
        'Config.print_every=10', f"Config.checkpoint_dir='{ckpt}'") +
                         tuple(bindings)) + [f'--device={device}'])
    _reset_counts()
    arms, comparison = render_bench.main(
        ['--checkpoint_dir', ckpt, '--frames', str(RENDER_BENCH_FRAMES),
         '--trunk_dtypes', 'bfloat16,int8'], device=device)
    launches, plain = _counts()
  frames = RENDER_BENCH_FRAMES + 1
  want = {'density_mlp': 4 * frames, 'featurize_dense': 2 * frames,
          'int8_trunk': frames}
  got = {k: v for k, v in launches.items() if v}
  if device == 'cuda' and (got != want or any(plain.values())):
    raise SystemExit(f'FAIL render_bench: launches {got}, want {want}; '
                     f'plain calls {plain}')
  for arm in arms:
    _keys(f'render_bench {arm["trunk_dtype"]}', arm, RENDER_BENCH_KEYS)
    if (arm['checkpoint_step'] != 20 or arm['frames'] != RENDER_BENCH_FRAMES
        or arm['device'] != card or not np.isfinite(arm['psnr'])):
      raise SystemExit(f'FAIL render_bench: {arm}')
    log(f'render_bench {arm["trunk_dtype"]} ({card}): '
        f'{arm["sec_per_frame"] * 1e3:.3f} ms a {arm["frame_hw"]} frame, '
        f'{arm["rays_per_sec"]:.0f} rays/s, PSNR {arm["psnr"]:.3f}')
  if set(comparison) != {'int8'}:
    raise SystemExit(f'FAIL render_bench: comparison {comparison}')
  log(f'render_bench ({card}): int8 {comparison["int8"]}; '
      f'{time.perf_counter() - t0:.1f} s')
  return {'render_bench': got}


def phase_stability(card, device='cuda', bindings=()):
  """``python -m multinerf_tpu_torch.stability_run`` cut short
  (STABILITY_BINDINGS after the script's own: STABILITY_STEPS steps in
  windows of 10 on the device plane, the ladder on), killed past step 110
  after checkpoint_100.pt, in a process of its own killed at
  STABILITY_TIMEOUT_S.  Its exit code says whether phase 1 was killed,
  phase 2 resumed at 101, the last checkpoint is there and eval wrote its
  metrics; the JSON is held to the same here.  `device` and `bindings`
  let the phase be rehearsed on the CPU at small widths."""
  t0 = time.perf_counter()
  kill_at, kill_past = STABILITY_KILL
  with tempfile.TemporaryDirectory() as ckpt:
    argv = [ckpt, f'--kill_at={kill_at}', f'--kill_past={kill_past}'] + [
        f'--gin_bindings={b}' for b in STABILITY_BINDINGS + tuple(bindings)]
    try:
      proc = subprocess.run(
          [sys.executable, '-c', 'from multinerf_tpu_torch import '
           f'stability_run; stability_run.main({argv!r}, device={device!r})'],
          cwd=REPO, capture_output=True, text=True,
          timeout=STABILITY_TIMEOUT_S, check=False)
    except subprocess.TimeoutExpired:
      raise SystemExit(f'FAIL stability: no end within {STABILITY_TIMEOUT_S}'
                       ' s') from None
    if proc.returncode:
      logs = ''
      for name in ('train_phase1', 'train_phase2', 'eval_final'):
        path = os.path.join(ckpt, f'{name}.log')
        if os.path.exists(path):
          with open(path) as f:
            logs += f'--- {name}\n{f.read()[-3000:]}'
      raise SystemExit(f'FAIL stability: rc {proc.returncode}\n'
                       f'{proc.stdout[-3000:]}{proc.stderr[-3000:]}{logs}')
    out = json.loads(proc.stdout.strip().splitlines()[-1])
  one, two = out['phase1'], out['phase2']
  if (not out['ok'] or not one['killed'] or two['init_step'] != kill_at + 1
      or one['last_logged_step'] < kill_past or
      two['last_logged_step'] != STABILITY_STEPS or out['device'] != card or
      set(out['metrics']) != {'psnr', 'ssim'}):
    raise SystemExit(f'FAIL stability: {out}')
  log(f'stability ({card}): phase 1 killed at step '
      f'{one["last_logged_step"]} in {one["seconds"]:.1f} s, phase 2 from '
      f'{two["init_step"]} in {two["seconds"]:.1f} s, losses '
      f'{out["losses"]}, eval PSNR {out["metrics"]["psnr"]}; '
      f'{time.perf_counter() - t0:.1f} s')


SOURCES = {
    'density_mlp': ('multinerf_tpu_torch/csrc/density_mlp.cu',
                    'multinerf_tpu/ops/pallas/density_mlp.py:65'),
    'featurize_dense': ('multinerf_tpu_torch/csrc/featurize_dense.cu',
                        'multinerf_tpu/ops/pallas/featurize_dense.py:117'),
    'density_mlp_bwd': ('multinerf_tpu_torch/csrc/density_mlp_bwd.cu',
                        'multinerf_tpu/ops/pallas/density_mlp.py:77'),
    'featurize_dense_dw': ('multinerf_tpu_torch/csrc/featurize_dense_dw.cu',
                           'multinerf_tpu/ops/pallas/featurize_dense.py:127'),
    'int8_trunk': ('multinerf_tpu_torch/csrc/int8_trunk.cu',
                   'multinerf_tpu/ops/pallas/int8_trunk.py:159'),
    'int8_trunk_bwd': ('multinerf_tpu_torch/csrc/int8_trunk_bwd.cu',
                       'multinerf_tpu/ops/pallas/int8_trunk.py:168'),
}


def main():
  t0 = time.perf_counter()
  card = phase_device()
  phase_build()
  results = phase_kernels()
  results.update(phase_backward_kernels())
  results.update(phase_int8_kernels())
  paths = {'render': phase_main_path()}
  phase_reference()
  paths['train'], host_step_s, _ = phase_train()
  phase_train_reference()
  paths['train_driver'] = phase_train_driver(card, host_step_s)
  paths['render_bfloat16'] = phase_main_path('render bfloat16', BF16_BINDINGS,
                                             F32_RENDER)
  paths['train_bfloat16'] = phase_train('train bfloat16', BF16_BINDINGS,
                                        BF16_STEPS, F32_TRAIN)[0]
  phase_train_reference('train reference bfloat16', BF16_BINDINGS)
  for mode in INT8_MODES:
    paths[f'render_{mode}'] = phase_main_path(
        f'render {mode}', int8_bindings(mode), INT8_RENDER)
  phase_reference('reference int8', int8_bindings('int8'),
                  INT8_REFERENCE_BOUNDS)
  for mode, steps in zip(INT8_MODES, (TRAIN_STEPS, HYBRID_STEPS)):
    paths[f'train_{mode}'] = phase_train(f'train {mode}',
                                         int8_bindings(mode), steps,
                                         INT8_TRAIN)[0]
  phase_train_reference('train reference int8', int8_bindings('int8'),
                        INT8_TRAIN_GAP_CAP, INT8_LOSS_TOL)
  paths['refnerf'] = phase_refnerf(card)
  paths.update(phase_capture_360(card))
  llff, more = phase_capture_llff(card)
  paths.update(more)
  for name, summary in llff.items():
    results[name]['llff_256'] = summary
  raw_kernels, more = phase_rawnerf(card)
  paths.update(more)
  for name, summary in raw_kernels.items():
    results[name]['llff_raw'] = summary
  paths.update(phase_robustnerf(card))
  paths.update(phase_glo(card))
  more, cull_kernels = phase_culling(card)
  paths.update(more)
  for name, summary in cull_kernels.items():
    results[name]['cull_0.33'] = summary
  paths.update(phase_scan(card))
  for name, summary in phase_512_kernels().items():
    results[name]['512'] = summary
  paths.update(phase_blender_512(card))
  paths.update(phase_llff_512(card))
  paths.update(phase_pano(card))
  paths.update(phase_render_many(card))
  paths.update(phase_refnerf_int8(card))
  for key, summaries in phase_short_kernels().items():
    for name, summary in summaries.items():
      results[name][key] = summary
  paths.update(phase_blender_256(card))
  paths.update(phase_debug(card))
  paths.update(phase_ddp(card))
  for name, summary in phase_tp_kernels().items():
    results[name]['tp_512'] = summary
  paths.update(phase_tp(card))
  more, cull_render = phase_cull_render(card)
  paths.update(more)
  for name, summaries in cull_render.items():
    results[name]['render_cull'] = summaries
  phase_harnesses(card)
  # The stability run's processes and profile_step's run beside each
  # other; the kernels are timed once both are done.
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    stability = pool.submit(phase_stability, card)
    paths.update(phase_profile_cull(card))
    stability.result()
  for name, summaries in phase_profile_kernels().items():
    results[name]['profile_cull'] = summaries
  paths.update(phase_render_bench(card))
  bounds = kernel_bounds()
  chunk = bounds.pop('int8_trunk_render_chunk')
  results['int8_trunk']['render_chunk'].update(
      _achieved(results['int8_trunk']['render_chunk'], chunk),
      **{k: v for k, v in chunk.items() if k != 'ops'})
  hybrid = bounds.pop('int8_trunk_bwd_hybrid')
  results['int8_trunk_bwd'].update(_achieved(results['int8_trunk_bwd'],
                                             hybrid, '_hybrid'))
  results['int8_trunk_bwd'].update(
      {f'{k}_hybrid': v for k, v in hybrid.items() if k != 'ops'})
  kernels = []
  for name, (source, replaces) in SOURCES.items():
    # Each path's launches, counted from 0 around that path's run.
    by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
    bound = bounds[name]
    # No single PyTorch call computes any of these functions: each fuses
    # the featurization with its products.
    kernels.append(dict(name=name, route='cuda', source=source,
                        replaces=replaces, launches=sum(by_path.values()),
                        launches_by_path=by_path, **results[name],
                        bound_ms=bound['bound_ms'],
                        bound_by=bound['bound_by'],
                        **_achieved(results[name], bound), library_ms=None))
  log(f'total {time.perf_counter() - t0:.1f} s')
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
