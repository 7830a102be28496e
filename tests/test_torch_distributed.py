"""The port's data parallelism (``multinerf_tpu_torch/parallel/mesh.py``) on
the CPU: 2-rank gloo clusters started by ``python -m torch.distributed.run``
run ``tests/helpers/torch_dist_worker.py``, which imports only the port, and
this process holds them against the same code with no process group: one
process on the global batch.

Every cluster runs once per module, in one fixture (``runs``): the worker
at 2 ranks (``steps``: 3 steps of each case at 32 rays a rank, at the test
widths of tests/helpers/torch_parity.py with ``Config.randomized = False``,
then the renderers; ``ckpt``: 3 steps saved; ``drivers``: ``train.main``
on the device plane and in the window, ``eval.main``, ``render.main``),
the worker at 1 rank (``steps``), and the train entry point at 2 ranks on
the host path, all three at once while this process runs the one-process
references and the JAX package's step on the same global batch and
weights; then a new 2-rank cluster restores the ``ckpt`` checkpoint (save
-> kill -> restore) while eval and render run here at one rank.

Tolerances, and why:
* losses at rtol 1e-5: the ranks' shares sum in another order than one
  process's sums, and Adam carries those last bits into the next steps;
  but steps 2-3 of the int8 trunk at 1e-4, set between the readings of the
  sound steps and of a control with a rank's gradient dropped, which a
  test shows the bounds catch (1e-5 catches it in the f32 case too);
* gradients by ``train_lib.leaf_gaps`` against the one-process step (the
  reference's own move under a 1e-6 nudge of its ray origins bounds each
  leaf); against JAX the same rule the single-device parity tests use;
* the ranks' parameters, the occupancy grid and the RobustNeRF threshold
  bitwise equal across ranks: every rank applies the same all-reduced
  values;
* frames at 2 ranks against 1 rank: at least 99% of the values bitwise
  equal (a ray's computation is the same, in a row block of another size,
  so a row out of place would show everywhere), the rest within rtol 1e-3
  and atol 1e-4: the plain versions' products in another block size move
  a few f32 values across a bf16 rounding boundary of a feature or an
  activation (measured: up to 1.7e-4 relative in rgb, 8e-4 in the 95th
  distance percentile);
* world size 1 under the launcher bitwise equal to no process group.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_dist_worker as worker  # noqa: E402
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu.parallel import mesh as jmesh  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import ddp_probe  # noqa: E402
from multinerf_tpu_torch import eval as eval_lib  # noqa: E402
from multinerf_tpu_torch import render  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import culling  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.parallel import mesh  # noqa: E402

WORKER = os.path.join(tp.REPO, 'tests', 'helpers', 'torch_dist_worker.py')
CLUSTER_TIMEOUT = 300
LOSS_RTOL = 1e-5
# Steps 2-3 of the int8 case: its quantization carries step 1's last bits
# further.  Readings (these widths and batch): 1.6e-5 and 2.9e-5 at 2
# ranks; 3.2e-4 and 1.7e-4 with rank 1's gradient dropped.  The bound sits
# between them, and the control test shows it sees the dropped rank.
INT8_LATER_LOSS_RTOL = 1e-4
FRAME_RTOL, FRAME_ATOL, FRAME_BITWISE = 1e-3, 1e-4, 0.99

BASE = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 64',
    'Config.randomized = False')
CASES = {
    '360': BASE,
    # A 0/1 lossmult per ray, a quarter of rank 0's rays and three quarters
    # of rank 1's: a mean of the ranks' ratios weights their rays apart.
    'lossmult': BASE,
    # llff_raw.gin's loss: RawNeRF's Bayer mask as lossmult, per channel.
    'raw': BASE + ('Config.apply_bayer_mask = True',
                   "Config.data_loss_type = 'rawnerf'"),
    # The int8 trunk (K5/K6's plain versions here): its quantization scales
    # are per sample and per weight, so no global value enters it.
    'int8': BASE + ("NerfMLP.trunk_dtype = 'int8'",
                    "PropMLP.trunk_dtype = 'int8'"),
    # 360_robustnerf.gin's loss on 4 patches of 4 x 4 (2 a rank).
    'robust': BASE + ("Config.data_loss_type = 'robustnerf'",
                      'Config.enable_robustnerf_loss = True',
                      'Config.robustnerf_inlier_quantile = 0.8',
                      'Config.patch_size = 4',
                      'Config.robustnerf_inner_patch_size = 2'),
    # Culling forced at step 2 (nothing clears the threshold, so the gate
    # engages its rung at the first refresh).  32 samples divide a rank's
    # 32 rays, the rung's capacity halves with the rays and no sample is
    # kept (no opaque background, whose last samples are always kept), so
    # each rank compacts the samples the global compaction would.
    'cull': BASE + ('Model.num_nerf_samples = 32',
                    'Model.opaque_background = False',
                    'Config.occupancy_culling = True',
                    'Config.occupancy_threshold = 1000.0',
                    'Config.occupancy_capacity_ladder = (0.5,)',
                    'Config.occupancy_warmup_steps = 1',
                    'Config.occupancy_grid_refresh_every = 1',
                    'Config.occupancy_grid_resolution = 16'),
}
JAX_CASES = ('360', 'raw')
# Cases run again at 2 ranks with rank 1's share of the gradient dropped
# (ddp_probe.drop_gradient): the loss bounds of steps 2-3 must catch them.
CONTROLS = ('360', 'int8')
RENDER_BINDINGS = tp.SMALL_BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'",
    'Config.render_chunk_size = 500', 'Config.vis_num_rays = 300')

# train.main: 4 steps of 32 rays, printing at steps 1, 2 and 4, saving at
# 1, 2 and 4 (the window of 2: at 2 and 4).
DRIVER = tp.SMALL_BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 32',
    'Config.max_steps = 4', 'Config.print_every = 2',
    'Config.checkpoint_every = 2', 'Config.render_chunk_size = 500')
# Eval of 2 test views, render of one (frame 0 of 48 jobs).
EVAL = DRIVER + ('Config.eval_dataset_limit = 2',
                 'Config.render_num_jobs = 48')


def _flags(bindings):
  return ['--device=cpu', f'--gin_configs={tp.CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in bindings]


def _launch(nproc, args, module=False):
  """Start `nproc` ranks under torch.distributed.run on the CPU."""
  return ddp_probe.Launch(nproc, ['-m'] + list(args) if module else
                          [WORKER] + list(args), threads=1)


def _wait(launch, timeout=CLUSTER_TIMEOUT):
  """(return code, output) of a launched cluster; at the time limit its
  whole process group is killed and the return code is None."""
  try:
    return 0, launch.wait(timeout)
  except ddp_probe.LaunchError as e:
    return e.returncode, e.output


def _succeeded(what, done):
  """The output of a cluster `_wait` returned, which must have succeeded."""
  rc, out = done
  if rc is None:
    pytest.fail(f'{what} hung past {CLUSTER_TIMEOUT} s:\n{out[-4000:]}')
  assert rc == 0, f'{what} failed:\n{out[-6000:]}'
  return out


def _results(out_dir, scenario, nproc):
  return [torch.load(os.path.join(out_dir, f'{scenario}_rank{r}.pt'),
                     weights_only=False) for r in range(nproc)]


def _global_batch(name):
  config = worker.load_config(CASES[name])
  with datasets.load_dataset('train', None, config, seed=3) as dataset:
    batch = train_lib.batch_to_device(next(dataset), 'cpu')
  if name == 'lossmult':
    rng = np.random.RandomState(7)
    p = np.repeat([0.25, 0.75], 32)[:, None]
    batch.rays.lossmult = torch.as_tensor(
        (rng.rand(64, 1) < p).astype(np.float32))
  return batch


def _write_spec(out_dir, batches):
  os.makedirs(out_dir, exist_ok=True)
  ckpt_dir = lambda name: f"Config.checkpoint_dir = '{out_dir}/{name}'"
  spec = {'cases': [{'name': k, 'bindings': list(v)}
                    for k, v in CASES.items()],
          'controls': [{'name': f'{k}_drop', 'batch': k,
                        'bindings': list(CASES[k]), 'drop_rank': 1}
                       for k in CONTROLS],
          'ckpt_case': {'name': '360', 'bindings': list(CASES['360'])},
          'render_bindings': list(RENDER_BINDINGS),
          'train': {'device_plane': DRIVER + (
              'Config.device_data_plane = True', ckpt_dir('device_plane')),
                    'window': DRIVER + (
                        'Config.device_data_plane = True',
                        'Config.steps_per_jit_call = 2', ckpt_dir('window'))},
          'eval': EVAL + (ckpt_dir('device_plane'),),
          'render': EVAL + (ckpt_dir('device_plane'),)}
  with open(os.path.join(out_dir, 'cases.json'), 'w') as f:
    json.dump(spec, f)
  for name, batch in batches.items():
    torch.save(batch, os.path.join(out_dir, f'batch_{name}.pt'))


def _jax_batch(batch):
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      rgb=jnp.asarray(batch.rgb.numpy()))


def _jax_grads(name, batch):
  """JAX's raw gradient of one step on `batch` and on its nudged copy, from
  the port's seed-0 weights (create_train_step(jit=False) under jax.jit,
  on the 8 virtual CPU devices)."""
  jax_config, torch_config = tp.configs(CASES[name])
  model = train_lib.setup_model(torch_config, 0, 'cpu')[0]
  params = jax.tree_util.tree_map(jnp.asarray, bridge.jax_params(model))
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      jmesh.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients

  def run(state, b):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), state, b, worker.TRAIN_FRAC,
                         1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats['loss'], captured['grad']

  run = jax.jit(run)
  out = []
  for b in (batch, train_lib.nudge_origins(batch)):
    loss, grads = jax.device_get(run(jstate, _jax_batch(b)))
    out.append({'loss': float(loss), 'grads': bridge.flatten(grads)})
  return out


def _one_process_ckpt_losses(batch):
  """One process's 2 * NUM_STEPS uninterrupted steps on the global batch."""
  config = worker.load_config(CASES['360'])
  _, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  losses = []
  for _ in range(2 * worker.NUM_STEPS):
    state, stats = train_step(None, state, batch, worker.TRAIN_FRAC, False)
    losses.append(float(stats['loss']))
  return losses


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """Every cluster of the module, and what this process holds them against.

  Three launches at once: the worker at 2 ranks (``steps``, the first
  phase of ``ckpt``, ``drivers``), at 1 rank (``steps``), and the train
  entry point at 2 ranks on the host path.  Meanwhile this process runs the
  one-process references and JAX's step.  Then a new 2-rank cluster
  restores the first phase's checkpoint (``ckpt``), while eval and render
  run here at one rank on a copy of the device plane's checkpoint."""
  root = tmp_path_factory.mktemp('dist')
  batches = {name: _global_batch(name) for name in CASES}
  dirs = {n: str(root / f'ws{n}') for n in (1, 2)}
  for d in dirs.values():
    _write_spec(d, batches)
  host_run = str(root / 'host_run')
  procs = {
      '2-rank worker': _launch(2, ['steps,ckpt,drivers', dirs[2]]),
      '1-rank worker': _launch(1, ['steps', dirs[1]]),
      'train entry point': _launch(
          2, ['multinerf_tpu_torch.train'] + _flags(DRIVER + (
              'Config.train_render_every = 4',
              f"Config.checkpoint_dir = '{host_run}'")), module=True)}
  try:
    ref = {name: worker.run_case({'bindings': CASES[name]}, b)
           for name, b in batches.items()}
    ref['frames'] = worker.render_frames(RENDER_BINDINGS)
    ref_nudged = {name: worker.run_case({'bindings': CASES[name]},
                                        train_lib.nudge_origins(b))
                  for name, b in batches.items() if name != 'robust'}
    want_jax = {name: _jax_grads(name, batches[name]) for name in JAX_CASES}
    ckpt_losses = _one_process_ckpt_losses(batches['360'])
  finally:
    done = {what: _wait(p) for what, p in procs.items()}
  outs = {what: _succeeded(what, d) for what, d in done.items()}
  out = {'two': _results(dirs[2], 'steps', 2),
         'one_rank': _results(dirs[1], 'steps', 1)[0],
         'ref': ref, 'ref_nudged': ref_nudged, 'jax': want_jax,
         'batches': batches, 'host_run': host_run,
         'launcher_out': outs['train entry point'], 'dir': dirs[2],
         'drivers': _results(dirs[2], 'drivers', 2),
         'ckpt': [_results(dirs[2], 'ckpt', 2)], 'ckpt_losses': ckpt_losses}

  restore = _launch(2, ['ckpt', dirs[2]])
  try:
    one_rank = str(root / 'one_rank')
    shutil.copytree(os.path.join(dirs[2], 'device_plane'), one_rank,
                    ignore=lambda _, names: [n for n in names if not
                                             n.startswith('checkpoint_')])
    out['eval_one'] = eval_lib.main(_flags(EVAL + (
        f"Config.checkpoint_dir = '{one_rank}'",)))
    out['render_one'] = render.main(_flags(EVAL + (
        f"Config.checkpoint_dir = '{one_rank}'",)))['renderings']
    out['one_rank_dir'] = one_rank
  finally:
    done = _wait(restore)
  _succeeded('restoring cluster', done)
  out['ckpt'].append(_results(dirs[2], 'ckpt', 2))
  return out


def _assert_within_gaps(got, want, want_nudged, what):
  assert set(got) == set(want)
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      got, want, want_nudged).items():
    assert gap <= bound, (f'{what} {name}: relative L2 gap {gap:.3e} > '
                          f'{bound:.3e} (reference moved {sens:.3e})')


def _failing_leaves(got, want, want_nudged):
  return [name for name, (gap, _, bound) in train_lib.leaf_gaps(
      got, want, want_nudged).items() if gap > bound]


def _later_bound(name):
  """The bound on steps 2-3's relative loss gaps of case `name`."""
  return INT8_LATER_LOSS_RTOL if name == 'int8' else LOSS_RTOL


@pytest.mark.parametrize('name', ['360', 'lossmult', 'raw', 'int8', 'cull'])
def test_two_rank_step_is_the_one_process_global_batch_step(runs, name):
  ref, ref_nudged = runs['ref'][name], runs['ref_nudged'][name]
  want = np.array(ref['losses'])
  bound = np.full_like(want, _later_bound(name))
  bound[0] = LOSS_RTOL
  for rank, got in enumerate(runs['two']):
    gap = np.abs(np.array(got[name]['losses']) / want - 1)
    assert np.all(gap <= bound), (rank, gap, bound)
    _assert_within_gaps(got[name]['grads1'], ref['grads1'],
                        ref_nudged['grads1'], f'rank {rank} gradient')
    for key in ('losses/data', 'mses', 'psnrs'):
      np.testing.assert_allclose(got[name]['stats'][0][key],
                                 ref['stats'][0][key], rtol=LOSS_RTOL,
                                 err_msg=key)


@pytest.mark.parametrize('name', CONTROLS)
def test_later_loss_bounds_catch_a_dropped_rank_gradient(runs, name):
  """The same 2-rank steps with rank 1's share of the gradient zeroed
  before the all-reduce: step 1's loss is unchanged, and a later step's
  misses the bound that the sound steps keep."""
  want = np.array(runs['ref'][name]['losses'])
  for rank, got in enumerate(runs['two']):
    gap = np.abs(np.array(got[f'{name}_drop']['losses']) / want - 1)
    assert gap[0] <= LOSS_RTOL
    assert np.any(gap[1:] > _later_bound(name)), gap


@pytest.mark.parametrize('name', list(CASES))
def test_ranks_hold_bitwise_equal_parameters_and_stats(runs, name):
  first, second = (r[name] for r in runs['two'])
  assert first['params'].keys() == second['params'].keys()
  for key, value in first['params'].items():
    np.testing.assert_array_equal(value, second['params'][key], err_msg=key)
  for key, value in first['stats'][-1].items():
    np.testing.assert_array_equal(value, second['stats'][-1][key],
                                  err_msg=key)


def test_a_mean_of_local_ratios_fails_where_the_global_denominator_holds(
    runs):
  """Naive DDP: each rank's own ratio of sums, then the mean over the
  ranks.  With lossmult 1/4 ones on rank 0 and 3/4 on rank 1 it weights the
  ranks' rays apart: its loss and gradients miss the one-process step that
  the cluster's holds."""
  batch = runs['batches']['lossmult']
  ref, ref_nudged = runs['ref']['lossmult'], runs['ref_nudged']['lossmult']
  config = worker.load_config(CASES['lossmult'])
  model = train_lib.setup_model(config, 0, 'cpu')[0]
  losses, grads = [], []
  for half in (slice(0, 32), slice(32, 64)):
    rays = type(batch.rays)(**{
        f: None if getattr(batch.rays, f) is None else
        getattr(batch.rays, f)[half] for f in batch.rays.__dataclass_fields__})
    loss, _, _, g = train_lib.loss_and_grads(
        model, config, type(batch)(rays=rays, rgb=batch.rgb[half]),
        worker.TRAIN_FRAC)
    losses.append(float(loss))
    grads.append({k: v.clone() for k, v in g.items()})
    model.zero_grad(set_to_none=True)
  naive = {k: ((grads[0][k] + grads[1][k]) / 2).numpy() for k in grads[0]}
  assert abs(np.mean(losses) / ref['losses'][0] - 1) > 100 * LOSS_RTOL
  assert _failing_leaves(naive, ref['grads1'], ref_nudged['grads1'])
  assert not _failing_leaves(runs['two'][0]['lossmult']['grads1'],
                             ref['grads1'], ref_nudged['grads1'])


def test_robustnerf_threshold_is_the_global_batch_quantile(runs):
  ref = runs['ref']['robust']
  first, second = (r['robust'] for r in runs['two'])
  assert first['thresholds'] == second['thresholds']
  np.testing.assert_allclose(first['thresholds'], ref['thresholds'],
                             rtol=LOSS_RTOL)
  np.testing.assert_allclose(first['losses'], ref['losses'], rtol=LOSS_RTOL)
  np.testing.assert_allclose(first['stats'][0]['loss_threshold'],
                             ref['stats'][0]['loss_threshold'],
                             rtol=LOSS_RTOL)


def test_culled_grid_keep_fraction_and_rung_match_one_process(runs):
  ref = runs['ref']['cull']
  first, second = (r['cull'] for r in runs['two'])
  assert ref['rungs'] == {2: 0.5, 3: 0.5}
  for got in (first, second):
    assert got['rungs'] == ref['rungs']
    assert got['keep_fracs'] == ref['keep_fracs'] == {1: 0.0, 2: 0.0,
                                                      3: 0.0}
    for g, w in zip(got['grids'], ref['grids']):
      np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-6)
  for g0, g1 in zip(first['grids'], second['grids']):
    np.testing.assert_array_equal(g0, g1)


def _evaluated(keep, frac):
  """The flat samples a compaction of `keep` [b, s] evaluates."""
  b, s = keep.shape
  slot, _ = culling.compact_slots(torch.as_tensor(keep),
                                  culling.round_capacity(b * s, frac))
  return set(np.flatnonzero(slot.numpy() < culling.round_capacity(b * s,
                                                                  frac)))


def _per_rank_evaluated(keep, frac, world=2):
  b, s = keep.shape
  rows = b // world
  out = set()
  for r in range(world):
    out |= {r * rows * s + i
            for i in _evaluated(keep[r * rows:(r + 1) * rows], frac)}
  return out


def test_per_rank_compaction_drops_a_ranks_overflow():
  """Each rank compacts its own samples at round_capacity(its samples).
  With nothing kept (the cull case above) it evaluates what the global
  compaction does.  Otherwise its refill of the spare slots is its own
  (the opaque background's last samples, always kept, shift it), and when
  one rank keeps more than its capacity it drops its own kept samples past
  it, in its interleaved order, though the global capacity would hold
  them: the known difference of ROADMAP.md, Queue 3."""
  b, s, frac = 64, 32, 0.5
  none = np.zeros((b, s), bool)
  assert _per_rank_evaluated(none, frac) == _evaluated(none, frac)
  last = none.copy()
  last[:, -1] = True
  per_rank, whole = _per_rank_evaluated(last, frac), _evaluated(last, frac)
  assert len(per_rank) == len(whole) and per_rank != whole
  assert set(np.flatnonzero(last.reshape(-1))) <= per_rank & whole

  rng = np.random.RandomState(0)
  keep = np.concatenate([rng.rand(b // 2, s) < 0.6,
                         rng.rand(b // 2, s) < 0.1])
  kept = set(np.flatnonzero(keep.reshape(-1)))
  cap_rank = culling.round_capacity(b // 2 * s, frac)
  assert len(kept) < culling.round_capacity(b * s, frac)
  assert kept <= _evaluated(keep, frac)  # Globally, nothing kept drops.
  per_rank = _per_rank_evaluated(keep, frac)
  dropped = kept - per_rank
  rank0_kept = int(keep[:b // 2].sum())
  assert len(dropped) == rank0_kept - cap_rank > 0
  assert all(i < b // 2 * s for i in dropped)  # Only the rank that overflows.
  # Rank 0 keeps the first cap_rank of its kept samples in its own
  # interleaved order.
  perm, _ = culling.interleave_perm(b // 2, s)
  order = [i for i in perm if keep[:b // 2].reshape(-1)[i]]
  assert set(order[cap_rank:]) == dropped


def _assert_same_frame(got, want, what):
  """`got` holds `want`'s rendering: the frame bounds of the docstring."""
  assert got.keys() == want.keys(), what
  for key, value in want.items():
    pairs = zip(got[key], value) if isinstance(value, list) else [
        (got[key], value)]  # A ray bundle has one array per level.
    for g, w in pairs:
      tp.assert_close(g, w, atol=FRAME_ATOL, rtol=FRAME_RTOL,
                      what=f'{what} {key}')
      assert np.mean(np.asarray(g) == np.asarray(w)) >= FRAME_BITWISE, (
          what, key)


@pytest.mark.parametrize('frame', ['device', 'many', 'host', 'pano'])
def test_renderers_at_two_ranks_give_the_one_rank_frame(runs, frame):
  for rank, got in enumerate(runs['two']):
    _assert_same_frame(got['frames'][frame], runs['ref']['frames'][frame],
                       f'rank {rank} {frame}')
  first, second = (r['frames'][frame] for r in runs['two'])
  for key, value in first.items():  # Every rank holds the whole frame.
    for g, w in (zip(value, second[key]) if isinstance(value, list) else
                 [(value, second[key])]):
      np.testing.assert_array_equal(g, w, err_msg=key)


def test_world_size_one_under_the_launcher_is_bitwise_no_process_group(
    runs):
  got, want = runs['one_rank'], runs['ref']

  def equal(g, w, where):
    if isinstance(w, dict):
      assert g.keys() == w.keys(), where
      for k in w:
        equal(g[k], w[k], f'{where}/{k}')
    elif isinstance(w, (list, tuple)):
      assert len(g) == len(w), where
      for i, (gi, wi) in enumerate(zip(g, w)):
        equal(gi, wi, f'{where}[{i}]')
    else:
      np.testing.assert_array_equal(g, w, err_msg=where)

  equal(got, want, 'steps')


@pytest.mark.parametrize('name', JAX_CASES)
def test_two_rank_step_matches_jax_global_batch_step(runs, name):
  want, want_nudged = runs['jax'][name]
  got = runs['two'][0][name]
  assert got['losses'][0] == pytest.approx(want['loss'], rel=1e-3)
  _assert_within_gaps(got['grads1'], want['grads'], want_nudged['grads'],
                      'gradient vs JAX')


def test_checkpoint_save_kill_restore_continues_one_process_trajectory(
    runs):
  (first, second), want = runs['ckpt'], runs['ckpt_losses']
  assert sorted(os.listdir(os.path.join(runs['dir'], 'ckpt'))) == [
      'checkpoint_3.pt', 'checkpoint_6.pt']
  for rank in range(2):
    assert first[rank]['start_step'] == 0
    assert second[rank]['start_step'] == 3
    np.testing.assert_allclose(
        first[rank]['losses'] + second[rank]['losses'], want, rtol=1e-4)
  for key, value in second[0]['params'].items():
    np.testing.assert_array_equal(value, second[1]['params'][key])


def test_launched_train_entry_point_writes_and_prints_once(runs):
  host_run, out = runs['host_run'], runs['launcher_out']
  files = sorted(os.listdir(host_run))
  assert [f for f in files if f.startswith('checkpoint_')] == [
      'checkpoint_1.pt', 'checkpoint_2.pt', 'checkpoint_4.pt']
  assert 'config.gin' in files
  assert len([f for f in files if f.startswith('events.')]) == 1
  assert out.count('Number of parameters being optimized') == 1
  assert out.count('/4: loss=') == 3  # Steps 1, 2 and 4, from rank 0.
  assert out.count('Eval 4:') == 1  # The in-train render, logged once.


@pytest.mark.parametrize('run,saves', [('device_plane', (1, 2, 4)),
                                       ('window', (2, 4))])
def test_only_rank_zero_writes_checkpoints_config_and_events(runs, run,
                                                             saves):
  first, second = (r[run] for r in runs['drivers'])
  run_dir = os.path.join(runs['dir'], run)
  assert second['writes'] == []
  mine = [os.path.basename(p) for p in first['writes']
          if p.startswith(run_dir + os.sep)]
  assert 'config.gin' in mine
  assert any(p.startswith('events.') and p.endswith(str(first['pid']))
             for p in mine)
  assert {f'checkpoint_{s}.pt.tmp' for s in saves} <= set(mine)
  assert sorted(f for f in os.listdir(run_dir)
                if f.startswith('checkpoint_')) == [
                    f'checkpoint_{s}.pt' for s in saves]
  for rank in (first, second):
    assert len(rank['losses']) == len(rank['per_step']) == 4
    assert np.all(np.isfinite(rank['losses']))
    # On the CPU every step takes the kernels' plain versions.
    assert all(n > 0 for n in rank['plain'].values() if n) and (
        rank['plain']['density_mlp_bwd'] >= 4)
  # Each rank's loss is the global batch's: the same number on both.
  assert first['losses'] == second['losses']


def test_eval_and_render_at_two_ranks_give_the_one_rank_frames(runs):
  first, second = runs['drivers']
  run_dir = os.path.join(runs['dir'], 'device_plane')
  assert second['eval']['writes'] == second['render_writes'] == []
  step = 4
  got, want = first['eval']['metrics'][step], runs['eval_one'][step]
  for group in ('eval_metrics', 'eval_metrics_cc'):
    assert len(got[group]) == len(want[group]) == 2
    for g, w in zip(got[group], want[group]):
      assert g.keys() == w.keys()
      for k in w:
        # Metrics of quantized frames: a u8 step moves the psnr by ~1e-5.
        assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
  assert second['eval']['metrics'][step]['eval_metrics'] == []
  for name in ('metric_psnr_4.txt', 'acc_000.tiff', 'color_001.png'):
    assert os.path.exists(os.path.join(run_dir, 'test_preds', name)), name
  assert sorted(first['render']) == sorted(runs['render_one']) == [0]
  for rank in (first, second):
    for idx, rendering in runs['render_one'].items():
      _assert_same_frame(rank['render'][idx], rendering, f'frame {idx}')
  out_name = 'test_preds_step_4'
  assert sorted(os.listdir(os.path.join(run_dir, 'render', out_name))) == (
      sorted(os.listdir(os.path.join(runs['one_rank_dir'], 'render',
                                     out_name))))


def test_a_rank_that_raises_ends_the_run(tmp_path):
  rc, out = _wait(_launch(2, ['raise', str(tmp_path)]), timeout=120)
  assert rc is not None, 'the rank left waiting did not end'
  assert rc != 0
  assert 'rank 1 fails before the all-reduce' in out
  assert not os.path.exists(tmp_path / 'raise_rank0.pt')


# --- The helpers with no process group, and the plans. ----------------------


def test_helpers_are_the_identity_with_no_process_group():
  assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
  t = torch.arange(6.0).reshape(3, 2)
  for fn in (mesh.all_reduce_sum, mesh.all_reduce_max, mesh.all_gather_rows):
    assert fn(t) is t
  assert mesh.main_value(5) == 5
  assert mesh.all_reduce_sum_dict({'a': t})['a'] is t
  mesh.barrier()
  mesh.assert_replicated({'a': t})
  assert mesh.process_local_slice(4096) == 4096


def test_process_local_slice_and_local_device(monkeypatch):
  monkeypatch.setattr(mesh, 'world_size', lambda: 3)
  assert mesh.process_local_slice(3 * 1365) == 1365
  with pytest.raises(ValueError, match='batch size 4096 not divisible by 3'):
    mesh.process_local_slice(4096)
  monkeypatch.delenv('LOCAL_RANK', raising=False)
  assert mesh.local_device('cuda') == torch.device('cuda')
  assert mesh.local_device('cpu') == torch.device('cpu')
  monkeypatch.setenv('LOCAL_RANK', '1')
  assert mesh.local_device('cuda:0') == torch.device('cuda', 0)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
  with pytest.raises(RuntimeError, match='LOCAL_RANK 1 has no card'):
    mesh.local_device('cuda')


@pytest.mark.parametrize('world', [1, 2, 8])
def test_chunk_plans_divide_by_the_world_size_as_jax(monkeypatch, world):
  monkeypatch.setattr(mesh, 'world_size', lambda: world)
  monkeypatch.setattr(jax, 'device_count', lambda: world)
  config = worker.load_config(RENDER_BINDINGS)
  for num_rays in (1, 7, 500, 2304, 2305):
    for chunk in (1, 3, 500, 4096):
      config.render_chunk_size = chunk
      got = nerf._plan_chunks(config, num_rays)  # pylint: disable=protected-access
      assert got == jnerf._plan_chunks(config, num_rays), (num_rays, chunk)  # pylint: disable=protected-access
      assert got[0] % world == 0


def test_ddp_probe_step_part_takes_the_train_steps(tmp_path):
  """ddp_probe's 'step' part with no process group: step 1's loss and
  gradient are train_lib.loss_and_grads' on the batch it draws."""
  argv = [f'--gin_configs={tp.CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in BASE]
  spec = {'device': 'cpu', 'parts': [
      {'name': 'parity', 'kind': 'step', 'argv': argv, 'rays': 64,
       'steps': 2, 'seed': 4}]}
  spec_path = tmp_path / 'spec.json'
  spec_path.write_text(json.dumps(spec))
  ddp_probe.main([str(spec_path), str(tmp_path)])
  got = torch.load(tmp_path / 'parity_rank0.pt', weights_only=False)
  assert got['world_size'] == 1 and got['replicated']
  assert len(got['losses']) == 2 and np.all(np.isfinite(got['losses']))
  config = worker.load_config(BASE)
  model = train_lib.setup_model(config, 0, 'cpu')[0]
  batch = ddp_probe.global_batch_rows(config, 'cpu', 64, 4)
  loss, _, _, grads = train_lib.loss_and_grads(model, config, batch,
                                               0.0)  # Step 1's train_frac.
  assert got['losses'][0] == float(loss)
  for k, v in grads.items():
    np.testing.assert_array_equal(got['grads1'][k], v.numpy(), err_msg=k)


def test_hold_parity_needs_sound_later_steps_and_the_control_caught():
  """ddp_probe.hold_parity on made-up results: a run within the bounds,
  whose control misses the later bound, holds; a later step over its
  bound, a control inside it, a gradient leaf off or ranks apart fail."""
  rng = np.random.RandomState(0)
  grads = {'a': rng.randn(8), 'b': rng.randn(3, 4)}
  ref = {'losses': [1.0, 0.9, 0.8], 'grads1': grads}
  ref_nudged = {'losses': ref['losses'],
                'grads1': {k: v * (1 + 1e-3) for k, v in grads.items()}}

  def ranks(step2, grads1=grads, replicated=True):
    return [{'losses': [1.0, 0.9 * (1 + step2), 0.8], 'grads1': grads1,
             'replicated': replicated}] * 2

  hold = lambda got, control: ddp_probe.hold_parity(
      got, ref, ref_nudged, 0.15, 4e-4, control)
  held = hold(ranks(1e-4), ranks(1e-2))
  assert held['ok'] and held['control_caught']
  np.testing.assert_allclose(held['loss_gaps'], [0, 1e-4, 0], atol=1e-12)
  assert held['loss_bounds'] == [ddp_probe.LOSS_RTOL, 4e-4, 4e-4]
  assert not hold(ranks(1e-3), ranks(1e-2))['ok']
  assert not hold(ranks(1e-4), ranks(1e-4))['control_caught']
  assert not hold(ranks(1e-4), ranks(1e-4))['ok']
  off = {k: v * 1.5 for k, v in grads.items()}
  assert hold(ranks(1e-4, off), ranks(1e-2))['leaves_over'] == ['a', 'b']
  assert not hold(ranks(1e-4, replicated=False), ranks(1e-2))['ok']
