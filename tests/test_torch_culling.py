"""The port's occupancy culling (models/culling.py, the culled Model, the
culled train step, weight decay and ``cast_rays_in_train_step``) against
the JAX package, at the 360 config cut to test size, inputs from numpy
seeds and weights through the bridge.

Tolerances, and why:
* cell ids: the two contractions round differently by an ulp, so a point
  within 1e-5 of a cell face may land in the neighbouring cell; at most a
  share of 1e-3 of the points may, and only such points;
* the keep masks, the grid update and the compaction's slot and inverse
  maps are integer or max arithmetic on the same inputs: bitwise;
* the refresh probe and the culled Model: the MLP's bf16 numerics, bounded
  as in tests/test_torch_model.py (3e-3);
* the culled and weight-decay steps: train_lib.leaf_gaps, as in
  tests/test_torch_train_step.py; ``losses/weight`` is a sum of squares of
  the same weights, 1e-6 relative.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.models import culling as jculling  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import types  # noqa: E402
from multinerf_tpu_torch.models import culling  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

RESOLUTION = 8
CULL_BINDINGS = (
    'Config.occupancy_culling = True',
    f'Config.occupancy_grid_resolution = {RESOLUTION}',
)
BINDINGS = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + CULL_BINDINGS
CAP = 0.5


def _jax_config(keep_rule='density'):
  jax_config, _ = tp.configs(CULL_BINDINGS + (
      f"Config.occupancy_keep_rule = '{keep_rule}'",
      'Config.occupancy_alpha_eps = 0.05'))
  return jax_config


def _half_grid(resolution=RESOLUTION):
  """A grid whose cells on the x < 0 side of contracted space are empty
  and the others dense: keep decisions flip only at that plane."""
  grid = np.zeros((resolution,) * 3, np.float32)
  grid[resolution // 2:] = np.random.RandomState(5).uniform(
      0.5, 2.0, grid[resolution // 2:].shape)
  return grid.reshape(-1)


def test_cell_ids_match_jax_up_to_points_on_a_face():
  means, _ = tp.gaussians(20000, seed=3, far_frac=0.3)
  want = np.asarray(jculling.cell_ids(jnp.asarray(means), 16))
  got = culling.cell_ids(torch.as_tensor(means), 16).numpy()
  off = np.flatnonzero(got != want)
  assert len(off) <= 1e-3 * len(means), len(off)
  x = means[off].astype(np.float64)
  r_sq = np.maximum(np.sum(x**2, -1, keepdims=True), 1e-30)
  z = np.where(r_sq <= 1, x, (2 * np.sqrt(r_sq) - 1) / r_sq * x)
  u = (z + 2.0) * 16 / 4.0
  assert np.all(np.min(np.abs(u - np.round(u)), -1) * 4 / 16 <= 1e-5)


@pytest.mark.parametrize('keep_rule', ['density', 'alpha'])
def test_keep_mask_matches_jax(keep_rule):
  config = _jax_config(keep_rule)
  _, torch_config = tp.configs(CULL_BINDINGS + (
      f"Config.occupancy_keep_rule = '{keep_rule}'",
      'Config.occupancy_alpha_eps = 0.05'))
  rng = np.random.RandomState(7)
  occ = rng.uniform(0, 0.02, (64, 16)).astype(np.float32)
  t_edges = np.cumsum(rng.uniform(0, 1, (64, 17)), -1).astype(np.float32)
  dirs = rng.randn(64, 3).astype(np.float32)
  want = np.asarray(jculling.keep_mask(jnp.asarray(occ), config,
                                       jnp.asarray(t_edges),
                                       jnp.asarray(dirs)))
  got = culling.keep_mask(torch.as_tensor(occ), torch_config,
                          torch.as_tensor(t_edges), torch.as_tensor(dirs))
  assert 0 < want.mean() < 1
  np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_unknown_rule_raises_jax_error():
  _, torch_config = tp.configs(("Config.occupancy_keep_rule = 'nope'",))
  with pytest.raises(ValueError, match='Unknown occupancy_keep_rule'):
    culling.keep_mask(torch.zeros(2, 3), torch_config)


def test_update_grid_matches_jax_bitwise():
  rng = np.random.RandomState(8)
  grid = rng.uniform(0, 1, 512).astype(np.float32)
  cells = rng.randint(0, 512, (300, 8))  # Many cells hit more than once.
  dens = rng.uniform(0, 3, (300, 8)).astype(np.float32)
  want = np.asarray(jculling.update_grid(
      jnp.asarray(grid), jnp.asarray(cells, jnp.int32), jnp.asarray(dens),
      0.97))
  got = culling.update_grid(torch.as_tensor(grid), torch.as_tensor(cells),
                            torch.as_tensor(dens), 0.97)
  np.testing.assert_array_equal(got.numpy(), want)


def _stub_outputs(means, cap):
  """What a stub MLP returns for the compacted samples: the slot + 1 as
  the density and the samples' means as the color."""
  density = (np.arange(cap, dtype=np.float32) + 1)[:, None]
  return density, means


# (rays, samples, capacity, keep probability): rays a multiple of the
# samples (JAX's shear branch) or not, with the kept samples over the
# capacity (overflow) or under it (refill).
MAP_CASES = [(128, 8, 0.25, 0.6), (128, 8, 0.5, 0.15), (100, 8, 0.33, 0.6),
             (100, 8, 0.5, 0.15)]


@pytest.mark.parametrize('b,s,frac,p', MAP_CASES)
def test_compaction_maps_match_jax_bitwise(b, s, frac, p):
  n = b * s
  cap = culling.round_capacity(n, frac)
  assert cap == jculling._round_capacity(n, frac)
  keep = np.random.RandomState(b + s).rand(b, s) < p
  # Each sample's mean carries its flat index, exact in float32.
  means = np.zeros((b, s, 3), np.float32)
  means[..., 0] = np.arange(n).reshape(b, s)
  covs = np.zeros((b, s, 3, 3), np.float32)

  def jstub(key, gaussians, **_):
    del key
    density, rgb = _stub_outputs(None, gaussians[0].shape[0])
    return {'density': jnp.asarray(density), 'rgb': gaussians[0]}

  out = jculling.apply_culled(
      jstub, None, (jnp.asarray(means), jnp.asarray(covs)),
      jnp.asarray(keep), frac, cells=jnp.arange(n, dtype=jnp.int32))
  density = np.asarray(out['density']).reshape(n)
  want_slot = np.where(density > 0, density - 1, cap).astype(np.int64)
  want_inv = np.asarray(out['occ_cells'])

  slot, inv = culling.compact_slots(torch.as_tensor(keep), cap)
  np.testing.assert_array_equal(slot.numpy(), want_slot)
  np.testing.assert_array_equal(inv.numpy(), want_inv)
  assert (keep.sum() > cap) == (frac == 0.25 or frac == 0.33)

  def stub(c_means, c_covs, viewdirs=None, glo_vec=None, generator=None):
    del c_covs, viewdirs, glo_vec, generator
    density, _ = _stub_outputs(None, c_means.shape[0])
    return {'density': torch.as_tensor(density), 'rgb': c_means,
            'normals': None}

  got = culling.apply_culled(
      stub, torch.as_tensor(means), torch.as_tensor(covs),
      torch.as_tensor(keep), frac, cells=torch.arange(n))
  for key in ('density', 'rgb', 'occ_keep_frac', 'occ_density'):
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(out[key]),
                                  err_msg=key)
  assert got['normals'] is None


def test_gather_rows_backward_matches_autograd_of_the_index():
  b, s, cap = 100, 8, 256
  keep = torch.as_tensor(np.random.RandomState(3).rand(b, s) < 0.5)
  slot, inv = culling.compact_slots(keep, cap)
  rng = np.random.RandomState(4)
  ext = torch.tensor(rng.randn(cap + 1, 4).astype(np.float32),
                     requires_grad=True)
  cot = torch.tensor(rng.randn(b * s, 4).astype(np.float32))
  custom, = torch.autograd.grad(culling.GatherRows.apply(ext, slot, inv), ext,
                                cot)
  plain, = torch.autograd.grad(ext[slot], ext, cot)
  # One reader per row below the trash row: the same sums, bitwise; the
  # trash row is the constant fill.
  np.testing.assert_array_equal(custom[:cap].numpy(), plain[:cap].numpy())
  np.testing.assert_array_equal(custom[cap].numpy(), 0.0)


def _model_pair(extra=()):
  """(JAX config, JAX model, its variables with the half grid, port config,
  port Model holding both)."""
  jax_config, torch_config = tp.configs(BINDINGS + tuple(extra))
  params = tp.jax_params(jax_config)
  variables = {'params': params,
               'occupancy': {'grid': jnp.asarray(_half_grid())}}
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_variables(model, variables)
  return jax_config, jmodel, variables, torch_config, model


def test_refresh_probe_matches_jax_on_its_jitter():
  jax_config, jmodel, variables, torch_config, model = _model_pair()
  key = jax.random.PRNGKey(11)
  want = np.asarray(jax.jit(jculling.make_refresh_fn(
      jmodel, jax_config, jit=False))(variables, key))
  jitter = jax.random.uniform(key, (RESOLUTION**3, 3), minval=-0.5,
                              maxval=0.5)
  with torch.no_grad():
    got = culling.probe_grid(model.NerfMLP_0, model.occupancy.grid,
                             torch_config, torch.tensor(np.asarray(jitter)))
  tp.assert_close(got.numpy(), want, atol=3e-3, rtol=3e-3, what='grid')
  # The probe raised the empty cells: the density head saw every cell.
  assert (want[_half_grid() == 0] > 0).all()


@pytest.mark.parametrize('extra', [(), ('Model.opaque_background = True',),
                                   ('Model.num_glo_features = 4',)])
def test_culled_model_forward_matches_jax(extra):
  # With GLO, each ray's row of the table (zero_glo=False), gathered per
  # compact sample as its view direction is.
  _, jmodel, variables, _, model = _model_pair(extra)
  fields = tp.rays(64, seed=4, far=1e3)
  fields['cam_idx'] = np.arange(64, dtype=np.int32)[:, None] % 7
  want_r, want_h = jax.jit(lambda v, r: jmodel.apply(
      v, None, r, train_frac=1.0, compute_extras=False, zero_glo=False,
      cull=CAP))(variables, tp.jax_rays(fields))
  with torch.inference_mode():
    got_r, got_h = model(tp.torch_rays(fields), 1.0, False, zero_glo=False,
                         cull=CAP)
  final_g, final_w = got_h[-1], want_h[-1]
  assert 0 < float(final_w['occ_keep_frac']) < 1
  assert float(final_g['occ_keep_frac']) == float(final_w['occ_keep_frac'])
  np.testing.assert_array_equal(final_g['occ_cells'].numpy(),
                                final_w['occ_cells'])
  for key in ('density', 'rgb', 'weights'):
    tp.assert_close(final_g[key].numpy(), final_w[key], atol=3e-3, rtol=3e-3,
                    what=key)
  tp.assert_close(got_r[-1]['rgb'].numpy(), want_r[-1]['rgb'], atol=3e-3,
                  what='rgb')


def test_cull_needs_the_grid():
  _, torch_config = tp.configs(tp.SMALL_BINDINGS)
  model = nerf.construct_model(torch_config, torch.Generator().manual_seed(0),
                               'cpu')
  with pytest.raises(ValueError, match='occupancy_culling'):
    model(tp.torch_rays(tp.rays(4)), 1.0, False, cull=0.5)


def _jax_batch(batch):
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      rgb=jnp.asarray(batch.rgb.numpy()))


def _jax_steps(jax_config, variables, batch, cull):
  """JAX's step (jit=False) on `batch` and on its nudged rays: per run the
  stats, the raw gradient, the updates and the grid after."""
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, variables)
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False,
                                      cull=cull)
  clip = jtrain_lib.clip_gradients
  params0 = bridge.flatten(jax.device_get(variables['params']))

  def run(jbatch):
    # The raw gradient, read where the step clips it (traced once).
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      new_jstate, jstats, _ = step(jax.random.PRNGKey(0), jstate, jbatch,
                                   0.5, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return new_jstate.params, jstats, captured['grad']

  run = jax.jit(run)
  runs = []
  for b in (batch, train_lib.nudge_origins(batch)):
    new, jstats, grad = jax.device_get(run(_jax_batch(b)))
    runs.append({
        'stats': jstats,
        'grads': bridge.flatten(grad),
        'updates': {k: np.asarray(v) - np.asarray(params0[k])
                    for k, v in bridge.flatten(new['params']).items()},
        'grid': np.asarray(new['occupancy']['grid'])
                if 'occupancy' in new else None})
  return runs


def _port_step(torch_config, variables, batch, cull):
  model, state, _, _, _ = train_lib.setup_model(torch_config, 0, 'cpu')
  bridge.load_jax_variables(model, variables)
  params0 = {k: v.detach().clone() for k, v in state.params.items()}
  step = train_lib.create_train_step(model, torch_config, 'cpu', cull=cull)
  captured = {}
  apply = train_lib.apply_gradients

  def recording_apply(state, grads, config, lr_fn):
    captured['grads'] = {k: v.clone() for k, v in grads.items()}
    return apply(state, grads, config, lr_fn)

  train_lib.apply_gradients = recording_apply
  try:
    state, stats = step(None, state, batch, 0.5, False)
  finally:
    train_lib.apply_gradients = apply
  return {'stats': stats, 'grads': captured['grads'],
          'updates': {k: v.detach() - params0[k]
                      for k, v in state.params.items()
                      if k in captured['grads']},
          'grid': model.occupancy.grid.numpy().copy()
                  if model.track_occupancy else None}


def _assert_within_gaps(got, want, want_nudged, what):
  assert set(got) == set(want)
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      got, want, want_nudged).items():
    assert gap <= bound, (f'{name}: {what} relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


def _batch(torch_config, rays=64):
  config = dataclasses.replace(torch_config, batch_size=rays)
  with datasets.load_dataset('train', None, config, seed=3) as dataset:
    return train_lib.batch_to_device(next(dataset), 'cpu')


@pytest.fixture(scope='module')
def culled_steps():
  bindings = BINDINGS + ("Config.dataset_loader = 'dummy_unbounded'",
                         'Config.randomized = False')
  jax_config, torch_config = tp.configs(bindings)
  variables = {'params': tp.jax_params(jax_config, seed=1),
               'occupancy': {'grid': jnp.asarray(_half_grid())}}
  batch = _batch(torch_config)
  want, want_nudged = _jax_steps(jax_config, variables, batch, CAP)
  got = _port_step(torch_config, variables, batch, CAP)
  return got, want, want_nudged


def test_culled_step_matches_jax(culled_steps):
  got, want, want_nudged = culled_steps
  assert 0 < float(want['stats']['occ_keep_frac']) < 1
  assert float(got['stats']['occ_keep_frac']) == float(
      want['stats']['occ_keep_frac'])
  assert float(got['stats']['loss']) == pytest.approx(
      float(want['stats']['loss']), rel=1e-3)
  # The gradient, not Adam's first update: that is lr * g / (|g| + eps)
  # per entry, so an entry whose gradient is near zero by bf16 rounding
  # alone moves the update by up to 2 lr (tests/test_torch_train_step.py).
  # Here NerfMLP_0/Dense_5/bias's update is 0.125 apart with the compact
  # samples identical on both sides and the gradient within its bound;
  # the optimizer's arithmetic is held in tests/test_torch_train_ops.py.
  _assert_within_gaps(got['grads'], want['grads'], want_nudged['grads'],
                      'gradient')


def test_grid_after_the_culled_step_matches_jax(culled_steps):
  got, want, _ = culled_steps
  # The cells the compact feedback reached hold the evaluated densities;
  # the others decayed.
  touched = want['grid'] != _half_grid() * np.float32(0.97)
  assert touched.any() and not touched.all()
  tp.assert_close(got['grid'], want['grid'], atol=3e-3, rtol=3e-3,
                  what='grid')


def test_weight_decay_step_matches_jax():
  mults = "{'NerfMLP_0': 0.1, 'PropMLP_0/Dense_0': 0.5}"
  bindings = tp.SMALL_BINDINGS + (
      "Config.dataset_loader = 'dummy_unbounded'", 'Config.randomized = False',
      f'Config.weight_decay_mults = {mults}',
      'NerfMLP.use_fused_featurize = False',
      'PropMLP.use_fused_featurize = False')
  jax_config, torch_config = tp.configs(bindings)
  variables = {'params': tp.jax_params(jax_config, seed=2)}
  batch = _batch(torch_config)
  want, want_nudged = _jax_steps(jax_config, variables, batch, False)
  got = _port_step(torch_config, variables, batch, None)
  assert float(got['stats']['losses/weight']) == pytest.approx(
      float(want['stats']['losses']['weight']), rel=1e-6)
  assert float(got['stats']['loss']) == pytest.approx(
      float(want['stats']['loss']), rel=1e-3)
  _assert_within_gaps(got['grads'], want['grads'], want_nudged['grads'],
                      'gradient')
  _assert_within_gaps(got['updates'], want['updates'],
                      want_nudged['updates'], 'update')


def test_weight_decay_of_an_unknown_subtree_raises():
  with pytest.raises(KeyError, match='NerfMLP_9'):
    train_lib.subtree_norm_sq({'NerfMLP_0/Dense_0/kernel': torch.ones(2)},
                              'NerfMLP_9')


def test_cast_rays_in_train_step_matches_the_host_cast():
  bindings = tp.SMALL_BINDINGS + ("Config.dataset_loader = 'dummy_unbounded'",
                                  'Config.randomized = False')
  _, host_config = tp.configs(bindings)
  _, pixel_config = tp.configs(bindings +
                               ('Config.cast_rays_in_train_step = True',))
  runs = {}
  for name, config in (('host', host_config), ('pixels', pixel_config)):
    config = dataclasses.replace(config, batch_size=64)
    with datasets.load_dataset('train', None, config, seed=3) as dataset:
      batch = train_lib.batch_to_device(next(dataset), 'cpu')
      model, state, _, train_step, _ = train_lib.setup_model(
          config, 0, 'cpu', dataset)
    assert isinstance(batch.rays, types.Pixels) == (name == 'pixels')
    runs[name] = _port_run(model, state, train_step, batch)
    if name == 'host':
      model, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
      runs['nudged'] = _port_run(model, state, train_step,
                                 train_lib.nudge_origins(batch))
  assert float(runs['pixels']['loss']) == pytest.approx(
      float(runs['host']['loss']), rel=1e-5)
  _assert_within_gaps(runs['pixels']['updates'], runs['host']['updates'],
                      runs['nudged']['updates'], 'update')


def _port_run(model, state, train_step, batch):
  params0 = {k: v.detach().clone() for k, v in state.params.items()}
  state, stats = train_step(None, state, batch, 0.5, False)
  return {'loss': stats['loss'],
          'updates': {k: v.detach() - params0[k]
                      for k, v in state.params.items()}}


# A run of the host path's culling protocol (train.py:260-289) at the lowest
# rung under overflow: warmup 2, refresh every 2.  The grid's x > 0 half
# holds 5-20 and its x < 0 half is empty, and the threshold, 2, is over
# every density these weights reach (~1 at most) and under the dense half
# however far it decays in 5 steps: no keep decision sits near it, so both
# sides keep the same samples.  Steps 1-2 look into the empty half, so the
# refresh after step 2 reads a keep fraction of 0 and the gate engages
# 0.33; steps 3-4 look into the dense half and keep every sample, past the
# capacity (256 of 512), and the refresh after step 4 lets the gate go:
# step 5 is unculled.
PROTOCOL_RUNG = 0.33
PROTOCOL_STEPS = 5
PROTOCOL = BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'", 'Config.randomized = False',
    f'Config.occupancy_capacity_ladder = ({PROTOCOL_RUNG},)',
    'Config.occupancy_warmup_steps = 2',
    'Config.occupancy_grid_refresh_every = 2',
    'Config.occupancy_threshold = 2.0')


def _protocol_batch(step, rays=64):
  """Rays from near the centre into the x < 0 half (steps 1-2) or the
  x > 0 half (later steps)."""
  fields = tp.rays(rays, seed=step, far=1e3)
  fields['origins'] *= 0.02
  d = fields['directions']
  d[:, 0] = (np.abs(d[:, 0]) + 0.5) * (-1 if step <= 2 else 1)
  fields['viewdirs'] = (d / np.linalg.norm(d, axis=-1, keepdims=True)
                        ).astype(np.float32)
  return types.Batch(rays=tp.torch_rays(fields), rgb=torch.tensor(
      np.random.RandomState(step).rand(rays, 3).astype(np.float32)))


def _jax_protocol_run(jax_config, variables):
  """JAX's host loop (train.py:260-289): per step the capacity it ran at
  (None unculled), its loss and keep fraction, and the grid after it."""
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, variables)
  mesh = mesh_lib.create_mesh()
  steps = {cap: jax.jit(jtrain_lib.create_train_step(
      jmodel, jax_config, mesh, jit=False, cull=cap or False))
           for cap in (None, PROTOCOL_RUNG)}
  refresh = jculling.make_refresh_fn(jmodel, jax_config)
  cull_cap, out = None, []
  for step in range(1, PROTOCOL_STEPS + 1):
    cap = (cull_cap if cull_cap is not None and
           step > jax_config.occupancy_warmup_steps else None)
    jstate, stats, _ = steps[cap](jax.random.PRNGKey(0), jstate,
                                  _jax_batch(_protocol_batch(step)), 0.5, 1.0)
    if step % jax_config.occupancy_grid_refresh_every == 0:
      grid = refresh(jstate.params, jax.random.PRNGKey(step))
      jstate = jstate.replace(params={**jstate.params,
                                      'occupancy': {'grid': grid}})
      kf = float(stats['occ_keep_frac'])
      cull_cap = next((c for c in (PROTOCOL_RUNG,) if kf <= c), None)
    out.append((cap, float(stats['loss']), float(stats['occ_keep_frac']),
                np.asarray(jstate.params['occupancy']['grid'])))
  return out


def test_culled_run_at_the_lowest_rung_matches_jax(monkeypatch):
  jax_config, config = tp.configs(PROTOCOL)
  variables = {'params': tp.jax_params(jax_config, seed=1),
               'occupancy': {'grid': jnp.asarray(_half_grid() * 10.0)}}
  want = _jax_protocol_run(jax_config, variables)
  # The refresh probes at JAX's jitter: its PRNGKey(step), the step being
  # the seed of the gate's generator.
  monkeypatch.setattr(culling, 'refresh_jitter', lambda gen, res, device: (
      torch.tensor(np.asarray(jax.random.uniform(
          jax.random.PRNGKey(gen.initial_seed()), (res**3, 3),
          minval=-0.5, maxval=0.5)))))
  model, state, _, unculled, _ = train_lib.setup_model(config, 0, 'cpu')
  bridge.load_jax_variables(model, variables)
  steps = {None: unculled, PROTOCOL_RUNG: train_lib.create_train_step(
      model, config, 'cpu', cull=PROTOCOL_RUNG)}
  gate = train_lib.CullingGate(model, config)
  for step, (cap, loss, keep_frac, grid) in enumerate(want, 1):
    assert gate.cull(step) == cap, step
    state, stats = steps[cap](None, state, _protocol_batch(step), 0.5, False)
    gate.after_step(step, stats)
    assert float(stats['occ_keep_frac']) == keep_frac, step
    assert float(stats['loss']) == pytest.approx(loss, rel=1e-3), step
    tp.assert_close(model.occupancy.grid.numpy(), grid, atol=3e-3,
                    rtol=3e-3, what=f'grid after step {step}')
  # JAX's run takes the course set out above.
  assert [c for c, _, _, _ in want] == [None, None, PROTOCOL_RUNG,
                                        PROTOCOL_RUNG, None]
  assert [k for _, _, k, _ in want] == [0.0, 0.0, 1.0, 1.0, 1.0]
  assert gate.rungs == {3: PROTOCOL_RUNG, 4: PROTOCOL_RUNG}
  assert gate.rung is None and set(gate.keep_fracs) == {2, 4}
