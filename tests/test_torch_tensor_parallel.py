"""The port's tensor parallelism (``multinerf_tpu_torch/parallel/tensor.py``
and the model axis of ``parallel/mesh.py``) on the CPU.

Gloo clusters started by ``python -m torch.distributed.run`` run
``tests/helpers/torch_tp_worker.py``, which imports only the port, at the
test widths of tests/test_tensor_parallel.py (NerfMLP 4 x 128, PropMLP
2 x 32, ``min_dim_to_shard=128``, 64 fixed rays with no jitter): a 1 x 2
mesh (one data index, two model ranks) trains every case 3 steps and
renders a test view; a 2 x 2 mesh (4 ranks) trains one case and the first
phase of save -> kill -> restore; then a new 2 x 2 cluster restores it.
Every cluster runs once per module, in one fixture (``runs``), while this
process runs the same code with no process group (one process on the
global batch) and the JAX package's (4, 2) tensor-parallel step on the
same batch and weights.

At these widths JAX's rule splits the NerfMLP's trunk, its bottleneck and
view layer (column) and its rgb head (row); the depth-6 cases add the
skip layer (row-split after the column Dense_4), fused and unfused.

Tolerances, and why:
* losses and step-1 grad norms of the f32 cases at tests/test_tensor_parallel.py's
  own bounds (one level: losses rtol 1e-5 / atol 1e-7, grad norms rtol
  1e-4; two levels: losses 1e-4 / 1e-6, grad norms 1e-2 / 1e-4, params
  after 3 steps atol 2e-3): the model group's partial sums add in another
  order than one process's products, nothing more;
* the bf16 cases: step 1's loss at 1e-5, steps 2-3 at
  ``ddp_probe.LATER_LOSS_RTOL`` (4e-4) and step 1's gradient by
  ``train_lib.leaf_gaps``: the partial sums are summed in f32 and rounded
  once, as one process rounds its product, but a sum that lands on the
  other side of a bf16 rounding boundary moves the cotangents (readings:
  step-1 losses within 7e-7, later steps within 2e-4, grad norms within
  7e-4);
* the int8 case runs on gathered weights, so its forward is one process's:
  the same bounds as the f32 two-level case;
* against JAX's tensor-parallel step, the gradient by ``leaf_gaps`` (the
  JAX reference's own move under a 1e-6 nudge of its ray origins bounds
  each leaf) and the loss at 1e-3, as tests/test_torch_distributed.py
  holds its data-parallel step;
* frames at rtol 1e-3 / atol 1e-4, the bounds of test_torch_distributed.py,
  without its share of bitwise-equal values: every row layer's sum is
  split in two and added in another order, so most values move by an f32
  ulp (readings: 28-88% bitwise equal, largest gap 5.3e-6 in the 95th
  distance percentile);
* replicated leaves bitwise equal on every rank after every step, split
  leaves bitwise equal across the data group: every rank applies the same
  all-reduced values.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402
import torch_tp_worker as worker  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.parallel import mesh as jmesh  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import ddp_probe  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import types  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.parallel import mesh  # noqa: E402
from multinerf_tpu_torch.parallel import tensor  # noqa: E402

WORKER = os.path.join(tp.REPO, 'tests', 'helpers', 'torch_tp_worker.py')
CLUSTER_TIMEOUT = 300
FRAME_RTOL, FRAME_ATOL = 1e-3, 1e-4

# tests/test_tensor_parallel.py's bindings and Config.
BINDINGS = (
    'PropMLP.net_depth = 2', 'PropMLP.net_width = 32',
    'PropMLP.disable_density_normals = True', 'PropMLP.disable_rgb = True',
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 128',
    'NerfMLP.disable_density_normals = True',
    'Model.num_prop_samples = 8', 'Model.num_nerf_samples = 4',
    'Model.num_levels = 2')
BINDINGS_SINGLE_LEVEL = tuple(
    b for b in BINDINGS if not b.startswith('Model.')) + (
        'Model.num_nerf_samples = 16', 'Model.num_levels = 1')
CONFIG = ("Config.dataset_loader = 'dummy'", 'Config.batch_size = 64',
          "Config.data_loss_type = 'mse'", 'Config.near = 0.5',
          'Config.far = 10.0', 'Config.max_steps = 10',
          'Config.lr_delay_steps = 0', 'Config.randomized = False')
SKIP = ('NerfMLP.net_depth = 6',)  # Layer 5 takes [x, features].
UNFUSED = ('NerfMLP.use_fused_featurize = False',
           'PropMLP.use_fused_featurize = False')
BF16 = ("NerfMLP.trunk_dtype = 'bfloat16'",)
CASES = {
    'single': BINDINGS_SINGLE_LEVEL + CONFIG,
    'two': BINDINGS + CONFIG,
    'skip': BINDINGS + CONFIG + SKIP,
    'skip_unfused': BINDINGS + CONFIG + SKIP + UNFUSED,
    'skip_bf16': BINDINGS + CONFIG + SKIP + BF16,
    'skip_unfused_bf16': BINDINGS + CONFIG + SKIP + UNFUSED + BF16,
    'int8': BINDINGS + CONFIG + ("NerfMLP.trunk_dtype = 'int8'",
                                 "PropMLP.trunk_dtype = 'int8'"),
}
# (step-1 loss rtol, later losses rtol, loss atol, step-1 grad norm rtol,
# grad norm atol, params atol after the last step); None: by leaf_gaps.
BOUNDS = {
    'single': (1e-5, 1e-5, 1e-7, 1e-4, 1e-7, None),
    'two': (1e-4, 1e-4, 1e-6, 1e-2, 1e-4, 2e-3),
    'skip': (1e-5, 1e-5, 1e-7, 1e-4, 1e-7, None),
    'skip_unfused': (1e-5, 1e-5, 1e-7, 1e-4, 1e-7, None),
    'skip_bf16': (ddp_probe.LOSS_RTOL, ddp_probe.LATER_LOSS_RTOL, 0, None,
                  None, None),
    'skip_unfused_bf16': (ddp_probe.LOSS_RTOL, ddp_probe.LATER_LOSS_RTOL, 0,
                          None, None, None),
    'int8': (1e-4, 1e-4, 1e-6, 1e-2, 1e-4, 2e-3),
}
# The control: 'two' with model rank 1's partial sum zeroed in the first
# forward all-reduce (ddp_probe.drop_model_partial).
CONTROL = {'name': 'two_drop', 'bindings': list(CASES['two']),
           'drop_model_rank': 1}
CKPT_CASE = CASES['two']
TWO_BY_TWO = ('two',)


def make_batch(n=64, seed=3):
  """tests/test_tensor_parallel.py's _make_batch, as numpy fields."""
  rs = np.random.RandomState(seed)
  d = rs.randn(n, 3).astype(np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  rays = dict(origins=rs.randn(n, 3).astype(np.float32) * 0.2,
              directions=d, viewdirs=d,
              radii=np.full((n, 1), 1e-3, np.float32),
              imageplane=np.zeros((n, 2), np.float32),
              lossmult=np.ones((n, 1), np.float32),
              near=np.full((n, 1), 0.5, np.float32),
              far=np.full((n, 1), 10.0, np.float32),
              cam_idx=np.zeros((n, 1), np.int32))
  return rays, rs.rand(n, 3).astype(np.float32)


def _torch_batch(rays, rgb):
  fields = {k: torch.as_tensor(v) for k, v in rays.items()}
  fields['cam_idx'] = fields['cam_idx'].long()
  return types.Batch(rays=types.Rays(**fields), rgb=torch.as_tensor(rgb))


def _jax_batch(rays, rgb):
  return jtypes.Batch(rays=jtypes.Rays(**rays), rgb=rgb)


def _write_spec(out_dir, batch, cases, frame=None):
  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(out_dir, 'cases.json'), 'w') as f:
    json.dump({'cases': cases, 'frame': frame,
               'ckpt': list(CKPT_CASE)}, f)
  torch.save(batch, os.path.join(out_dir, 'batch.pt'))


def _launch(nproc, scenarios, out_dir, model_parallel):
  return ddp_probe.Launch(nproc, [WORKER, scenarios, out_dir,
                                  str(model_parallel)], threads=1)


def _finish(what, launch):
  try:
    return launch.wait(CLUSTER_TIMEOUT)
  except ddp_probe.LaunchError as e:
    pytest.fail(f'{what}: {e}')


def _results(out_dir, scenario, nproc):
  return [torch.load(os.path.join(out_dir, f'{scenario}_rank{r}.pt'),
                     weights_only=False) for r in range(nproc)]


def _jax_tp_step(bindings, rays, rgb):
  """JAX's loss and raw gradient of one step on the (4, 2) mesh, the
  state laid out by infer_tree_shardings at min_dim_to_shard=128, from the
  port's seed-0 weights: on the batch and on its nudged copy."""
  jax_config, torch_config = tp.configs(bindings, files=())
  model = train_lib.setup_model(torch_config, 0, 'cpu')[0]
  params = jax.tree_util.tree_map(jnp.asarray, bridge.jax_params(model))
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  jax_mesh = jmesh.create_mesh(model_parallel=2)
  jstate = jax.device_put(jstate, jmesh.infer_tree_shardings(
      jstate, jax_mesh, min_dim_to_shard=worker.MIN_DIM_TO_SHARD))
  step = jtrain_lib.create_train_step(jmodel, jax_config, jax_mesh,
                                      jit=False)
  clip = jtrain_lib.clip_gradients

  def run(state, batch):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), state, batch,
                         worker.TRAIN_FRAC, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats['loss'], captured['grad']

  run = jax.jit(run)
  out = []
  nudged = dict(rays, origins=rays['origins'] * np.float32(
      1 + train_lib.NUDGE))
  with jax_mesh:
    for r in (rays, nudged):
      batch = jmesh.shard_batch_to_global(jax_mesh, _jax_batch(r, rgb))
      loss, grads = jax.device_get(run(jstate, batch))
      out.append({'loss': float(loss), 'grads': bridge.flatten(grads)})
  return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """Every cluster of the module, and what this process holds them
  against: the 1 x 2 and the 2 x 2 clusters at once, while this process
  runs the one-process references and JAX's tensor-parallel step; then a
  new 2 x 2 cluster restores the first one's checkpoint."""
  root = tmp_path_factory.mktemp('tp')
  rays, rgb = make_batch()
  batch = _torch_batch(rays, rgb)
  cases = [{'name': k, 'bindings': list(v)} for k, v in CASES.items()]
  dirs = {'1x2': str(root / 'mp2'), '2x2': str(root / 'mp2dp2')}
  _write_spec(dirs['1x2'], batch, cases + [CONTROL],
              frame=list(CASES['two']))
  _write_spec(dirs['2x2'], batch,
              [c for c in cases if c['name'] in TWO_BY_TWO])
  procs = {'1 x 2 cluster': _launch(2, 'steps', dirs['1x2'], 2),
           '2 x 2 cluster': _launch(4, 'steps,ckpt', dirs['2x2'], 2)}
  try:
    ref = {k: worker.run_case({'bindings': v}, batch)
           for k, v in CASES.items()}
    ref_nudged = {k: worker.run_case(
        {'bindings': v}, train_lib.nudge_origins(batch))
                  for k, v in CASES.items()}
    frame = worker.render_frame(CASES['two'])
    jax_two = _jax_tp_step(CASES['two'] + tp.FUSED_BINDINGS, rays, rgb)
    ckpt_losses = _one_process_losses(batch, 2 * worker.NUM_STEPS)
  finally:
    for what, p in procs.items():
      _finish(what, p)
  out = {'1x2': _results(dirs['1x2'], 'steps', 2),
         '2x2': _results(dirs['2x2'], 'steps', 4),
         'ckpt': [_results(dirs['2x2'], 'ckpt', 4)], 'ref': ref,
         'ref_nudged': ref_nudged, 'frame': frame, 'jax': jax_two,
         'ckpt_losses': ckpt_losses, 'ckpt_dir': os.path.join(dirs['2x2'],
                                                               'ckpt')}
  _finish('restoring 2 x 2 cluster', _launch(4, 'ckpt', dirs['2x2'], 2))
  out['ckpt'].append(_results(dirs['2x2'], 'ckpt', 4))
  return out


def _one_process_losses(batch, steps):
  config = worker.load_config(CKPT_CASE)
  _, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  losses = []
  for _ in range(steps):
    state, stats = train_step(None, state, batch, worker.TRAIN_FRAC, False)
    losses.append(float(stats['loss']))
  return losses


def _assert_within_gaps(got, want, want_nudged, what):
  """leaf_gaps of every leaf; a leaf no loss reaches (one level's unused
  PropMLP) must be zero on both sides."""
  assert set(got) == set(want)
  unused = {k for k, v in want.items() if not np.any(v)}
  for k in unused:
    assert not np.any(got[k]), f'{what} {k}'
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      {k: v for k, v in got.items() if k not in unused},
      {k: v for k, v in want.items() if k not in unused},
      want_nudged).items():
    assert gap <= bound, (f'{what} {name}: relative L2 gap {gap:.3e} > '
                          f'{bound:.3e} (reference moved {sens:.3e})')


# --- (a) The layout, leaf for leaf against JAX's. ------------------------------


def _jax_specs(config, model_size, min_dim):
  shapes = tp.jax_params(config, shapes_only=True)
  jax_mesh = jmesh.create_mesh(model_parallel=model_size)
  specs = jmesh.infer_tree_shardings(shapes, jax_mesh, min_dim)
  return {k: v.spec for k, v in bridge.flatten(specs).items()}


def _port_model(bindings, files=()):
  _, torch_config = tp.configs(bindings, files=files)
  return nerf.construct_model(torch_config, torch.Generator().manual_seed(0),
                              'cpu')


_SPEC = {tensor.COLUMN: jax.sharding.PartitionSpec(None, 'model'),
         tensor.ROW: jax.sharding.PartitionSpec('model', None),
         None: jax.sharding.PartitionSpec()}


@pytest.mark.parametrize('bindings,files,min_dim', [
    (BINDINGS, (), 128),
    (BINDINGS + SKIP, (), 128),
    ((), (tp.CONFIG_360,), 512)], ids=['test_widths', 'skip', '360'])
def test_layout_is_jax_infer_tree_shardings_leaf_for_leaf(bindings, files,
                                                          min_dim):
  jax_config, _ = tp.configs(bindings, files=files)
  want = _jax_specs(jax_config, 2, min_dim)
  model = _port_model(bindings, files)
  got = tensor.infer_layout(bridge.named_parameters(model), 2, min_dim)
  assert set(got) == set(want)
  for name, kind in got.items():
    assert _SPEC[kind] == want[name], name
  assert tensor.COLUMN in got.values() and tensor.ROW in got.values()


def test_360_layout_pairs_the_trunk_and_halves_the_bytes():
  """configs/360.gin at model size 2: the trunk pairs column -> row,
  Dense_5 (1528 rows) is row-split, everything else is replicated, and a
  rank holds 0.54 of one process's parameters (and so of Adam's moments,
  which follow them)."""
  model = _port_model((), (tp.CONFIG_360,))
  layout = tensor.infer_layout(bridge.named_parameters(model), 2, 512)
  split = {k: v for k, v in layout.items() if v}
  assert split == {f'NerfMLP_0/Dense_{i}/kernel':
                   tensor.COLUMN if i % 2 == 0 else tensor.ROW
                   for i in range(8)}
  splits = nerf.model_splits(model, 2, 512)
  assert splits['NerfMLP_0/Dense_5/kernel'] == tensor.Split(
      tensor.SKIP, (1528, 1024), 1024)
  whole = sum(p.numel() for p in model.parameters())
  per_rank = sum(p.numel() // (2 if k in splits else 1)
                 for k, p in bridge.named_parameters(model).items())
  assert 0.53 < per_rank / whole < 0.55, per_rank / whole


@pytest.mark.parametrize('kind', [tensor.COLUMN, tensor.ROW, tensor.SKIP])
def test_shard_and_assemble_are_inverse(kind):
  full = torch.arange(12 * 8, dtype=torch.float32).reshape(12, 8)
  split = tensor.Split(kind, (12, 8), 4 if kind == tensor.SKIP else 0)
  parts = torch.stack([tensor.shard_of(full, split, 2, r) for r in (0, 1)])
  assert all(p.is_contiguous() for p in parts)
  assert torch.equal(tensor.assemble(parts, split), full)
  if kind == tensor.SKIP:
    x_rows, feat_cols = tensor.skip_parts(parts[1], split, 2)
    assert torch.equal(x_rows, full[2:4])
    assert torch.equal(feat_cols, full[4:, 4:])


# --- (b), (c), (h): 1 x 2 against one process. --------------------------------


@pytest.mark.parametrize('name', list(CASES))
def test_one_by_two_step_is_the_one_process_step(runs, name):
  first_rtol, later_rtol, atol, norm_rtol, norm_atol, params_atol = (
      BOUNDS[name])
  ref, ref_nudged = runs['ref'][name], runs['ref_nudged'][name]
  want = np.array(ref['losses'])
  for rank, got in enumerate(runs['1x2']):
    got = got[name]
    gap = np.abs(np.array(got['losses']) - want)
    assert gap[0] <= atol + first_rtol * abs(want[0]), (rank, gap)
    assert np.all(gap[1:] <= atol + later_rtol * np.abs(want[1:])), (
        rank, gap)
    norms = {k: v for k, v in ref['stats'][0].items()
             if k.startswith('grad_norms/')}
    assert norms and norms.keys() <= got['stats'][0].keys()
    if norm_rtol is not None:
      for k, v in norms.items():
        np.testing.assert_allclose(got['stats'][0][k], v, rtol=norm_rtol,
                                   atol=norm_atol, err_msg=k)
    _assert_within_gaps(got['grads1'], ref['grads1'], ref_nudged['grads1'],
                        f'rank {rank} gradient')
    assert got['params'].keys() == ref['params'].keys()
    if params_atol is not None:
      for k, v in ref['params'].items():
        np.testing.assert_allclose(got['params'][k], v, rtol=0,
                                   atol=params_atol, err_msg=k)


def test_dropped_model_partial_misses_the_loss_bound(runs):
  """(i) Model rank 1's partial sum zeroed in the first forward all-reduce:
  the two-level case's loss bound (1e-4) catches it."""
  want = np.array(runs['ref']['two']['losses'])
  for got in runs['1x2']:
    gap = np.abs(np.array(got['two_drop']['losses']) / want - 1)
    assert np.any(gap > BOUNDS['two'][1]), gap


# --- (d) 1 x 2 against JAX's tensor-parallel step. -----------------------------


def test_one_by_two_step_matches_jax_tensor_parallel_step(runs):
  want, want_nudged = runs['jax']
  got = runs['1x2'][0]['two']
  assert got['losses'][0] == pytest.approx(want['loss'], rel=1e-3)
  _assert_within_gaps(got['grads1'], want['grads'], want_nudged['grads'],
                      'gradient vs JAX')


# --- (e) Ranks and bytes. ------------------------------------------------------


@pytest.mark.parametrize('layout', ['1x2', '2x2'])
def test_replicated_leaves_equal_on_every_rank_and_shards_on_the_data_group(
    runs, layout):
  ranks = runs[layout]
  names = CASES if layout == '1x2' else TWO_BY_TWO
  for name in names:
    results = [r[name] for r in ranks]
    assert all(all(r['replicated_steps']) for r in results), name
    splits = set(results[0]['local_params']) - {
        k for k, v in results[0]['local_params'].items()
        if v.shape == results[0]['params'][k].shape}
    assert splits, name
    for k, v in results[0]['local_params'].items():
      # Ranks d * 2 + m: the data group of model rank m is {m, 2 + m}.
      same = [r for i, r in enumerate(results) if k not in splits or i % 2 == 0]
      for r in same:
        np.testing.assert_array_equal(r['local_params'][k], v, err_msg=k)
    if len(results) == 4:
      for k in splits:
        np.testing.assert_array_equal(results[1]['local_params'][k],
                                      results[3]['local_params'][k])
    # Every rank reports the same whole parameters.
    for r in results[1:]:
      for k, v in results[0]['params'].items():
        np.testing.assert_array_equal(r['params'][k], v, err_msg=k)


def test_per_rank_bytes_are_under_three_quarters_of_one_process(runs):
  want = runs['ref']['two']['bytes']
  for r in runs['1x2'] + runs['2x2']:
    assert r['two']['bytes'] < 0.75 * want, (r['two']['bytes'], want)


def test_two_by_two_step_is_the_one_process_step(runs):
  ref = runs['ref']['two']
  for r in runs['2x2']:
    np.testing.assert_allclose(r['two']['losses'], ref['losses'], rtol=1e-4,
                               atol=1e-6)
    _assert_within_gaps(r['two']['grads1'], ref['grads1'],
                        runs['ref_nudged']['two']['grads1'], '2x2 gradient')


# --- (f) Checkpoints. ----------------------------------------------------------


def test_checkpoint_save_kill_restore_continues_one_process_trajectory(
    runs):
  first, second = runs['ckpt']
  for rank in range(4):
    assert first[rank]['start_step'] == 0
    assert second[rank]['start_step'] == 3
    np.testing.assert_allclose(
        first[rank]['losses'] + second[rank]['losses'], runs['ckpt_losses'],
        rtol=1e-4, atol=1e-6)
  for r in second[1:]:
    for k, v in second[0]['params'].items():
      np.testing.assert_array_equal(r['params'][k], v, err_msg=k)


def test_saved_checkpoint_holds_one_process_tree(runs):
  saved = torch.load(os.path.join(runs['ckpt_dir'], 'checkpoint_6.pt'),
                     weights_only=True)
  model, state, _, _, _ = train_lib.setup_model(
      worker.load_config(CKPT_CASE), 0, 'cpu')
  assert {k: tuple(v.shape) for k, v in saved['params'].items()} == {
      k: tuple(v.shape) for k, v in state.params.items()}
  params = list(bridge.named_parameters(model).values())
  for i, moments in saved['opt_state']['state'].items():
    for key in ('exp_avg', 'exp_avg_sq'):
      assert moments[key].shape == params[i].shape, (i, key)


# --- (g) The frame. ------------------------------------------------------------


def test_one_by_two_frame_is_the_one_process_frame(runs):
  want = runs['frame']
  for rank, r in enumerate(runs['1x2']):
    got = r['frame']
    assert got.keys() == want.keys()
    for key, value in want.items():
      pairs = zip(got[key], value) if isinstance(value, list) else [
          (got[key], value)]
      for g, w in pairs:
        tp.assert_close(g, w, atol=FRAME_ATOL, rtol=FRAME_RTOL,
                        what=f'rank {rank} {key}')


# --- (i) The mesh's errors, and the helpers at model size 1. -------------------


def test_create_mesh_raises_where_jax_does_and_without_a_process_group(
    monkeypatch):
  with pytest.raises(ValueError, match='not divisible by model_parallel=2'):
    mesh.create_mesh(model_parallel=2)  # One process.
  monkeypatch.setattr(mesh, 'world_size', lambda: 3)
  with pytest.raises(ValueError, match='3 processes not divisible'):
    mesh.create_mesh(model_parallel=2)
  monkeypatch.setattr(mesh, 'world_size', lambda: 2)
  with pytest.raises(ValueError, match='needs a process group'):
    mesh.create_mesh(model_parallel=2)
  assert mesh.model_size() == 1


def test_model_size_one_is_the_data_parallel_layout():
  layout = mesh.create_mesh(model_parallel=1)
  try:
    assert layout.model_group is mesh.ALONE and layout.data_group is None
    assert (mesh.data_rank(), mesh.data_size(), mesh.model_rank(),
            mesh.model_size()) == (0, 1, 0, 1)
    t = torch.arange(6.0).reshape(3, 2)
    for op in (tensor.copy_to_model, tensor.reduce_from_model):
      assert op(t) is t
    assert tensor.gather_from_model(t, tensor.Split(tensor.ROW, (6, 2))) is t
    assert mesh.all_reduce_sum(t, mesh.model_group()) is t
    assert mesh.all_gather_rows(t, mesh.data_group()) is t
  finally:
    mesh.shutdown()
