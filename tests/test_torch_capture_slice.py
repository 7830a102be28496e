"""The capture slice as a whole against the JAX package, at the small widths
of tests/helpers/torch_parity.py, on two captures written here: an
unbounded one (configs/360.gin, an OPENCV camera with radial and tangential
distortion, JPEG originals carrying Exif exposures) and a forward-facing
one (configs/llff_256.gin: NDC, no contraction, cylinders, the octahedron
basis).

- A rendered test view of the port's Model against JAX's, on the same
  weights (bridged), both casting the capture's rays on the device; the
  JAX MLPs take their Pallas kernels in interpret mode
  (``use_fused_featurize``), as the other parity tests run them.  Bounds:
  those of tests/test_torch_model.py (rgb and acc 3e-3; distances as
  near / t within 2e-3 on the 360 capture, and as t, already normalized to
  [0, 1] by NDC, within 2e-3 on the forward-facing one).
- One llff_256.gin train step on rays cast from the forward-facing capture,
  its gradient by ``train_lib.leaf_gaps`` against JAX's step and JAX's step
  on nudged rays, its data loss within 1e-3 relative.
- The train, eval and render entry points on a Tanks and Temples scene
  (360.gin + tat.gin, the NeRF++ layout, its ``camera_path`` rendered):
  losses finite, the JAX eval's files, one frame per path pose.
- The device sampler's draw against the host caster on both captures: the
  device casts in float32 torch, the host in float64 numpy rounded to
  float32, so rays agree within 1e-5 (absolute and relative; undistortion
  and the NDC division carry the float32 rounding further than the pinhole
  cast of tests/test_torch_data_plane.py); rgb bitwise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import test_torch_datasets_capture as capture  # noqa: E402
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import eval as eval_lib  # noqa: E402
from multinerf_tpu_torch import render  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import device_sampler  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

LLFF_256 = os.path.join(tp.REPO, 'configs', 'llff_256.gin')
TRAIN_FRAC = 0.5
RAY_FIELDS = ('origins', 'directions', 'viewdirs', 'radii', 'imageplane',
              'lossmult', 'near', 'far', 'cam_idx', 'exposure_values')


@pytest.fixture(scope='module')
def captures(tmp_path_factory):
  """{'360': (data dir, gin files), 'llff': ...}: an unbounded distorted
  capture of 10 views and a forward-facing one of 8, 32 x 24 originals and
  a 16 x 12 level."""
  root = tmp_path_factory.mktemp('captures')
  unbounded = str(root / 'unbounded')
  capture.write_capture(unbounded, capture.ring_poses(10), seed=1)
  forward = str(root / 'forward')
  n = 8
  capture.write_capture(forward, capture.forward_poses(n), model_id=1,
                        params=capture.OPENCV[:4], originals='png', seed=2)
  bounds = np.stack([np.linspace(0.9, 1.2, n), np.linspace(5, 8, n)], -1)
  np.save(os.path.join(forward, 'poses_bounds.npy'),
          np.concatenate([np.zeros((n, 15)), bounds], -1))
  return {'360': (unbounded, (tp.CONFIG_360,)),
          'llff': (forward, (LLFF_256,))}


def _configs(captures, which, *more):
  data_dir, files = captures[which]
  return tp.configs(tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
      f"Config.data_dir = '{data_dir}'", 'Config.factor = 2',
      'Config.llffhold = 4', 'Config.batch_size = 64') + more, files=files)


@pytest.mark.parametrize('which', ['360', 'llff'])
def test_rendered_view_matches_jax(captures, which):
  jax_config, torch_config = _configs(captures, which)
  params = tp.jax_params(jax_config, seed=5)
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)

  def jax_render_fn(variables, train_frac, _, rays):
    return jmodel.apply(variables, None, rays, train_frac=train_frac,
                        compute_extras=True)

  jax_test = jdatasets.load_dataset('test', jax_config.data_dir, jax_config)
  want = jnerf.DeviceImageRenderer(jax_render_fn, jax_config, jax_test)(
      {'params': params}, 1.0, 1)
  with datasets.load_dataset('test', torch_config.data_dir,
                             torch_config) as test:
    assert (test.distortion_params is None) == (which == 'llff')
    assert (test.pixtocam_ndc is None) == (which == '360')
    got = nerf.DeviceImageRenderer(train_lib.create_render_fn(model),
                                   torch_config, test, 'cpu')(1.0, 1)
  assert got['rgb'].shape == want['rgb'].shape == (12, 16, 3)
  tp.assert_close(got['rgb'], want['rgb'], atol=3e-3, what='rgb')
  tp.assert_close(got['acc'], want['acc'], atol=3e-3, what='acc')
  for key in ('distance_mean', 'distance_median'):
    g, w = got[key], np.asarray(want[key])
    if which == '360':
      g, w = torch_config.near / g, torch_config.near / w
    tp.assert_close(g, w, atol=2e-3, what=key)


def _jax_batch(batch):
  fields = {k: jnp.asarray(v.numpy()) for k, v in vars(batch).items()
            if k != 'rays' and v is not None}
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      **fields)


def test_llff_train_step_matches_jax(captures):
  jax_config, torch_config = _configs(captures, 'llff',
                                      'Config.randomized = False')
  params = tp.jax_params(jax_config, seed=6)
  with datasets.load_dataset('train', torch_config.data_dir, torch_config,
                             seed=3) as dataset:
    batch = train_lib.batch_to_device(next(dataset), 'cpu')
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients

  def run(state, b):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), state, b, TRAIN_FRAC, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats, captured['grad']

  run = jax.jit(run)
  want = [jax.device_get(run(jstate, _jax_batch(b)))
          for b in (batch, train_lib.nudge_origins(batch))]
  model, _, _, _, _ = train_lib.setup_model(torch_config, 0, 'cpu')
  bridge.load_jax_params(model, params)
  _, losses, _, grads = train_lib.loss_and_grads(model, torch_config, batch,
                                                 TRAIN_FRAC)
  want_data = float(want[0][0]['losses']['data'])
  assert abs(float(losses['data']) - want_data) <= 1e-3 * abs(want_data)
  gaps = train_lib.leaf_gaps({k: v.numpy() for k, v in grads.items()},
                             bridge.flatten(want[0][1]),
                             bridge.flatten(want[1][1]))
  assert len(gaps) == len(grads)
  for name, (gap, sens, bound) in gaps.items():
    assert gap <= bound, (f'{name}: relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


@pytest.mark.parametrize('which', ['360', 'llff'])
def test_device_sampler_matches_the_host_caster(captures, which):
  _, config = _configs(captures, which)
  with datasets.load_dataset('train', config.data_dir, config) as dataset:
    plane = device_sampler.DeviceDataPlane(dataset, config, 'cpu')
    assert (plane.cameras[2] is None) == (which == 'llff')
    generator = torch.Generator().manual_seed(0)
    for _ in range(2):
      pix_x, pix_y, cam_idx = plane.draw(generator)
      got = plane.make_batch(pix_x, pix_y, cam_idx)
      host = dataset._make_ray_batch(  # pylint: disable=protected-access
          pix_x.numpy(), pix_y.numpy(), cam_idx.numpy())
      want = train_lib.batch_to_device(host, 'cpu')
      assert torch.equal(got.rgb, want.rgb)
      for key in RAY_FIELDS:
        g, w = getattr(got.rays, key), getattr(want.rays, key)
        if key == 'exposure_values' and which == 'llff':
          assert g is None and w is None
          continue
        assert g.shape == w.shape and g.dtype == w.dtype, key
        tp.assert_close(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, what=key)


def test_tat_entry_points_run(tmp_path):
  capture.write_tat_nerfpp(str(tmp_path))
  argv = ['--device=cpu', f'--gin_configs={tp.CONFIG_360}',
          f'--gin_configs={os.path.join(tp.REPO, "configs", "tat.gin")}'] + [
              f'--gin_bindings={b}' for b in tp.SMALL_BINDINGS + (
                  f"Config.data_dir = '{tmp_path}'",
                  f"Config.checkpoint_dir = '{tmp_path / 'ckpt'}'",
                  'Config.max_steps = 2', 'Config.batch_size = 64')]
  trained = train.main(argv)
  assert len(trained['losses']) == 2
  assert np.isfinite(trained['losses']).all()
  evaluated = eval_lib.main(argv)
  names = os.listdir(evaluated['out_dir'])
  assert {'metric_psnr_2.txt', 'color_001.png'} <= set(names)
  frames = render.main(argv + ['--gin_bindings=Config.render_path = True'])
  assert frames['frames'] == [0, 1, 2]
  assert os.path.basename(frames['out_dir']) == 'path_renders_step_2'
  assert frames['renderings'][2]['rgb'].shape == (12, 16, 3)
