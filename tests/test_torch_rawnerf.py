"""RawNeRF (configs/llff_raw.gin, llff_raw_test.gin) in the port against
the JAX package, on raw scenes written here in RawNeRF's layout: a COLMAP
model, ``raw/*.dng`` stubs with ``.npy`` mosaic sidecars and exiftool-style
``*.json`` with three shutter buckets, and the HDR+ test-scene layout
(``raw/train``, ``raw/test``, ``hdrplus_test/merged.dng``).

- The rawnerf-mode ``llff`` loader, both splits, with and without the
  HDR+ layout: images, cameras, ``generate_ray_batch(0)`` and the exposure
  metadata bitwise (the same numpy; the JAX loader's jitted demosaic is
  exact, tests/test_torch_raw.py), the tonemap of ``postprocess_fn``.
- The device sampler's Bayer ``lossmult`` and exposure fields against the
  host's.
- The Model's forward with learned exposure scaling, on bridged weights
  with nonzero offsets: the bounds of tests/test_torch_model.py (3e-3),
  relative here, as ``exp(x - 5)`` colors are O(1e-2).
- One llff_raw.gin step (the rawnerf loss, the Bayer mask, one MLP for
  both levels) by ``train_lib.leaf_gaps``, with the noise off
  (``Config.randomized = False``: the JAX rng=None).
- The noise: density and bottleneck noise drawn from a seeded generator
  have mean 0 and their multiplier as std (within 5 standard errors), and
  nothing is drawn without a generator.
- Eval under llff_raw_test.gin (affine color correction, cropped borders)
  against JAX eval on identical weights, and the train driver's raw
  summaries.
"""

import json
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

import eval as jeval  # noqa: E402
from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.data import raw as jraw  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu.ops import image_ops as jimage_ops  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import eval as eval_lib  # noqa: E402
from multinerf_tpu_torch import render  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import device_sampler  # noqa: E402
from multinerf_tpu_torch.data import raw  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.ops import image_ops  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402
from multinerf_tpu_torch.utils import summary  # noqa: E402

LLFF_RAW = os.path.join(tp.REPO, 'configs', 'llff_raw.gin')
LLFF_RAW_TEST = os.path.join(tp.REPO, 'configs', 'llff_raw_test.gin')
SHUTTERS = ('1/30', '1/120', '1/480')  # Three buckets, brightest first.
RAY_FIELDS = capture.RAY_FIELDS + ('exposure_idx',)
METADATA = ('exposure_idx', 'exposure_values', 'unique_shutters',
            'ShutterSpeed', 'BlackLevel', 'WhiteLevel', 'cam2rgb',
            'exposure')
# llff_raw.gin cut to test size: NerfMLP 6 x 64 for both levels, 8 + 8
# samples.
BINDINGS = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + ('Config.llffhold = 3',)


def _write_raw(raw_dir, names, rng, shape, shutters):
  os.makedirs(raw_dir, exist_ok=True)
  for i, name in enumerate(names):
    base = os.path.join(raw_dir, os.path.splitext(name)[0])
    np.save(base + '.npy', (rng.rand(*shape) * 900 + 64).astype(np.uint16))
    with open(base + '.dng', 'wb') as f:
      f.write(b'placeholder')  # Read through the sidecar.
    with open(base + '.json', 'w') as f:
      json.dump([{
          'BlackLevel': 64, 'WhiteLevel': 1023,
          'AsShotNeutral': '0.55 1.0 0.72',
          'ColorMatrix2': '0.9 -0.2 -0.05 -0.3 1.2 0.1 -0.05 0.15 0.6',
          'NoiseProfile': '0.0002 0.00001',
          'ShutterSpeed': shutters[i % len(shutters)]}], f)


def write_raw_scene(root, n=6, width=32, height=24, testscene=False, seed=0):
  """A forward-facing raw scene of `n` views under `root`; with
  `testscene` the HDR+ layout: the first COLMAP image is the test view,
  shot as a bracket of 3 under ``raw/test`` and merged into
  ``hdrplus_test/merged.dng``."""
  rng = np.random.RandomState(seed)
  names = [f'IMG_{i:04d}.dng' for i in range(n)]
  capture.write_colmap(os.path.join(root, 'sparse', '0'),
                       capture.forward_poses(n), names, 1,
                       (30.0, 30.0, width / 2, height / 2), width, height)
  bounds = np.stack([np.linspace(0.9, 1.3, n), np.linspace(6, 9, n)], -1)
  np.save(os.path.join(root, 'poses_bounds.npy'),
          np.concatenate([np.zeros((n, 15)), bounds], -1))
  if not testscene:
    _write_raw(os.path.join(root, 'raw'), names, rng, (height, width),
               SHUTTERS)
    return
  _write_raw(os.path.join(root, 'raw', 'train'), names[1:], rng,
             (height, width), SHUTTERS)
  _write_raw(os.path.join(root, 'raw', 'test'),
             [f'burst_{i}.dng' for i in range(3)], rng, (height, width),
             ('1/240', '1/60', '1/15'))
  os.makedirs(os.path.join(root, 'hdrplus_test'))
  np.save(os.path.join(root, 'hdrplus_test', 'merged.npy'),
          (rng.rand(height, width) * 3600 + 256).astype(np.uint16))
  with open(os.path.join(root, 'hdrplus_test', 'merged.dng'), 'wb') as f:
    f.write(b'placeholder')


@pytest.mark.parametrize('split,testscene', [
    ('train', False), ('test', False), ('train', True), ('test', True)])
def test_raw_loader_matches_jax(tmp_path, split, testscene):
  write_raw_scene(str(tmp_path), testscene=testscene)
  gin = LLFF_RAW_TEST if testscene else LLFF_RAW
  bindings = ('Config.llffhold = 3',)
  got = capture.assert_loaders_match(split, str(tmp_path), bindings,
                                     files=(gin,))
  jax_config, _ = tp.configs(('Config.batch_size = 64',) + bindings,
                             files=(gin,))
  want = jdatasets.load_dataset(split, str(tmp_path), jax_config)
  for key in METADATA:
    np.testing.assert_array_equal(got.metadata[key], want.metadata[key],
                                  err_msg=key)
  assert got.metadata['exposure_levels'] == want.metadata['exposure_levels']
  got_batch, want_batch = got.generate_ray_batch(0), want.generate_ray_batch(0)
  for key in ('exposure_idx', 'exposure_values'):
    np.testing.assert_array_equal(getattr(got_batch.rays, key),
                                  getattr(want_batch.rays, key), err_msg=key)
  img = got.images[0]
  np.testing.assert_array_equal(got.metadata['postprocess_fn'](img),
                                want.metadata['postprocess_fn'](img))
  np.testing.assert_array_equal(got.metadata['postprocess_fn'](img, None),
                                want.metadata['postprocess_fn'](img, None))
  # Raw training reads level 0 (full resolution); the test split of a
  # plain scene the config's factor 4; the HDR+ test view level 0.
  full = split == 'train' or testscene
  assert got.images.shape[1:3] == ((24, 32) if full else (6, 8))
  assert got.size == {('train', False): 4, ('test', False): 2,
                      ('train', True): 5, ('test', True): 1}[
                          (split, testscene)]


def test_bayer_batches_and_the_device_sampler(tmp_path):
  write_raw_scene(str(tmp_path))
  _, config = tp.configs(('Config.llffhold = 3', 'Config.batch_size = 64'),
                         files=(LLFF_RAW,))
  with datasets.load_dataset('train', str(tmp_path), config) as dataset:
    host = next(dataset)
    assert host.rays.lossmult.shape == (64, 1, 1, 3)
    np.testing.assert_array_equal(host.rays.lossmult.sum(-1), 1.0)
    assert host.rays.exposure_idx.dtype == np.int32
    plane = device_sampler.DeviceDataPlane(dataset, config, 'cpu')
    pix_x, pix_y, cam_idx = plane.draw(torch.Generator().manual_seed(0))
    got = plane.make_batch(pix_x, pix_y, cam_idx)
    want = train_lib.batch_to_device(dataset._make_ray_batch(  # pylint: disable=protected-access
        pix_x.numpy(), pix_y.numpy(), cam_idx.numpy(),
        lossmult=raw.pixels_to_bayer_mask(pix_x.numpy(), pix_y.numpy())),
                                     'cpu')
  assert torch.equal(got.rgb, want.rgb)
  for key in ('lossmult', 'exposure_idx', 'exposure_values', 'cam_idx'):
    g, w = getattr(got.rays, key), getattr(want.rays, key)
    assert g.dtype == w.dtype and torch.equal(g, w), key
  assert set(got.rays.exposure_idx.unique().tolist()) <= {0, 1, 2}


def _raw_params(jax_config, seed):
  """JAX construct_model's params as train_lib.setup_model makes them in
  rawnerf mode (the exposure table exists), with random offsets."""
  dummy = jtypes.dummy_rays(include_exposure_idx=True,
                            include_exposure_values=True)
  params = jax.jit(lambda k: jnerf.construct_model(k, dummy, jax_config)[1][
      'params'])(jax.random.PRNGKey(seed))
  params = jax.device_get(params)
  table = params['exposure_scaling_offsets']['embedding']
  assert table.shape == (1000, 3) and not table.any()
  params['exposure_scaling_offsets']['embedding'] = (
      0.3 * np.random.RandomState(seed).randn(*table.shape)).astype(
          np.float32)
  return params


def _exposure_rays(n, seed):
  fields = tp.rays(n, seed=seed, near=0.0, far=1.0)
  rng = np.random.RandomState(seed + 1)
  fields['origins'] = (fields['origins'] * 0.1).astype(np.float32)
  fields['exposure_idx'] = rng.randint(0, 3, (n, 1)).astype(np.int32)
  fields['exposure_values'] = (
      0.25**fields['exposure_idx']).astype(np.float32)
  return fields


def test_model_with_exposure_scaling_matches_jax():
  jax_config, config = tp.configs(BINDINGS, files=(LLFF_RAW,))
  params = _raw_params(jax_config, seed=2)
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(config, torch.Generator().manual_seed(0),
                               'cpu')
  assert not hasattr(model, 'PropMLP_0')  # Model.single_mlp.
  bridge.load_jax_params(model, params)
  fields = _exposure_rays(24, seed=3)
  want, _ = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, None, r, train_frac=1.0, compute_extras=False))(
          params, jtypes.Rays(**{k: jnp.asarray(v)
                                 for k, v in fields.items()}))
  with torch.inference_mode():
    got, _ = model(tp.torch_rays(fields), 1.0, False)
  assert len(got) == 2
  for level in range(2):
    w = np.asarray(want[level]['rgb'])
    tp.assert_close(got[level]['rgb'].numpy(), w, atol=1e-6, rtol=3e-3,
                    what=f'level {level} rgb')
  # Index 0 is pinned to scale 1: its offsets do not move the colors.
  zero = {k: torch.as_tensor(v) for k, v in fields.items()}
  zero['exposure_idx'] = torch.zeros_like(zero['exposure_idx'])
  with torch.inference_mode():
    before = model(nerf.types.Rays(**zero), 1.0, False)[0][-1]['rgb']
    model.exposure_scaling_offsets.embedding[0] += 5.0
    after = model(nerf.types.Rays(**zero), 1.0, False)[0][-1]['rgb']
  assert torch.equal(before, after)


def _jax_batch(batch):
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      rgb=jnp.asarray(batch.rgb.numpy()))


def test_train_step_matches_jax(tmp_path):
  write_raw_scene(str(tmp_path))
  jax_config, config = tp.configs(BINDINGS + (
      f"Config.data_dir = '{tmp_path}'", 'Config.batch_size = 64',
      'Config.randomized = False'), files=(LLFF_RAW,))
  assert config.data_loss_type == 'rawnerf' and config.apply_bayer_mask
  params = _raw_params(jax_config, seed=4)
  with datasets.load_dataset('train', config.data_dir, config,
                             seed=3) as dataset:
    batch = train_lib.batch_to_device(next(dataset), 'cpu')
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients

  def run(state, b):
    captured = {}

    def recording_clip(grad, cfg):
      captured['grad'] = grad['params']
      return clip(grad, cfg)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), state, b, 0.5, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats, captured['grad']

  run = jax.jit(run)
  want = [jax.device_get(run(jstate, _jax_batch(b)))
          for b in (batch, train_lib.nudge_origins(batch))]
  model, _, _, _, _ = train_lib.setup_model(config, 0, 'cpu')
  bridge.load_jax_params(model, params)
  _, losses, _, grads = train_lib.loss_and_grads(model, config, batch, 0.5)
  for key in ('data', 'distortion'):
    w = float(want[0][0]['losses'][key])
    assert abs(float(losses[key]) - w) <= 1e-3 * abs(w), key
  gaps = train_lib.leaf_gaps({k: v.numpy() for k, v in grads.items()},
                             bridge.flatten(want[0][1]),
                             bridge.flatten(want[1][1]))
  assert len(gaps) == len(grads)
  assert 'exposure_scaling_offsets/embedding' in gaps
  for name, (gap, sens, bound) in gaps.items():
    assert gap <= bound, (f'{name}: relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


def test_noise_statistics():
  _, config = tp.configs(BINDINGS + ('NerfMLP.bottleneck_noise = 0.5',),
                         files=(LLFF_RAW,))
  model = nerf.construct_model(config, torch.Generator().manual_seed(0),
                               'cpu')
  mlp = model.NerfMLP_0
  assert mlp.cfg.density_noise == 1.0
  means, covs = tp.gaussians(64 * 16, seed=5)
  viewdirs = tp.rays(64, seed=6)['viewdirs']
  args = (torch.as_tensor(means).reshape(64, 16, 3),
          torch.as_tensor(covs).reshape(64, 16, 3, 3),
          torch.as_tensor(viewdirs))
  bottlenecks = []
  mlp.view_branch[0].register_forward_pre_hook(
      lambda _, inputs: bottlenecks.append(
          inputs[0][:, :mlp.cfg.bottleneck_width]))
  bias = mlp.cfg.density_bias
  raw_density = lambda d: torch.log(torch.expm1(d.double())) - bias
  with torch.inference_mode():
    clean = mlp(*args)
    again = mlp(*args)
    noisy = mlp(*args, generator=torch.Generator().manual_seed(1))
  assert torch.equal(clean['density'], again['density'])
  assert torch.equal(clean['rgb'], again['rgb'])
  for noise, scale in (
      (raw_density(noisy['density']) - raw_density(clean['density']), 1.0),
      ((bottlenecks[2] - bottlenecks[0]).double(), 0.5)):
    n = noise.numel()
    assert abs(float(noise.mean())) <= 5 * scale / np.sqrt(n)
    assert abs(float(noise.std()) / scale - 1) <= 5 / np.sqrt(2 * n)


def _save(ckpt_dir, params, step):
  flat = {k: torch.tensor(np.asarray(v))
          for k, v in bridge.flatten(params).items()}
  checkpoints.CheckpointManager(ckpt_dir).save(
      step, checkpoints.TrainState(step=step, params=flat))


def _read(out_dir, name):
  with open(os.path.join(out_dir, name)) as f:
    return np.array([float(v) for v in f.read().split()])


def test_eval_with_affine_cc_and_crop_matches_jax(tmp_path):
  data = str(tmp_path / 'scene')
  # 48 x 44: 16 x 12 left by the crop of 16, over SSIM's 11 x 11 window.
  write_raw_scene(data, testscene=True, width=48, height=44)
  port_dir = str(tmp_path / 'port')
  bindings = BINDINGS + (f"Config.data_dir = '{data}'",
                         f"Config.checkpoint_dir = '{port_dir}'",
                         'Config.max_steps = 10')
  jax_config, config = tp.configs(bindings, files=(LLFF_RAW_TEST,))
  assert config.eval_raw_affine_cc and config.eval_crop_borders == 16
  params = _raw_params(jax_config, seed=8)
  _save(port_dir, params, 7)
  out = eval_lib.main(['--device=cpu', f'--gin_configs={LLFF_RAW_TEST}'] + [
      f'--gin_bindings={b}' for b in bindings])

  jax_dir = str(tmp_path / 'jax_preds')
  mesh = mesh_lib.create_mesh()
  _, state, render_pfn, _, _ = jtrain_lib.setup_model(
      jax_config, jax.random.PRNGKey(0), mesh=mesh)
  state = state.replace(params={'params': params}, step=7)
  dataset = jdatasets.load_dataset('test', data, jax_config)
  renderer = jnerf.DeviceImageRenderer(render_pfn, jax_config, dataset,
                                       mesh=mesh)
  postprocess_fn, cc_fn = jeval.make_postprocess_fns(jax_config, dataset)
  assert cc_fn is jraw.match_images_affine
  os.makedirs(jax_dir)
  jeval.evaluate_checkpoint(state, 7, renderer, dataset, jax_config,
                            jax_dir, None, postprocess_fn, cc_fn,
                            jimage_ops.MetricHarness(),
                            device_cast=renderer.supports())
  assert set(os.listdir(out['out_dir'])) == set(os.listdir(jax_dir))
  # The PSNR and SSIM bounds of tests/test_torch_eval.py.
  for name, tol in (('psnr', 1e-2), ('ssim', 5e-3), ('cc_psnr', 1e-2),
                    ('cc_ssim', 5e-3)):
    fname = f'metric_{name}_7.txt'
    got, want = _read(out['out_dir'], fname), _read(jax_dir, fname)
    assert got.shape == want.shape == (1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def test_postprocess_fns_are_the_raw_ones(tmp_path):
  write_raw_scene(str(tmp_path), testscene=True)
  _, config = tp.configs(('Config.llffhold = 3',), files=(LLFF_RAW_TEST,))
  with datasets.load_dataset('test', str(tmp_path), config) as dataset:
    tonemap, cc_fn = image_ops.make_postprocess_fns(config, dataset)
  assert tonemap is dataset.metadata['postprocess_fn']
  assert cc_fn is raw.match_images_affine


def test_driver_logs_the_raw_summaries_and_renders(tmp_path):
  data = str(tmp_path / 'scene')
  write_raw_scene(data, width=64, height=48)  # 16 x 12 test views: SSIM.
  ckpt = str(tmp_path / 'ckpt')
  argv = ['--device=cpu', f'--gin_configs={LLFF_RAW}'] + [
      f'--gin_bindings={b}' for b in BINDINGS + (
          f"Config.data_dir = '{data}'", f"Config.checkpoint_dir = '{ckpt}'",
          'Config.batch_size = 64', 'Config.max_steps = 2',
          'Config.print_every = 1', 'Config.train_render_every = 2',
          'Config.render_chunk_size = 64')]
  out = train.main(argv)
  assert np.isfinite(out['losses']).all()
  events = summary.read_events(ckpt)
  tags = {e['tag'] for e in events}
  for split in ('train', 'test'):
    for k in ('exposure_idx', 'exposure_values', 'unique_shutters'):
      assert f'{split}_{k}' in tags
  assert {f'exposure/scaling_{i}_{j}' for i in range(3)
          for j in range(3)} <= tags
  assert {'test_output_color_raw', 'test_output_color_auto',
          'test_true_auto', 'test_output_color/97',
          'test_true_color/100'} <= tags
  frames = render.main(argv + ['--gin_bindings=Config.render_path = True',
                               '--gin_bindings=Config.render_path_frames = 2'])
  assert frames['frames'] == [0, 1]
  for rendering in frames['renderings'].values():
    assert 0 <= rendering['rgb'].min() and rendering['rgb'].max() <= 1
