"""The port's MLP, Model and whole-image renderer against the JAX package
on the same (bridged) weights, at the 360 config cut to test size.

The JAX side runs with ``use_fused_featurize=True``: its Pallas kernels,
interpreted on the CPU, share the bf16 numerics of the port's fused kernels
(whose plain versions run here).  The two sides then differ where an f32
value lands on the other side of a bf16 rounding boundary; each tolerance
below says how far that carries.
"""

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
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import ginlite  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import mlp as mlp_lib  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

BINDINGS = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS


def _mlp_pair(name, bindings):
  """(JAX module, its variables, port MLP holding the same weights)."""
  tp.configs(BINDINGS + tuple(bindings))
  jmlp = jax_gin.make(name)
  cfg = ginlite.make(name)
  means, covs = tp.gaussians(16 * 8, seed=1, far_frac=0.1)
  viewdirs = tp.rays(16, seed=2)['viewdirs']
  inputs = (means.reshape(16, 8, 3), covs.reshape(16, 8, 3, 3), viewdirs)
  variables = jmlp.init(jax.random.PRNGKey(3), None,
                        (jnp.asarray(inputs[0]), jnp.asarray(inputs[1])),
                        viewdirs=jnp.asarray(viewdirs))
  model = mlp_lib.MLP(cfg, generator=torch.Generator().manual_seed(0),
                      device='cpu')
  bridge.load_jax_params(model, variables['params'])
  return jmlp, variables, model, inputs


@pytest.mark.parametrize('name,trunk_dtype', [('PropMLP', 'float32'),
                                              ('NerfMLP', 'float32'),
                                              ('NerfMLP', 'bfloat16')])
def test_mlp_matches_jax(name, trunk_dtype):
  jmlp, variables, model, (means, covs, viewdirs) = _mlp_pair(
      name, [f"{name}.trunk_dtype = '{trunk_dtype}'"])
  want = jmlp.apply(variables, None, (jnp.asarray(means), jnp.asarray(covs)),
                    viewdirs=jnp.asarray(viewdirs))
  with torch.inference_mode():
    got = model(torch.as_tensor(means), torch.as_tensor(covs),
                torch.as_tensor(viewdirs))
  # Densities and colors are O(1).  A bf16 boundary crossing moves one
  # feature or (bf16 trunk) activation by 2^-8 of itself; through the
  # layers that stays under 1e-2 here, against O(1) outputs.  f32 trunks
  # are tighter.
  tol = 1e-2 if trunk_dtype == 'bfloat16' else 3e-3
  tp.assert_close(got['density'].numpy(), want['density'], atol=tol,
                  rtol=tol, what='density')
  tp.assert_close(got['rgb'].numpy(), want['rgb'], atol=tol, what='rgb')
  if name == 'PropMLP':
    np.testing.assert_array_equal(got['rgb'].numpy(), 0.0)


def _model_pair(extra=()):
  """(JAX config, JAX model, its params, port config, port Model)."""
  jax_config, torch_config = tp.configs(BINDINGS + tuple(extra))
  params = tp.jax_params(jax_config)
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  return jax_config, jmodel, params, torch_config, model


def test_model_forward_matches_jax():
  _, jmodel, params, _, model = _model_pair()
  fields = tp.rays(24, seed=4)
  want_r, want_h = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, None, r, train_frac=1.0, compute_extras=True))(
          params, tp.jax_rays(fields))
  with torch.inference_mode():
    got_r, got_h = model(tp.torch_rays(fields), 1.0, True)
  assert len(got_h) == len(want_h) == 3
  # Per level: the sampled normalized distances and the weights.  A level's
  # samples depend on the previous level's densities, so the bf16-level
  # gaps of the MLPs (see test_mlp_matches_jax) carry into where the next
  # level samples: 2e-3 of the [0, 1] distance range and 3e-3 of the
  # weights bound them (4e-4 and 1.5e-3 measured over three seeds).
  for level, (g, w) in enumerate(zip(got_h, want_h)):
    tp.assert_close(g['sdist'].numpy(), w['sdist'], atol=2e-3,
                    what=f'level {level} sdist')
    tp.assert_close(g['weights'].numpy(), w['weights'], atol=3e-3,
                    what=f'level {level} weights')
  _check_rendering({k: v.numpy() for k, v in got_r[-1].items()},
                   want_r[-1], near=0.2)
  for key in ('ray_sdist', 'ray_weights', 'ray_rgbs'):
    assert got_r[-1][key].shape == want_r[-1][key].shape, key


def _check_rendering(got, want, near):
  """The final level's image buffers against JAX's."""
  tp.assert_close(got['rgb'], want['rgb'], atol=3e-3, what='rgb')
  tp.assert_close(got['acc'], want['acc'], atol=3e-3, what='acc')
  # Distances span near = 0.2 .. far = 1e6 on the reciprocal warp, and in
  # the last, widest intervals a tiny weight gap moves a percentile by a
  # large factor in t (37% measured at the 95th).  So they are compared as
  # near / t, i.e. in the normalized distance the sampler works in, with
  # the sdist bound above.
  for key in ('distance_mean', 'distance_median', 'distance_percentile_5',
              'distance_percentile_95'):
    if key in got:
      tp.assert_close(near / got[key], near / np.asarray(want[key]),
                      atol=2e-3, what=f'near / {key}')


def test_whole_image_render_matches_jax_device_renderer():
  extra = ("Config.dataset_loader = 'dummy_unbounded'",
           'Config.render_path = True',
           'Config.render_resolution = (16, 16)')
  jax_config, jmodel, params, torch_config, model = _model_pair(extra)

  def jax_render_fn(variables, train_frac, _, rays):
    return jmodel.apply(variables, None, rays, train_frac=train_frac,
                        compute_extras=True)

  jax_renderer = jnerf.DeviceImageRenderer(
      jax_render_fn, jax_config,
      jdatasets.load_dataset('test', None, jax_config))
  want = jax_renderer({'params': params}, 1.0, 5)
  renderer = nerf.DeviceImageRenderer(
      train_lib.create_render_fn(model), torch_config,
      datasets.load_dataset('test', None, torch_config), 'cpu')
  got = renderer(1.0, 5)
  assert got['rgb'].shape == want['rgb'].shape == (16, 16, 3)
  _check_rendering(got, want, near=0.2)
  for key in ('ray_sdist', 'ray_weights', 'ray_rgbs'):
    assert [g.shape for g in got[key]] == [w.shape for w in want[key]], key


def test_renderer_chunking_and_padding_leave_the_frame_unchanged():
  # 16 x 16 = 256 rays in chunks of 100: three chunks, the last one padded
  # with 44 clamped duplicates that assembly must drop.
  frames = {}
  for chunk in (256, 100):
    _, torch_config = tp.configs(tp.SMALL_BINDINGS + (
        "Config.dataset_loader = 'dummy_unbounded'",
        'Config.render_path = True', 'Config.render_resolution = (16, 16)',
        f'Config.render_chunk_size = {chunk}'))
    model = nerf.construct_model(torch_config,
                                 torch.Generator().manual_seed(0), 'cpu')
    frames[chunk] = nerf.DeviceImageRenderer(
        train_lib.create_render_fn(model), torch_config,
        datasets.load_dataset('test', None, torch_config), 'cpu')(1.0, 3)
  for key in ('rgb', 'acc', 'distance_mean', 'distance_median'):
    # Only the products' blocking differs with the batch size.
    np.testing.assert_allclose(frames[100][key], frames[256][key],
                               rtol=1e-5, atol=1e-6, err_msg=key)
  assert frames[100]['ray_sdist'][0].shape == (16, 9)


def test_dataset_cameras_and_images_match_jax():
  extra = ("Config.dataset_loader = 'dummy_unbounded'",)
  jax_config, torch_config = tp.configs(extra)
  want = jdatasets.load_dataset('test', None, jax_config)
  got = datasets.load_dataset('test', None, torch_config)
  assert (got.size, got.height, got.width) == (48, 64, 64)
  assert (got.near, got.far) == (0.2, 1e6)
  np.testing.assert_array_equal(got.camtoworlds, want.camtoworlds)
  np.testing.assert_array_equal(got.pixtocams, want.pixtocams)
  np.testing.assert_allclose(got.images, want.images, atol=1e-6)


@pytest.mark.parametrize('xnp', ['numpy', 'torch'])
def test_cast_ray_batch_matches_jax(xnp):
  # The dataset's stacked cameras, indexed per ray by cam_idx: the host
  # (numpy) form and the device (torch) form the renderer uses.
  from multinerf_tpu.data import cameras as jcameras
  from multinerf_tpu.data import types as jtypes
  from multinerf_tpu_torch.data import cameras
  from multinerf_tpu_torch.data import types
  _, torch_config = tp.configs(("Config.dataset_loader = 'dummy_unbounded'",))
  dataset = datasets.load_dataset('test', None, torch_config)
  rng = np.random.RandomState(11)
  n = 40
  fields = dict(pix_x_int=rng.randint(0, 64, n),
                pix_y_int=rng.randint(0, 64, n),
                lossmult=np.ones((n, 1), np.float32),
                near=np.full((n, 1), 0.2, np.float32),
                far=np.full((n, 1), 1e6, np.float32),
                cam_idx=rng.randint(0, dataset.size, (n, 1)))
  pixtocams, camtoworlds, _, _ = dataset.cameras
  cams = (pixtocams.astype(np.float32), camtoworlds.astype(np.float32), None,
          None)
  want = jcameras.cast_ray_batch(
      tuple(None if c is None else jnp.asarray(c) for c in cams),
      jtypes.Pixels(**{k: jnp.asarray(v) for k, v in fields.items()}),
      xnp=jnp)
  if xnp == 'torch':
    got = cameras.cast_ray_batch(
        tuple(None if c is None else torch.as_tensor(c) for c in cams),
        types.Pixels(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        xnp=torch)
  else:
    got = cameras.cast_ray_batch(cams, types.Pixels(**fields), xnp=np)
  for key in ('origins', 'directions', 'viewdirs', 'radii', 'imageplane'):
    tp.assert_close(np.asarray(getattr(got, key)),
                    np.asarray(getattr(want, key)), atol=1e-6, rtol=1e-6,
                    what=key)


@pytest.mark.parametrize('bindings,match', [
    (["NerfMLP.trunk_dtype = 'float16'"], 'float16'),
])
def test_unported_options_raise(bindings, match):
  _, torch_config = tp.configs(tp.SMALL_BINDINGS + tuple(bindings))
  with pytest.raises(NotImplementedError, match=match):
    nerf.construct_model(torch_config, torch.Generator().manual_seed(0),
                         'cpu')


@pytest.mark.parametrize('mode', ['int8', 'int8_hybrid'])
def test_int8_trunks_take_density_normals(mode):
  """Once refused: an int8 NerfMLP with density normals runs unfused, its
  normals the negated, normalized density gradient through the int8
  products (tests/test_torch_int8_normals.py holds them against JAX)."""
  _, torch_config = tp.configs(tp.SMALL_BINDINGS + (
      'NerfMLP.disable_density_normals = False',
      f"NerfMLP.trunk_dtype = '{mode}'"))
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  assert model.NerfMLP_0.int8 and not model.NerfMLP_0.fused
  renderings, history = train_lib.create_render_fn(model)(
      1.0, tp.torch_rays(tp.rays(4)))
  normals, grad = history[-1]['normals'], history[-1]['raw_grad_density']
  assert normals.shape == grad.shape == (4, 8, 3)
  assert torch.isfinite(renderings[-1]['normals']).all()
  np.testing.assert_allclose(
      normals.numpy(),
      -(grad / torch.linalg.vector_norm(grad, dim=-1, keepdim=True)).numpy(),
      atol=1e-5)


@pytest.mark.parametrize('bindings,table,shape', [
    (['Model.learned_exposure_scaling = True', 'Config.rawnerf_mode = True'],
     'exposure_scaling_offsets/embedding', (1000, 3)),
    (['Model.num_glo_features = 4'], 'Embed_0/embedding', (1000, 4)),
])
def test_model_zoo_tables_have_the_flax_names(bindings, table, shape):
  """The exposure scaling and GLO tables, once refused, under JAX's names
  (tests/test_torch_glo.py and tests/test_torch_rawnerf.py hold their
  models against JAX)."""
  _, torch_config = tp.configs(tp.SMALL_BINDINGS + tuple(bindings))
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  named = bridge.named_parameters(model)
  assert tuple(named[table].shape) == shape
  if table.startswith('exposure'):
    assert not named[table].any()  # Every scaling starts at 1.
  else:
    assert 0.4 < float(named[table].std()) < 0.6  # flax: 1 / sqrt(4).
