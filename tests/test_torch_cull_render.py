"""Grid-culled rendering: ``train_lib.create_render_fn(model, cull=...)``
through the port's ``ImageRenderer`` and ``DeviceImageRenderer`` against
JAX's ``ImageRenderer`` over ``create_render_fn(model, mesh, cull=...)``,
on the same weights and occupancy grid (through the bridge), rng None.

The scene is ``dummy_sphere`` (32 x 32 test views, near 2, far 6) at the
small widths of tests/helpers/torch_parity.py with an 8^3 grid whose cells
on the x < 0 side of contracted space are empty.  Chunks of 384 rays cut a
1,024-ray frame into 3, the last padded by edge replication with 128
copies of the last ray, which count toward that chunk's capacity on both
sides.

Tolerances, as tests/test_torch_culling.py's culled Model (3e-3 for colors
and opacity; the distances as near / t within 2e-3, the whole-image bound
of tests/test_torch_render_many.py), twice those under the int8 trunk
(tests/test_torch_int8_trunk.py: a one-step flip of an int8 value moves it
by 1/127 of its row's absmax).
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import types  # noqa: E402
from multinerf_tpu_torch.models import culling  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t  # noqa: E402

RESOLUTION = 8
CHUNK = 384
CAM = 3
CONFIG_FRAC = 0.75  # Config.occupancy_capacity_frac: what cull=True reads.
SCENE = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
    "Config.dataset_loader = 'dummy_sphere'", 'Config.near = 2.0',
    'Config.far = 6.0', f'Config.render_chunk_size = {CHUNK}')
CULL = ('Config.occupancy_culling = True',
        f'Config.occupancy_grid_resolution = {RESOLUTION}',
        f'Config.occupancy_capacity_frac = {CONFIG_FRAC}')
BOUNDS = {'rgb': 3e-3, 'acc': 3e-3, 'near/distance': 2e-3}


def _half_grid():
  """Cells on the x < 0 side of contracted space empty, the others dense
  (tests/test_torch_culling.py's grid)."""
  grid = np.zeros((RESOLUTION,) * 3, np.float32)
  grid[RESOLUTION // 2:] = np.random.RandomState(5).uniform(
      0.5, 2.0, grid[RESOLUTION // 2:].shape)
  return grid.reshape(-1)


def _pair(extra):
  """(JAX config, JAX model, variables with the half grid, port config,
  port Model holding the same)."""
  jax_config, torch_config = tp.configs(SCENE + CULL + tuple(extra))
  variables = {'params': tp.jax_params(jax_config, seed=7),
               'occupancy': {'grid': _half_grid()}}
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_variables(model, variables)
  return jax_config, jmodel, variables, torch_config, model


def _chunk_keep_fracs(render_fn, rays):
  """Each chunk's share of final-level samples the grid keeps (the last
  sample of every ray forced, as opaque_background does), read from the
  culled render of that chunk: the frame padded to whole chunks by edge
  replication, as both renderers pad it."""
  n = rays.origins.shape[0] * rays.origins.shape[1]
  flat = {f.name: np.asarray(getattr(rays, f.name), np.float32).reshape(
      n, -1) for f in dataclasses.fields(rays)
          if getattr(rays, f.name) is not None}
  flat['cam_idx'] = flat['cam_idx'].astype(np.int64)
  fracs = []
  for start in range(0, -(-n // CHUNK) * CHUNK, CHUNK):
    idx = np.minimum(np.arange(start, start + CHUNK), n - 1)
    _, history = render_fn(1.0, types.Rays(
        **{k: torch.as_tensor(v[idx]) for k, v in flat.items()}))
    fracs.append(float(history[-1]['occ_keep_frac']))
  return fracs


def _hold(got, want, bounds, near, what):
  for key in ('rgb', 'acc'):
    tp.assert_close(got[key], np.asarray(want[key]), atol=bounds[key],
                    what=f'{what} {key}')
  for key in ('distance_mean', 'distance_median'):
    tp.assert_close(near / got[key], near / np.asarray(want[key]),
                    atol=bounds['near/distance'], what=f'{what} {key}')


# (trunk, cull, whether some chunk keeps more samples than its capacity):
# the chunks keep 0.62, 0.61 and 0.43 of their samples.
CASES = [('bfloat16', 0.7, False), ('bfloat16', 0.33, True),
         ('bfloat16', True, False), ('int8', 0.5, True)]


@pytest.fixture(scope='module')
def pairs():
  """{trunk: _pair} for the trunks of CASES, built once."""
  out = {}

  def get(trunk):
    if trunk not in out:
      out[trunk] = _pair((f"NerfMLP.trunk_dtype = '{trunk}'",
                          f"PropMLP.trunk_dtype = '{trunk}'"))
    return out[trunk]
  return get


@pytest.mark.parametrize('trunk,cull,overflow', CASES)
def test_culled_render_matches_jax(pairs, trunk, cull, overflow):
  jax_config, jmodel, variables, torch_config, model = pairs(trunk)
  mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
  jrenderer = jnerf.ImageRenderer(
      jtrain_lib.create_render_fn(jmodel, mesh, cull=cull), jax_config,
      mesh=mesh)
  test_data = datasets.load_dataset('test', None, torch_config)
  device = nerf.DeviceImageRenderer(
      train_lib.create_render_fn(model, cull=cull), torch_config, test_data,
      'cpu')
  # Each port renderer against JAX's on the rays it renders: the host's
  # cast, and the cast on the device.  The two casts differ by ulps, which
  # can move a sample across a cell face and flip its keep decision, and
  # with it which samples fill the capacity: JAX's own DeviceImageRenderer
  # and ImageRenderer differ so in a pixel or two of this frame.
  device_rays = device._cast_chunk(0, 32 * 32, CAM)  # pylint: disable=W0212
  want = {
      'ImageRenderer': jrenderer(
          variables, 1.0,
          jdatasets.load_dataset('test', None,
                                 jax_config).generate_ray_batch(CAM).rays),
      'DeviceImageRenderer': jrenderer(variables, 1.0, jtypes.Rays(**{
          f.name: getattr(device_rays, f.name).numpy().reshape(32, 32, -1)
          for f in dataclasses.fields(device_rays)
          if getattr(device_rays, f.name) is not None}))}

  render_fn = train_lib.create_render_fn(model, cull=cull)
  fracs = _chunk_keep_fracs(render_fn,
                            test_data.generate_ray_batch(CAM).rays)
  capacity = CONFIG_FRAC if cull is True else cull
  rounded = culling.round_capacity(CHUNK * 8, capacity) / (CHUNK * 8)
  assert len(fracs) == 3 and all(0 < f < 1 for f in fracs), fracs
  assert (max(fracs) > rounded) == overflow, (fracs, rounded)

  bounds = BOUNDS if trunk == 'bfloat16' else {
      k: 2 * v for k, v in BOUNDS.items()}
  i8t.reset_counts()
  got = {
      'ImageRenderer': nerf.ImageRenderer(render_fn, torch_config, test_data,
                                          'cpu')(1.0, CAM),
      'DeviceImageRenderer': device(1.0, CAM)}
  # The int8 NerfMLP ran K5's plain version on each chunk's compact samples.
  assert i8t.counts['plain_calls'] == (6 if trunk == 'int8' else 0)
  for name, frame in got.items():
    assert frame['rgb'].shape == (32, 32, 3)
    _hold(frame, want[name], bounds, 2.0, name)
  # Culling changed the frame: the grid's empty half reads density 0.
  unculled = nerf.ImageRenderer(train_lib.create_render_fn(model),
                                torch_config, test_data, 'cpu')(1.0, CAM)
  gap = np.abs(unculled['rgb'] - got['ImageRenderer']['rgb']).max()
  assert gap > 10 * bounds['rgb'], gap


def test_cull_needs_the_grid_as_jax():
  jax_config, torch_config = tp.configs(SCENE)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  rays = tp.torch_rays(tp.rays(4))
  for cull in (True, 0.5):
    with pytest.raises(ValueError, match='occupancy_culling'):
      train_lib.create_render_fn(model, cull=cull)
  # None and False render every sample, as JAX's cull=False.
  for cull in (None, False):
    renderings, _ = train_lib.create_render_fn(model, cull=cull)(1.0, rays)
    assert np.isfinite(renderings[-1]['rgb'].numpy()).all()
  jmodel = jax_gin.make('Model', config=jax_config)
  mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
  params = tp.jax_params(jax_config)
  with pytest.raises(ValueError, match='occupancy_culling'):
    jtrain_lib.create_render_fn(jmodel, mesh, cull=True)(
        {'params': params}, 1.0, None, tp.jax_rays(tp.rays(8)))
