"""Shared setup of the PyTorch port's parity tests (tests/test_torch_*.py).

Caps torch's CPU threads (tier-1 runs pytest-xdist with several workers),
and builds the same small configuration, inputs and weights for the JAX
package and the port: inputs come from numpy with a fixed seed, weights
from the JAX initializer, passed to the port through the bridge.
"""

import os

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG_360 = os.path.join(REPO, 'configs', '360.gin')

# The 360 config cut to test size: PropMLP 2 x 32, NerfMLP depth 6 (its
# skip at layer 5 is still hit: (6 - 1) % 4 != 0) and width 64, 8 samples
# per level.
SMALL_BINDINGS = (
    'PropMLP.net_depth = 2',
    'PropMLP.net_width = 32',
    'NerfMLP.net_depth = 6',
    'NerfMLP.net_width = 64',
    'NerfMLP.bottleneck_width = 32',
    'NerfMLP.net_width_viewdirs = 32',
    'Model.num_prop_samples = 8',
    'Model.num_nerf_samples = 8',
)
# The JAX MLP takes the Pallas kernels (interpreted on the CPU) only when
# asked; the port always runs its fused kernels (on the CPU: their plain
# versions).  With these bindings both sides share the bf16 numerics.
FUSED_BINDINGS = (
    'NerfMLP.use_fused_featurize = True',
    'PropMLP.use_fused_featurize = True',
)


def configs(bindings=(), files=(CONFIG_360,)):
  """(JAX Config, port Config) parsed from the same files and bindings."""
  from multinerf_tpu import configs as jax_configs
  from multinerf_tpu import ginlite as jax_gin
  from multinerf_tpu_torch import configs as torch_configs
  from multinerf_tpu_torch import ginlite as torch_gin
  del jax_configs, torch_configs  # Imported to register the externals.
  out = []
  for gin in (jax_gin, torch_gin):
    gin.clear_config()
    gin.parse_config_files_and_bindings(list(files), list(bindings))
    out.append(gin.make('Config'))
  return tuple(out)


def jax_params(config, seed=0, shapes_only=False):
  """The 'params' tree of JAX ``construct_model`` for `config`, built under
  jit (or only traced, for its names and shapes)."""
  import jax
  from multinerf_tpu.data import types
  from multinerf_tpu.models import nerf
  dummy = types.dummy_rays(include_exposure_values=True)
  init = lambda key: nerf.construct_model(key, dummy, config)[1]['params']
  key = jax.random.PRNGKey(seed)
  return jax.eval_shape(init, key) if shapes_only else jax.jit(init)(key)


def gaussians(n, seed=0, far_frac=0.0):
  """numpy (means [n, 3], covs [n, 3, 3]) as in tests/test_pallas_*.py;
  a fraction `far_frac` of the means is moved to radius 1e3..1e6."""
  rng = np.random.RandomState(seed)
  means = (rng.randn(n, 3) * 2.0).astype(np.float32)
  far = rng.rand(n) < far_frac
  dirs = rng.randn(n, 3)
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  radius = 10.0**rng.uniform(3, 6, n)
  means[far] = (dirs * radius[:, None])[far].astype(np.float32)
  a = rng.randn(n, 3, 3).astype(np.float32) * 0.05
  return means, (a @ np.swapaxes(a, -1, -2)).astype(np.float32)


def rays(n, seed=0, near=0.2, far=1e6):
  """numpy ray fields of a 360-style batch: origins near the scene
  center, unit-ish directions, small cone radii."""
  rng = np.random.RandomState(seed)
  origins = (rng.randn(n, 3) * 0.5).astype(np.float32)
  directions = rng.randn(n, 3).astype(np.float32)
  directions *= rng.uniform(0.8, 1.2, (n, 1)).astype(np.float32)
  viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
  ones = np.ones((n, 1), np.float32)
  return dict(origins=origins, directions=directions,
              viewdirs=viewdirs.astype(np.float32),
              radii=rng.uniform(1e-3, 1e-2, (n, 1)).astype(np.float32),
              imageplane=np.zeros((n, 2), np.float32), lossmult=ones,
              near=near * ones, far=far * ones,
              cam_idx=np.zeros((n, 1), np.int32))


def jax_rays(fields):
  import jax.numpy as jnp
  from multinerf_tpu.data import types
  return types.Rays(**{k: jnp.asarray(v) for k, v in fields.items()})


def torch_rays(fields):
  from multinerf_tpu_torch.data import types
  return types.Rays(**{k: torch.as_tensor(v) for k, v in fields.items()})


def assert_close(got, want, atol, rtol=0.0, what=''):
  """max |got - want| <= atol + rtol * |want| elementwise, with a message
  that names the largest gap."""
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  gap = np.where(got == want, 0.0, np.abs(got - want))  # inf == inf.
  bound = atol + rtol * np.abs(want)
  worst = np.unravel_index(np.argmax(gap - bound), gap.shape)
  assert np.all(gap <= bound), (
      f'{what}: max gap {gap.max():.3e}; at {worst} got {got[worst]!r} '
      f'want {want[worst]!r} (bound {bound[worst]:.3e})')
