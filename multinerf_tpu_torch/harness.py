"""What the quality harnesses share: ``cull_quality``, ``keep_frac_probe``
and ``int8_eval_decision`` (ports of scripts/cull_quality_experiment.py,
scripts/keep_frac_probe.py and scripts/int8_eval_decision.py).

The bindings are those scripts' own lists.  Like them, a harness parses its
bindings and then builds ``Config`` directly from keyword arguments, so the
Model's and the MLPs' settings come from the bindings and the Config's from
the arguments and its defaults (a ``Config.*`` binding in a gin file is not
read).  Held-out PSNR is -10 log10 of the mean squared error of a rendered
test view, as the scripts score it; a frame's seconds are the host clock
around the render, which ends in the frame's copy to the host.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import ginlite
from multinerf_tpu_torch import train_lib

# The flagship sampling geometry: contraction, reciprocal ray distances, two
# proposal levels of 64 samples and 32 NerfMLP samples, at debug or 360.gin
# widths (scripts/cull_quality_experiment.py:40-57).
BASE_BINDINGS = [
    'Model.raydist_fn = @jnp.reciprocal',
    'Model.opaque_background = True',
    'PropMLP.warp_fn = @coord.contract',
    'PropMLP.disable_density_normals = True',
    'PropMLP.disable_rgb = True',
    'NerfMLP.warp_fn = @coord.contract',
    'NerfMLP.disable_density_normals = True',
]
DEBUG_WIDTHS = [
    'PropMLP.net_depth = 2', 'PropMLP.net_width = 64',
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 128',
]
FLAGSHIP_WIDTHS = [
    'PropMLP.net_depth = 4', 'PropMLP.net_width = 256',
    'NerfMLP.net_depth = 8', 'NerfMLP.net_width = 1024',
]
# scripts/int8_eval_decision.py:56-85: the 360 arm (the same bindings as
# BASE_BINDINGS + FLAGSHIP_WIDTHS) and the Ref-NeRF head stack at flagship
# width with density-gradient normals on, as configs/blender_refnerf.gin.
FLAGSHIP = BASE_BINDINGS + FLAGSHIP_WIDTHS
REFNERF = [
    'Model.single_mlp = True',
    'Model.num_levels = 2',
    'Model.num_prop_samples = 64',
    'Model.num_nerf_samples = 32',
    'NerfMLP.net_depth = 8', 'NerfMLP.net_width = 1024',
    'NerfMLP.disable_density_normals = False',
    'NerfMLP.enable_pred_normals = True',
    'NerfMLP.use_directional_enc = True',
    'NerfMLP.use_reflections = True',
    'NerfMLP.use_specular_tint = True',
    'NerfMLP.enable_pred_roughness = True',
    'NerfMLP.use_diffuse_color = True',
    'NerfMLP.use_n_dot_v = True',
    'NerfMLP.bottleneck_width = 128',
]
# The Config both training harnesses build (cull_quality_experiment.py:80-84,
# int8_eval_decision.py:107-110), beside the loader, batch, near, far and
# steps.
TRAIN_SETTINGS = dict(
    data_loss_type='mse', render_chunk_size=8192, lr_init=2e-3,
    lr_final=2e-5, lr_delay_steps=512, lr_delay_mult=0.01)
# Where the harnesses write: the JAX scripts write to docs/, which holds the
# TPU's records.
OUT_DIR = os.path.join('docs', 'torch')
CONFIG_360 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', '360.gin')


def trunk_bindings(trunk_dtype):
  """Both MLPs' trunk on `trunk_dtype` ('float32' binds nothing)."""
  if trunk_dtype == 'float32':
    return []
  return [f'NerfMLP.trunk_dtype = "{trunk_dtype}"',
          f'PropMLP.trunk_dtype = "{trunk_dtype}"']


def make_config(bindings, gin_files=(), **kwargs):
  """Clear earlier bindings, parse `gin_files` and `bindings`, and return
  ``Config(**kwargs)``."""
  ginlite.clear_config()
  ginlite.parse_config_files_and_bindings(list(gin_files), list(bindings))
  return configs.Config(**kwargs)


def device_name(device):
  """The card's name and power limit as ``nvidia-smi --query-gpu=
  name,power.limit --format=csv,noheader`` prints them on a CUDA device;
  'cpu' otherwise."""
  device = torch.device(device)
  if device.type != 'cuda':
    return 'cpu'
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return smi.stdout.strip().splitlines()[device.index or 0]


def train_batches(dataset, device, steps):
  """(step, train_frac, batch on `device`) for steps 1..`steps`: train_frac
  as the scripts set it, (step - 1) / (steps - 1) in [0, 1]; each batch
  after the first is copied once the consumer has launched the step before
  it (``train_lib.Prefetcher``)."""
  prefetcher = train_lib.Prefetcher(dataset, device)
  for step in range(1, steps + 1):
    batch = prefetcher.take()
    yield step, float(np.clip((step - 1) / max(steps - 1, 1), 0, 1)), batch
    if step < steps:
      prefetcher.stage()


def psnr(rgb, target):
  """-10 log10 of the mean squared error of `rgb` against `target`."""
  mse = float(np.mean((np.asarray(rgb, np.float64) - target)**2))
  return float(-10 * np.log10(mse))


def render_psnrs(renderer, cases, train_frac):
  """([PSNR of each test case], mean seconds a frame): each case's rays
  rendered through `renderer` (a ``models.nerf.ImageRenderer``) and scored
  against its rgb."""
  psnrs = []
  t0 = time.perf_counter()
  for case in cases:
    rendering = renderer.render_rays(train_frac, case.rays)
    psnrs.append(psnr(rendering['rgb'], case.rgb))
  return psnrs, (time.perf_counter() - t0) / len(cases)
