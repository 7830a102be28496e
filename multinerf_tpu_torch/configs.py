"""The Config dataclass and config loading (port of multinerf_tpu.configs).

The field set, names and defaults are those of ``multinerf_tpu.configs.
Config``, so every ``configs/*.gin`` file and ``--gin_bindings`` override
parses unchanged.  The gin externals keep the names the .gin files use
(``@jnp.reciprocal``, ``@coord.contract``, ...) and are bound to their
PyTorch counterparts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multinerf_tpu_torch import ginlite
from multinerf_tpu_torch.models import initializers
from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.ops import mathx
from multinerf_tpu_torch.parallel import mesh

# --- gin externals: names configs refer to with '@'. ------------------------
for _name, _fn in [
    ('jnp.reciprocal', torch.reciprocal), ('jnp.log', torch.log),
    ('jnp.log1p', torch.log1p), ('jnp.exp', torch.exp),
    ('jnp.sqrt', torch.sqrt), ('jnp.square', torch.square),
    ('jax.nn.relu', torch.relu), ('jax.nn.softplus', F.softplus),
    ('jax.nn.silu', F.silu),
    ('jax.nn.initializers.he_normal', initializers.he_normal),
    ('jax.nn.initializers.he_uniform', initializers.he_uniform),
    ('jax.nn.initializers.glorot_normal', initializers.glorot_normal),
    ('jax.nn.initializers.glorot_uniform', initializers.glorot_uniform),
    ('coord.contract', coord.contract),
    ('math.safe_exp', mathx.safe_exp),
    ('mathx.safe_exp', mathx.safe_exp),
]:
  ginlite.register_external(_name, _fn)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@ginlite.configurable(name='Config')
@dataclasses.dataclass
class Config:
  """Configuration flags for everything (see multinerf_tpu.configs)."""
  # --- Data / dataset. -------------------------------------------------------
  dataset_loader: str = 'llff'
  batching: str = 'all_images'
  batch_size: int = 16384
  patch_size: int = 1
  factor: int = 0
  load_alphabetical: bool = True
  forward_facing: bool = False
  render_path: bool = False
  llffhold: int = 8
  llff_use_all_images_for_training: bool = False
  use_tiffs: bool = False
  dtu_light_cond: int = 3
  dtuhold: int = 8
  compute_disp_metrics: bool = False
  compute_normal_metrics: bool = False
  gc_every: int = 10000
  profile_step: int = 0
  profile_num_steps: int = 3
  disable_multiscale_loss: bool = False
  randomized: bool = True
  near: float = 2.0
  far: float = 6.0
  checkpoint_dir: Optional[str] = None
  render_dir: Optional[str] = None
  data_dir: Optional[str] = None
  vocab_tree_path: Optional[str] = None
  render_chunk_size: int = 16384  # Rays per chunk of a whole-image render.
  render_scan_chunks: bool = True
  num_showcase_images: int = 5
  deterministic_showcase: bool = True
  vis_num_rays: int = 16
  vis_decimate: int = 0

  # --- Train. ----------------------------------------------------------------
  max_steps: int = 250000
  early_exit_steps: Optional[int] = None
  checkpoint_every: int = 25000
  print_every: int = 100
  train_render_every: int = 5000
  cast_rays_in_train_step: bool = False
  device_data_plane: bool = False
  steps_per_jit_call: int = 1
  occupancy_culling: bool = False
  occupancy_grid_resolution: int = 64
  occupancy_grid_decay: float = 0.97
  occupancy_threshold: float = 5e-3
  occupancy_keep_rule: str = 'density'
  occupancy_alpha_eps: float = 1e-3
  occupancy_capacity_frac: float = 0.5
  occupancy_capacity_ladder: Optional[Tuple[float, ...]] = None
  occupancy_warmup_steps: int = 512
  occupancy_grid_refresh_every: int = 256
  data_loss_type: str = 'charb'
  charb_padding: float = 0.001
  data_loss_mult: float = 1.0
  data_coarse_loss_mult: float = 0.0
  interlevel_loss_mult: float = 1.0
  orientation_loss_mult: float = 0.0
  orientation_coarse_loss_mult: float = 0.0
  robustnerf_inlier_quantile: float = 0.5
  enable_robustnerf_loss: bool = False
  robustnerf_inner_patch_size: int = 8
  robustnerf_smoothed_filter_size: int = 3
  robustnerf_smoothed_inlier_quantile: float = 0.5
  robustnerf_inner_patch_inlier_quantile: float = 0.5
  orientation_loss_target: str = 'normals_pred'
  predicted_normal_loss_mult: float = 0.0
  predicted_normal_coarse_loss_mult: float = 0.0
  weight_decay_mults: Dict[str, Any] = dataclasses.field(default_factory=dict)

  lr_init: float = 0.002
  lr_final: float = 0.00002
  lr_delay_steps: int = 512
  lr_delay_mult: float = 0.01
  adam_beta1: float = 0.9
  adam_beta2: float = 0.999
  adam_eps: float = 1e-6
  grad_max_norm: float = 0.001
  grad_max_val: float = 0.0
  distortion_loss_mult: float = 0.01

  # --- Eval. -----------------------------------------------------------------
  eval_only_once: bool = True
  eval_save_output: bool = True
  eval_save_ray_data: bool = False
  eval_render_interval: int = 1
  eval_dataset_limit: int = int(np.iinfo(np.int32).max)
  eval_quantize_metrics: bool = True
  eval_crop_borders: int = 0
  lpips_weights_path: Optional[str] = None

  # --- Render. ---------------------------------------------------------------
  render_video_fps: int = 60
  render_video_crf: int = 18
  render_path_frames: int = 120
  z_variation: float = 0.0
  z_phase: float = 0.0
  render_dist_percentile: float = 0.5
  render_dist_curve_fn: Callable[..., Any] = np.log  # Applied to host frames.
  render_path_file: Optional[str] = None
  render_job_id: int = 0
  render_num_jobs: int = 1
  render_resolution: Optional[Tuple[int, int]] = None  # (width, height).
  render_focal: Optional[float] = None
  render_camtype: Optional[str] = None
  render_spherical: bool = False
  render_save_async: bool = True
  render_spline_keyframes: Optional[str] = None
  render_spline_n_interp: int = 30
  render_spline_degree: int = 5
  render_spline_smoothness: float = 0.03
  render_spline_interpolate_exposure: bool = False

  # --- Raw datasets (RawNeRF). ------------------------------------------------
  rawnerf_mode: bool = False
  exposure_percentile: float = 97.0
  num_border_pixels_to_mask: int = 0
  apply_bayer_mask: bool = False
  autoexpose_renders: bool = False
  eval_raw_affine_cc: bool = False


def add_common_flags(parser: argparse.ArgumentParser):
  """The JAX CLI's flags: repeatable --gin_configs and --gin_bindings, and
  absl's --logtostderr, which the launchers scripts/{train,eval,render}_*.sh
  pass: it only routes absl's logs to stderr, and the port logs there
  already, so it does nothing."""
  parser.add_argument('--gin_configs', action='append', default=[],
                      help='Gin config files.')
  parser.add_argument('--gin_bindings', action='append', default=[],
                      help='Gin parameter bindings.')
  parser.add_argument('--logtostderr', action='store_true',
                      help='Accepted for the JAX launchers; does nothing.')


def parse_entry_flags(description, argv=None):
  """The flags of the train, eval and render entry points:
  add_common_flags and add_device_flags, parsed from `argv`."""
  parser = argparse.ArgumentParser(description=description)
  add_common_flags(parser)
  add_device_flags(parser)
  return parser.parse_args(argv)


def add_device_flags(parser: argparse.ArgumentParser):
  """The entry points' --device flag."""
  parser.add_argument('--device', default='cuda',
                      help="torch device: 'cuda' (default; under "
                      "torch.distributed.run each rank's own card, "
                      "cuda:LOCAL_RANK), 'cuda:i' or 'cpu'.")


def setup_device(requested='cuda', backend=None) -> torch.device:
  """This process's device for the `requested` one, after joining the
  process group when ``torch.distributed.run`` launched it (NCCL on cards,
  gloo on the CPU, unless `backend` names one).  A CUDA device fails when
  CUDA is not available: there is no CPU fallback."""
  device = torch.device(requested)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'--device={requested} but CUDA is not available.')
  # The configs' hidden layers are float32: keep their products in full f32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  device = mesh.local_device(device)
  mesh.init_from_env(device, backend)
  return device


def load_config(args, save_config=False):
  """Parse the gin files and bindings of parsed `args` into a Config; with
  `save_config`, rank 0 writes the resolved bindings to ``config.gin`` in
  ``Config.checkpoint_dir`` (configs.py:222-233 of the JAX package).  The
  batch must divide over the ranks (train.py:123 of the JAX package).

  Earlier bindings are cleared first, so one process can load several
  configurations in turn.
  """
  ginlite.clear_config()
  ginlite.add_search_path(_REPO_ROOT)
  ginlite.parse_config_files_and_bindings(args.gin_configs, args.gin_bindings)
  config = ginlite.make('Config')
  if config.batch_size % mesh.data_size():
    raise ValueError('Batch size must be divisible by the number of '
                     'processes.')
  if save_config and config.checkpoint_dir is None:
    raise ValueError('Config.checkpoint_dir must name the output directory.')
  if save_config and mesh.is_main():
    os.makedirs(config.checkpoint_dir, exist_ok=True)
    with open(os.path.join(config.checkpoint_dir, 'config.gin'), 'w') as f:
      f.write(ginlite.config_str())
  return config
