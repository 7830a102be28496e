"""The multi-level model and whole-image rendering (port of models/nerf.py).

``Model.forward`` is nerf.py:71-329: per level, dilate -> anneal ->
resample -> stop-gradient -> s_to_t -> cast Gaussians -> MLP -> alpha
weights -> background -> composite, plus the ``ray_*`` visualization
extras.  With a ``torch.Generator`` (the JAX rng) the resampling is
jittered and a background color range is sampled; with None the output is
deterministic.  Gradients reach the MLPs through the densities, colors and
normals of each level.  With ``stop_level_grad`` (the default) the sampled
distances carry none; with ``stop_level_grad=False`` they do, from each
level's samples back through the resampling into the previous levels'
MLPs, which then take the unfused path (nerf.py:95-105: the fused kernels
give the sample positions no gradient).  The normals and roughness of the
Ref-NeRF MLP are composited per level with the extras (nerf.py:291-300).
GLO vectors (nerf.py:117-124) condition the final level's view branch: a
row of the ``Embed_0`` table per training camera, zeros at eval and render
(``zero_glo``).  RawNeRF's colors are scaled by each ray's exposure and,
with ``learned_exposure_scaling``, by a learned RGB scaling per exposure
bucket (``exposure_scaling_offsets``, index 0 pinned to 1; nerf.py:279-290).
With ``Config.occupancy_culling`` the Model carries the occupancy grid, a
buffer of R^3 float32 under the JAX collection's name ``occupancy/grid``
(not a parameter: Adam never sees it), and ``cull`` runs the final level
through ``culling.apply_culled`` on the samples its grid keeps
(nerf.py:207-262); unculled, the final level reports the grid feedback
``occ_cells`` and ``occ_density`` and the keep fraction ``occ_keep_frac``.

``DeviceImageRenderer`` (nerf.py:545-694) uploads the cameras once and casts
every chunk's rays on the device; one frame is a Python loop over chunks of
``Config.render_chunk_size`` rays and one transfer of the assembled frame,
and ``render_many`` renders K cameras with one transfer of the K frames.
``ImageRenderer`` (nerf.py:406-542) renders rays cast on the host, the pano
camera's, through the same chunk loop after one copy of the frame's rays to
the device; ``choose_renderer`` picks between the two as the drivers do.
Across ranks (``parallel/mesh.py``) every chunk divides by the data-axis
size, each rank renders its rows of every chunk (the ranks of a model group
render the same rows, in step), and one all-gather over the data group a
frame gives every rank the whole frame, as the JAX renderers' replicated
outputs do.  Under a model axis ``construct_model`` keeps each rank's part
of the layers that ``parallel/tensor.py``'s layout splits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multinerf_tpu_torch import ginlite
from multinerf_tpu_torch.data import cameras as camera_lib
from multinerf_tpu_torch.data import types
from multinerf_tpu_torch.models import culling
from multinerf_tpu_torch.models import mlp as mlp_lib
from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.ops import rendering
from multinerf_tpu_torch.ops import stepfun
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.parallel import tensor
from multinerf_tpu_torch.utils import trace


def _schlick_ease(t, slope):
  """Schlick's bias curve: 0 -> 0, 1 -> 1, `slope` sets the ramp."""
  return (slope * t) / ((slope - 1) * t + 1)


@ginlite.configurable(name='Model')
@dataclasses.dataclass
class ModelConfig:
  """The fields of multinerf_tpu.models.nerf.Model, same defaults."""
  config: Any = None
  num_prop_samples: int = 64
  num_nerf_samples: int = 32
  num_levels: int = 3
  bg_intensity_range: Tuple[float, ...] = (1.0, 1.0)
  anneal_slope: float = 10.0
  stop_level_grad: bool = True
  use_viewdirs: bool = True
  raydist_fn: Callable[..., Any] = None
  ray_shape: str = 'cone'
  disable_integration: bool = False
  single_jitter: bool = True
  dilation_multiplier: float = 0.5
  dilation_bias: float = 0.0025
  num_glo_features: int = 0
  num_glo_embeddings: int = 1000
  learned_exposure_scaling: bool = False
  near_anneal_rate: Optional[float] = None
  near_anneal_init: float = 0.95
  single_mlp: bool = False
  resample_padding: float = 0.0
  use_gpu_resampling: bool = False
  opaque_background: bool = False


class Embed(nn.Module):
  """flax ``nn.Embed``'s parameter: an ``embedding`` table [num, features]
  looked up by index."""

  def __init__(self, num_embeddings, features, init, device):
    super().__init__()
    self.embedding = nn.Parameter(init((num_embeddings, features)).to(device))

  def forward(self, idx):
    return self.embedding[idx]


class Model(nn.Module):
  """A mip-NeRF 360 model containing all MLPs (NerfMLP_0, PropMLP_0), the
  GLO table (Embed_0), RawNeRF's exposure scaling table
  (exposure_scaling_offsets) and the occupancy grid (occupancy.grid)."""

  def __init__(self, cfg: ModelConfig, *, generator, device):
    super().__init__()
    self.cfg = cfg

    def mlp_config(name):
      mlp_cfg = ginlite.make(name)
      if not cfg.stop_level_grad:
        # Gradients flow through the sample positions, which the fused
        # kernels cut: the MLPs' eligibility check then takes the unfused
        # path (nerf.py:95-105).
        mlp_cfg = dataclasses.replace(mlp_cfg,
                                      inputs_have_stop_gradient=False)
      return mlp_cfg

    # Built in the JAX creation order: NerfMLP first.
    self.NerfMLP_0 = mlp_lib.MLP(mlp_config('NerfMLP'), cfg.use_viewdirs,
                                 cfg.num_glo_features, generator=generator,
                                 device=device)
    if not cfg.single_mlp:
      self.PropMLP_0 = mlp_lib.MLP(mlp_config('PropMLP'), cfg.use_viewdirs,
                                   generator=generator, device=device)
    if cfg.num_glo_features > 0:
      # flax's default embedding init (nerf.py:118): a normal of variance
      # 1 / features.
      self.Embed_0 = Embed(
          cfg.num_glo_embeddings, cfg.num_glo_features,
          lambda shape: torch.randn(shape, generator=generator) /
          math.sqrt(shape[-1]), device)
    # JAX creates the exposure table when its init rays carry exposure
    # indices: with Config.rawnerf_mode (train_lib.py:484).
    if cfg.learned_exposure_scaling and (cfg.config is None or
                                         cfg.config.rawnerf_mode):
      # Zero offsets: every exposure's scaling starts at 1.
      self.exposure_scaling_offsets = Embed(
          cfg.num_glo_embeddings, 3, torch.zeros, device)
    self.track_occupancy = (cfg.config is not None and
                            cfg.config.occupancy_culling)
    if self.track_occupancy:
      self.occupancy = nn.Module()
      self.occupancy.register_buffer('grid', torch.zeros(
          cfg.config.occupancy_grid_resolution**3, device=device))

  def forward(self, rays: types.Rays, train_frac, compute_extras,
              generator=None, zero_glo=True, cull=None):
    """Render a batch of rays through all sampling levels.

    Args:
      rays: a Rays batch on the model's device.
      train_frac: fraction of training done, in [0, 1].
      compute_extras: add the distance statistics and ray bundles.
      generator: a torch.Generator on the rays' device for the jittered
        sampling, the random background and the MLPs' noise, or None for
        deterministic output (the JAX rng=None).
      zero_glo: give the final level zero GLO vectors (eval and render,
        where a camera index names no training image); else each ray's
        ``cam_idx`` row of the GLO table (training).
      cull: None, or the capacity (a rung of the ladder) at which the
        final level runs through the occupancy grid's compaction (needs
        Config.occupancy_culling).

    Returns:
      (renderings, ray_history): per-level rendering dicts and raw results.
    """
    cfg = self.cfg
    if cull is not None and not self.track_occupancy:
      raise ValueError('cull requires Config.occupancy_culling.')
    nerf_mlp = self.NerfMLP_0
    prop_mlp = nerf_mlp if cfg.single_mlp else self.PropMLP_0
    glo_vec = None
    if cfg.num_glo_features > 0:
      if zero_glo:
        glo_vec = torch.zeros(rays.origins.shape[:-1] +
                              (cfg.num_glo_features,),
                              device=rays.origins.device)
      else:
        glo_vec = self.Embed_0(rays.cam_idx[..., 0].long())
    _, s_to_t = coord.construct_ray_warps(cfg.raydist_fn, rays.near,
                                          rays.far)
    if cfg.near_anneal_rate is None:
      init_s_near = 0.0
    else:
      init_s_near = float(np.clip(1 - train_frac / cfg.near_anneal_rate, 0,
                                  cfg.near_anneal_init))
    init_s_far = 1.0
    # The running histogram over normalized ray distance: one interval
    # holding all the mass, resampled finer at every level.
    s_edges = torch.cat([torch.full_like(rays.near, init_s_near),
                         torch.full_like(rays.far, init_s_far)], dim=-1)
    hist_weights = torch.ones_like(rays.near)
    resolution_so_far = 1

    ray_history = []
    renderings = []
    for level in range(cfg.num_levels):
      final_level = level == cfg.num_levels - 1
      level_samples = (cfg.num_nerf_samples if final_level
                       else cfg.num_prop_samples)

      # Everything up to the new sample distances runs without a graph
      # when they are stop-gradient (nerf.py:193-195): nothing else of this
      # block reaches the losses.
      with (torch.no_grad() if cfg.stop_level_grad
            else contextlib.nullcontext()):
        if level > 0 and (cfg.dilation_bias > 0 or
                          cfg.dilation_multiplier > 0):
          pad = (cfg.dilation_bias + cfg.dilation_multiplier *
                 (init_s_far - init_s_near) / resolution_so_far)
          s_edges, hist_weights = stepfun.max_dilate_weights(
              s_edges, hist_weights, pad, domain=(init_s_near, init_s_far),
              renormalize=True)
          s_edges = s_edges[..., 1:-1]
          hist_weights = hist_weights[..., 1:-1]
        resolution_so_far *= level_samples

        ease = (_schlick_ease(train_frac, cfg.anneal_slope)
                if cfg.anneal_slope > 0 else 1.0)
        # Zero-width intervals are pinned to -inf so resampling skips them.
        log_resample_weights = torch.where(
            s_edges[..., 1:] > s_edges[..., :-1],
            ease * torch.log(hist_weights + cfg.resample_padding), -torch.inf)
        s_edges = stepfun.sample_intervals(
            generator, s_edges, log_resample_weights, level_samples,
            single_jitter=cfg.single_jitter,
            domain=(init_s_near, init_s_far),
            use_gpu_resampling=cfg.use_gpu_resampling)

      t_edges = s_to_t(s_edges)
      means, covs = rendering.cast_rays(t_edges, rays.origins,
                                        rays.directions, rays.radii,
                                        cfg.ray_shape)
      if cfg.disable_integration:
        covs = torch.zeros_like(covs)  # Zero covariance: IPE becomes PE.
      mlp = nerf_mlp if final_level else prop_mlp
      viewdirs = rays.viewdirs if cfg.use_viewdirs else None
      if final_level and self.track_occupancy:
        resolution = cfg.config.occupancy_grid_resolution
        cells = culling.cell_ids(means, resolution)
        keep = culling.keep_mask(self.occupancy.grid[cells], cfg.config,
                                 t_edges=t_edges, dirs=rays.directions)
      if cull is not None and final_level:
        if cfg.opaque_background:
          # The last interval's alpha is 1 whatever its density: culled, it
          # would paint the ray with the fill color (black).
          keep[..., -1] = True
        ray_results = culling.apply_culled(
            mlp, means, covs, keep, cull, viewdirs=viewdirs,
            glo_vec=glo_vec, generator=generator, cells=cells)
      else:
        ray_results = mlp(means, covs, viewdirs=viewdirs,
                          glo_vec=glo_vec if final_level else None,
                          generator=generator)
        if final_level and self.track_occupancy:
          # The grid's feedback and the gate's keep fraction, measured
          # while not culling too.
          ray_results['occ_cells'] = cells
          ray_results['occ_density'] = ray_results['density'].detach()
          ray_results['occ_keep_frac'] = torch.mean(keep.float())

      hist_weights = rendering.compute_alpha_weights(
          ray_results['density'], t_edges, rays.directions,
          opaque_background=cfg.opaque_background)[0]

      lo, hi = cfg.bg_intensity_range[0], cfg.bg_intensity_range[1]
      if lo == hi:
        bg_rgbs = lo
      elif generator is None:
        bg_rgbs = (lo + hi) / 2  # Deterministic midpoint.
      else:
        bg_rgbs = lo + (hi - lo) * torch.rand(
            hist_weights.shape[:-1] + (3,), generator=generator,
            dtype=hist_weights.dtype, device=hist_weights.device)

      # RawNeRF: colors scaled by the ray's exposure, and by a learned
      # per-exposure RGB scaling whose index 0 is pinned to 1 (it anchors
      # the scene's brightness).
      if rays.exposure_idx is not None:
        ray_results['rgb'] = (ray_results['rgb'] *
                              rays.exposure_values[..., None, :])
        if cfg.learned_exposure_scaling:
          exposure_idx = rays.exposure_idx[..., 0].long()
          mask = (exposure_idx > 0)[..., None]
          scaling = 1 + mask * self.exposure_scaling_offsets(exposure_idx)
          ray_results['rgb'] = ray_results['rgb'] * scaling[..., None, :]

      rendering_out = rendering.volumetric_rendering(
          ray_results['rgb'], hist_weights, t_edges, bg_rgbs, rays.far,
          compute_extras,
          extras={k: v for k, v in ray_results.items()
                  if k.startswith('normals') or k == 'roughness'})

      if compute_extras:
        n = cfg.config.vis_num_rays if cfg.config is not None else 16
        rendering_out['ray_sdist'] = s_edges.reshape(
            [-1, s_edges.shape[-1]])[:n, :]
        rendering_out['ray_weights'] = hist_weights.reshape(
            [-1, hist_weights.shape[-1]])[:n, :]
        rgb = ray_results['rgb']
        rendering_out['ray_rgbs'] = rgb.reshape(
            (-1,) + rgb.shape[-2:])[:n, :, :]

      renderings.append(rendering_out)
      ray_results['sdist'] = s_edges.clone()
      ray_results['weights'] = hist_weights.clone()
      ray_history.append(ray_results)

    if compute_extras:
      # Proposal colors are meaningless; show the final level's average.
      final_rgb = torch.sum(renderings[-1]['ray_rgbs'] *
                            renderings[-1]['ray_weights'][..., None], dim=-2)
      for r in renderings[:-1]:
        r['ray_rgbs'] = torch.broadcast_to(final_rgb[:, None, :],
                                           r['ray_rgbs'].shape)

    return renderings, ray_history


def construct_model(config, generator, device):
  """Build the Model from the gin bindings, initialized from `generator`:
  the whole model on every rank, then, under a model axis, each rank keeps
  its parts of the layers split over its model group (``shard_model``), so
  that the gathered tree is one process's at the same seed."""
  model = Model(ginlite.make('Model', config=config), generator=generator,
                device=device)
  if mesh.model_size() > 1:
    shard_model(model)
  return model


def model_splits(model, model_size, min_dim_to_shard=512):
  """{flax name: tensor.Split} of the leaves of `model` (whole) that a
  model axis of `model_size` ranks splits: infer_layout's Megatron pairs,
  each trunk skip layer after a column layer split at its x rows."""
  names = {id(m): n.replace('.', '/') for n, m in model.named_modules()}
  shapes = {k.replace('.', '/'): tuple(v.shape)
            for k, v in model.named_parameters()}
  skip_x_rows = {}
  for mlp in model.modules():
    if isinstance(mlp, mlp_lib.MLP):
      for i, layer in enumerate(mlp.trunk):
        if mlp._is_skip(i):  # pylint: disable=protected-access
          skip_x_rows[names[id(layer)] + '/kernel'] = mlp.cfg.net_width
  layout = tensor.infer_layout(shapes, model_size, min_dim_to_shard)
  return tensor.storage_splits(layout, shapes, skip_x_rows)


def shard_model(model):
  """Keep this rank's part of every leaf the model axis splits
  (``model_splits`` at the mesh's size and threshold)."""
  by_module = {}
  for name, split in model_splits(model, mesh.model_size(),
                                  mesh.min_dim_to_shard()).items():
    module, _, attr = name.rpartition('/')
    by_module.setdefault(module, {})[attr] = split
  modules = dict(model.named_modules())
  for module, splits in by_module.items():
    modules[module.replace('/', '.')].shard_(splits)


def _keep_chunk_outputs(renderings, config):
  """Final-level image buffers + every level's capped ray vis bundles."""
  out = dict(renderings[-1])
  for k in renderings[0]:
    if k.startswith('ray_'):
      out[k] = [r[k][:config.vis_num_rays] for r in renderings]
  return out


def _subsample_ray_bundles(rendering, config):
  """Cut the concatenated per-chunk bundles to one bundle of vis_num_rays.

  A fixed permutation (seed 0), as in the JAX package; its bits differ
  from JAX's, which only changes which rays are shown.
  """
  keys = [k for k in rendering if k.startswith('ray_')]
  if keys:
    num_bundle_rays = rendering[keys[0]][0].shape[0]
    perm = torch.randperm(num_bundle_rays,
                          generator=torch.Generator().manual_seed(0))
    ray_idx = perm[:config.vis_num_rays]
    for k in keys:
      rendering[k] = [r[ray_idx.to(r.device)] for r in rendering[k]]
  return rendering


def _plan_chunks(config, num_rays):
  """(chunk, num_chunks, padding) of a whole-image render (nerf.py:369):
  chunks divide by the data-axis size, and no more than one data-axis size
  of padding is rendered past the image."""
  n_dev = mesh.data_size()
  chunk = min(config.render_chunk_size, -(-num_rays // n_dev) * n_dev)
  chunk = max(n_dev, chunk // n_dev * n_dev)
  num_chunks = -(-num_rays // chunk)
  return chunk, num_chunks, num_chunks * chunk - num_rays


def _assemble_image(outs, config, height, width, chunk, num_chunks,
                    padding):
  """Chunk outputs {k: [num_chunks, chunk, ...]} -> one [H, W] dict."""
  num_rays = height * width
  last_real = min(config.vis_num_rays, chunk - padding)

  def cat_bundles(r):
    head = r[:-1].reshape((-1,) + r.shape[2:])
    return torch.cat([head, r[-1][:last_real]], dim=0)

  out = {}
  for k, z in outs.items():
    if k.startswith('ray_'):
      out[k] = [cat_bundles(r) for r in z]
    else:
      flat = z.reshape((num_chunks * chunk,) + z.shape[2:])[:num_rays]
      out[k] = flat.reshape((height, width) + flat.shape[1:])
  return _subsample_ray_bundles(out, config)


def _render_frame(render_fn, config, train_frac, height, width, chunk_rays):
  """One [H, W] frame, left on the device: ``chunk_rays(start, n)`` gives
  the rays of rows [start, start + n) of the flattened image (padded to
  whole chunks), this rank renders its rows of each chunk (nerf.py:470-495)
  and keeps their outputs (_keep_chunk_outputs), and the chunks are
  assembled on the device, with no read-back between them.  Across ranks
  the rows of every rank of the data group are gathered first."""
  chunk, num_chunks, padding = _plan_chunks(config, height * width)
  world = mesh.data_size()
  rows = chunk // world
  first = mesh.data_rank() * rows
  outs = []
  for i in range(num_chunks):
    with trace.span('render/chunk'):
      renderings, _ = render_fn(train_frac,
                                chunk_rays(i * chunk + first, rows))
      outs.append(_keep_chunk_outputs(renderings, config))
  with trace.span('render/assemble'):
    outs = _stack(outs)
    if world > 1:
      outs = _gather_chunks(outs, config, world)
    return _assemble_image(outs, config, height, width, chunk, num_chunks,
                           padding)


def _gather_chunks(outs, config, world):
  """The chunk outputs of every rank of the data group, each chunk's rows
  in rank order:
  {k: [num_chunks, chunk / world, ...]} -> {k: [num_chunks, chunk, ...]}
  through one all-gather.  A ray bundle keeps the first vis_num_rays rays
  of each chunk, as one device rendering the whole chunk does."""
  leaves = []
  for k, v in outs.items():
    for level, t in (enumerate(v) if isinstance(v, list) else [(None, v)]):
      if not t.is_floating_point():
        raise TypeError(f'{k} is not a floating-point output.')
      leaves.append((k, level, t))
  flat = torch.cat([t.reshape(-1).to(torch.float32) for _, _, t in leaves])
  gathered = mesh.all_gather_rows(flat[None], mesh.data_group())
  out, start = {}, 0
  for k, level, t in leaves:
    parts = gathered[:, start:start + t.numel()].reshape((world,) + t.shape)
    start += t.numel()
    merged = parts.transpose(0, 1).reshape(
        (t.shape[0], world * t.shape[1]) + t.shape[2:]).to(t.dtype)
    if level is None:
      out[k] = merged
    else:
      out.setdefault(k, []).append(merged[:, :config.vis_num_rays])
  return out


def _stack(frames):
  """A list of rendering dicts -> one dict stacked on a new leading axis
  (each level of a 'ray_' bundle stacked on its own)."""
  out = {}
  for k, v in frames[0].items():
    if isinstance(v, list):
      out[k] = [torch.stack([f[k][lvl] for f in frames])
                for lvl in range(len(v))]
    else:
      out[k] = torch.stack([f[k] for f in frames])
  return out


def _to_host(rendering):
  """A rendering dict of tensors -> numpy ('ray_' bundles stay lists)."""
  with trace.span('render/to_host'):
    return {k: ([r.cpu().numpy() for r in v] if isinstance(v, list)
                else v.cpu().numpy()) for k, v in rendering.items()}


class ImageRenderer:
  """Whole-image renderer of rays cast on the host (nerf.py:406-542): the
  fallback for cameras the device cast does not cover, the pano camera.

  Per frame the [H, W] host rays are flattened, padded by edge replication
  to whole chunks (_plan_chunks), packed into one float32 array and copied
  to the device once (across ranks, this rank's rows of each chunk); the
  chunks are rendered through the same ``render_fn`` as
  DeviceImageRenderer's (so the fused kernels run) and assembled on the
  device, and the frame comes back in one transfer.
  """

  def __init__(self, render_fn, config, dataset, device):
    """Args:
      render_fn: (train_frac, rays) -> (renderings, history), e.g. from
        train_lib.create_render_fn.
      config: Config (render_chunk_size, vis_num_rays).
      dataset: a Dataset whose ``generate_ray_batch`` casts the rays of a
        camera index (None where only ``render_rays`` is called).
      device: where the frame is rendered.
    """
    self._render_fn = render_fn
    self._config = config
    self._dataset = dataset
    self._device = torch.device(device)

  def _upload(self, rays, num_rays, chunk, num_chunks):
    """[H, W, ...] numpy Rays -> Rays of [num_chunks * rows, ...] tensors
    on the device, this rank's `rows` rays of each chunk in turn (all of
    them on one rank), from one copy of every field packed side by side;
    the index fields (exact in float32) are cast back to int64."""
    fields = {f.name: getattr(rays, f.name)
              for f in dataclasses.fields(rays)
              if getattr(rays, f.name) is not None}
    cols = [np.asarray(v, np.float32).reshape(num_rays, -1)
            for v in fields.values()]
    packed = np.pad(np.concatenate(cols, -1),
                    ((0, num_chunks * chunk - num_rays), (0, 0)), mode='edge')
    rows = chunk // mesh.data_size()
    first = mesh.data_rank() * rows
    packed = np.ascontiguousarray(packed.reshape(
        num_chunks, chunk, -1)[:, first:first + rows].reshape(
            num_chunks * rows, -1))
    packed = torch.from_numpy(packed)
    if self._device.type == 'cuda':
      packed = packed.pin_memory()
    packed = packed.to(self._device, non_blocking=True)
    out, start = {}, 0
    for name, col in zip(fields, cols):
      out[name] = packed[:, start:start + col.shape[-1]]
      start += col.shape[-1]
      if name in ('cam_idx', 'exposure_idx'):
        out[name] = out[name].long()
    return types.Rays(**out)

  def __call__(self, train_frac, cam_idx):
    """Render the dataset's camera `cam_idx` from the rays the host casts
    for it (``dataset.generate_ray_batch``, as render.py:199): what
    ``render_rays`` gives."""
    with trace.span('render/frame'):
      return self._render_rays(
          train_frac, self._dataset.generate_ray_batch(int(cam_idx)).rays,
          True)

  def render_rays(self, train_frac, rays, fetch=True):
    """Render the [H, W] host rays `rays` (a types.Rays of numpy arrays):
    a dict of [H, W, ...] numpy buffers plus the 'ray_' bundles; with
    `fetch` False the same frame as tensors left on the device (JAX's
    ``ImageRenderer.__call__(..., fetch=False)``)."""
    with trace.span('render/frame'):
      return self._render_rays(train_frac, rays, fetch)

  def _render_rays(self, train_frac, rays, fetch):
    height, width = rays.origins.shape[:2]
    chunk, num_chunks, _ = _plan_chunks(self._config, height * width)
    flat = self._upload(rays, height * width, chunk, num_chunks)

    def chunk_rays(start, rows):
      # This rank's rows of chunk start // chunk sit together in `flat`.
      lo = start // chunk * rows
      return types.Rays(**{
          f.name: (None if getattr(flat, f.name) is None else
                   getattr(flat, f.name)[lo:lo + rows])
          for f in dataclasses.fields(flat)})

    frame = _render_frame(self._render_fn, self._config, train_frac, height,
                          width, chunk_rays)
    return _to_host(frame) if fetch else frame


def render_image(render_fn, rays, config, device):
  """Render all pixels of one image once (nerf.py:696-795): a fresh
  ImageRenderer over ``render_fn`` (rays -> (renderings, history)).

  JAX picks, by ``Config.render_scan_chunks``, between a scan over the
  chunks and a host loop whose outputs are the same; on one device the
  port has one loop for both settings: the chunks are launched one after
  the other and the frame is read back once.
  """
  renderer = ImageRenderer(lambda _, chunk_rays: render_fn(chunk_rays),
                           config, None, device)
  return renderer.render_rays(None, rays)


class DeviceImageRenderer:
  """Whole-image renderer that casts rays on the device from cameras
  uploaded once (nerf.py:545-694); per frame only the camera index goes to
  the device and the assembled rendering comes back.  Pano cameras are
  not cast here (``supports``): the drivers take ImageRenderer for them."""

  def __init__(self, render_fn, config, dataset, device):
    """Args:
      render_fn: (train_frac, rays) -> (renderings, history), e.g. from
        train_lib.create_render_fn.
      config: Config (render_chunk_size, vis_num_rays).
      dataset: a Dataset (cameras, camtype, size, near/far, exposures).
      device: where the rays are cast and rendered.
    """
    self._spherical = dataset._render_spherical  # pylint: disable=protected-access
    self._render_fn = render_fn
    self._config = config
    self._device = device
    self._camtype = dataset.camtype
    self._height, self._width = dataset.height, dataset.width
    self._near, self._far = float(dataset.near), float(dataset.far)
    self._cameras = camera_lib.cameras_to_device(dataset.cameras, device)
    # A copy: the exposure records may be read-only broadcasts.
    as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    n_cams = self._cameras[1].shape[0]
    records = dataset.exposure_records(np.arange(n_cams))
    self._exposure_idx = self._exposure_values = None
    if 'exposure_idx' in records:
      self._exposure_idx = torch.tensor(np.array(np.broadcast_to(
          np.asarray(records['exposure_idx'], np.int64), (n_cams,))),
                                        device=device)
    if 'exposure_values' in records:
      self._exposure_values = as_f32(np.broadcast_to(
          np.asarray(records['exposure_values'], np.float32), (n_cams,)))

  def supports(self):
    """Whether the device cast covers the dataset's cameras: every
    projective camera, not the pano fan (nerf.py:600-603)."""
    return not self._spherical

  def _cast_chunk(self, chunk_start, chunk, cam_idx):
    """Rays for [chunk_start, chunk_start + chunk), clamped at the image
    end (the clamped duplicates are dropped at assembly)."""
    num_rays = self._height * self._width
    flat = torch.clamp(
        chunk_start + torch.arange(chunk, device=self._device),
        max=num_rays - 1)
    ones = torch.ones((chunk, 1), dtype=torch.float32, device=self._device)
    kw = dict(lossmult=ones, near=self._near * ones, far=self._far * ones,
              cam_idx=torch.full((chunk, 1), cam_idx, dtype=torch.int64,
                                 device=self._device))
    if self._exposure_idx is not None:
      kw['exposure_idx'] = self._exposure_idx[cam_idx].expand(chunk, 1)
    if self._exposure_values is not None:
      kw['exposure_values'] = self._exposure_values[cam_idx] * ones
    pixels = types.Pixels(flat % self._width, flat // self._width, **kw)
    return camera_lib.cast_ray_batch(self._cameras, pixels, self._camtype,
                                     xnp=torch)

  def _frame(self, train_frac, cam_idx):
    if not self.supports():
      raise ValueError('pano cameras are cast on the host: render them '
                       'with ImageRenderer.')
    cam_idx = int(cam_idx)
    return _render_frame(
        self._render_fn, self._config, train_frac, self._height, self._width,
        lambda start, rows: self._cast_chunk(start, rows, cam_idx))

  def __call__(self, train_frac, cam_idx):
    """Render the dataset's camera `cam_idx`: a dict of [H, W, ...] numpy
    buffers plus the 'ray_' bundles (lists of one array per level)."""
    with trace.span('render/frame'):
      return _to_host(self._frame(train_frac, cam_idx))

  def render_many(self, train_frac, cam_indices):
    """Render the cameras `cam_indices` (K of them) with no read-back
    between frames (nerf.py:662-694): a dict of [K, H, W, ...] numpy
    buffers (and [K, ...] per level of each 'ray_' bundle), read back
    once, after the last frame.  Each frame is what ``__call__`` gives;
    the read-back is in no frame's span."""
    frames = []
    for idx in cam_indices:
      with trace.span('render/frame'):
        frames.append(self._frame(train_frac, idx))
    return _to_host(_stack(frames))


def choose_renderer(render_fn, config, dataset, device):
  """The renderer the JAX drivers choose (render.py:222-227): the
  DeviceImageRenderer where it supports the dataset's cameras, else an
  ImageRenderer; both are called as (train_frac, cam_idx)."""
  renderer = DeviceImageRenderer(render_fn, config, dataset, device)
  if renderer.supports():
    return renderer
  return ImageRenderer(render_fn, config, dataset, device)
