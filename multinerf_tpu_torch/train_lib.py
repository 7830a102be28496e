"""Losses, optimizer, the training step and model setup (port of train_lib.py).

The training step (train_lib.py:244-425 with ``jit=False``): render the
batch through every level, the data loss (``mse`` or ``charb``), the
proposal (interlevel) and distortion losses, Ref-NeRF's orientation and
predicted-normal losses, backpropagation through the fused kernels'
backward passes (or, for density normals, through their own gradient),
per-module clipping by value then by norm, ``nan_to_num`` of the clipped
gradients, and Adam on the log-linear learning-rate schedule.  Statistics
keep the JAX names, flattened with '/' (``losses/data``,
``grad_norms/NerfMLP_0``, ...), with the ``disparity_mses`` and
``normal_maes`` metrics when asked for.  The data losses are ``mse``,
``charb``, RawNeRF's ``rawnerf`` (renders clipped at 1, weighted by the
log tonemap's gradient) and RobustNeRF's ``robustnerf`` (the residuals of
patches masked by ``robust.robustnerf_mask`` against the loss
threshold the previous step returned).  ``Config.weight_decay_mults`` adds
``losses/weight``, the weighted squared norms of the named subtrees.
Across ranks (``parallel/mesh.py``) the step is the global-batch step of
the JAX package's sharded batch: each rank's loss is its share of the
global loss, so that one all-reduce (SUM) of the gradients gives the
global gradient before the clip, Adam runs replicated, and the step's
statistics are global values from one more all-reduce.  Under a model
axis (``parallel/tensor.py``) those shares and sums run over the data
group, the ranks of a model group computing the same loss; a leaf split
over the model group counts once in every norm (the clip's, the
statistics', weight decay's), its squares summed over the group, and Adam
updates each rank's part as it is.  With
``Config.cast_rays_in_train_step`` the train split ships pixels, which the
step casts on the device.  With ``Config.occupancy_culling`` the step
updates the Model's occupancy grid after Adam from the final level's
feedback (train_lib.py:390-398), a step made with ``cull`` runs the final
level culled at that capacity, and ``CullingGate`` holds the protocol of
train.py:156-179 and 260-289: which rung each step runs, and the grid's
refresh with the self-gate.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from multinerf_tpu_torch import bridge
from multinerf_tpu_torch import robust
from multinerf_tpu_torch.data import cameras as camera_lib
from multinerf_tpu_torch.data import types
from multinerf_tpu_torch.models import culling
from multinerf_tpu_torch.models import mlp as mlp_lib
from multinerf_tpu_torch.models import nerf as nerf_lib
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.ops import mathx
from multinerf_tpu_torch.ops import ref_utils
from multinerf_tpu_torch.ops import stepfun
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.parallel import tensor
from multinerf_tpu_torch.utils import checkpoints

_F32_EPS = float(np.finfo(np.float32).eps)


# --- Statistics over {flax name: tensor} dicts. -------------------------------


def _groups(name, max_depth=3):
  """'A/B/C/...' -> ['A', 'A/B', 'A/B/C']: the keys summarize_tree
  (train_lib.py:63) gives the leaf under."""
  parts = name.split('/')
  return ['/'.join(parts[:d]) for d in range(1, min(len(parts), max_depth) + 1)]


def _summarize(flat, leaf_fn, combine, sharded=(), reduce=None):
  """{module, layer and leaf: the leaves' `leaf_fn` values combined}; the
  values of the `sharded` leaves (a rank's parts) first reduced over the
  model group by `reduce` ({name: value} -> {name: whole value})."""
  values = {name: leaf_fn(value.detach()) for name, value in flat.items()}
  parts = {k: v for k, v in values.items() if k in sharded}
  if parts and mesh.model_size() > 1:
    values.update(reduce(parts))
  out = {}
  for name, v in values.items():
    for g in _groups(name):
      out[g] = combine(out[g], v) if g in out else v
  return out


def _model_sum(values):
  return mesh.all_reduce_sum_dict(values, mesh.model_group())


def _model_max(values):
  stacked = mesh.all_reduce_max(torch.stack(list(values.values())),
                                mesh.model_group())
  return dict(zip(values, stacked))


def norm_sq_stats(flat, sharded=()):
  """Squared L2 norm of every module, layer and leaf; the leaves named in
  `sharded` are this rank's parts of leaves split over the model group."""
  return _summarize(flat, lambda x: torch.sum(x.float()**2), torch.add,
                    sharded, _model_sum)


def norm_stats(flat, sharded=()):
  return {k: torch.sqrt(v) for k, v in norm_sq_stats(flat, sharded).items()}


def abs_max_stats(flat, sharded=()):
  return _summarize(flat, lambda x: torch.max(torch.abs(x)), torch.maximum,
                    sharded, _model_max)


# --- Loss terms. ----------------------------------------------------------------


def compute_data_loss(batch, renderings, rays, loss_threshold, config):
  """Photometric loss over all levels (train_lib.py:77-135): (loss, stats),
  stats holding the per-level 'mses', with the metrics on
  'disparity_mses' and 'normal_maes', and with the ``robustnerf`` loss the
  mask's statistics of the last level (``robust.robustnerf_mask``; its
  'loss_threshold' is the next step's `loss_threshold`), all detached.
  Across ranks the ratios of sums ('mses', the data loss, 'normal_maes')
  divide by denominators summed over the data group: each is this rank's
  share of the global value, and 'disparity_mses' is this rank's mean."""
  if config.data_loss_type not in ('mse', 'charb', 'rawnerf', 'robustnerf'):
    raise ValueError(f'Unknown data loss type {config.data_loss_type}')
  lossmult = torch.broadcast_to(rays.lossmult, batch.rgb[..., :3].shape)
  if config.disable_multiscale_loss:
    lossmult = torch.ones_like(lossmult)
  # lossmult is data (RawNeRF's Bayer mask differs from rank to rank).
  denom = mesh.all_reduce_sum(lossmult.sum(), mesh.data_group())
  mses, data_losses = [], []
  metrics = {}
  for rendering in renderings:
    resid_sq = (rendering['rgb'] - batch.rgb[..., :3])**2
    mses.append((lossmult * resid_sq).sum() / denom)
    if config.data_loss_type == 'mse':
      data_loss = resid_sq
    elif config.data_loss_type == 'charb':
      data_loss = torch.sqrt(resid_sq + config.charb_padding**2)
    elif config.data_loss_type == 'rawnerf':
      # Renders clipped at 1, as the sensor saturates, then weighted by the
      # gradient of the log tonemap curve (arxiv.org/abs/2111.13679 Eq 6),
      # which takes no gradient.
      rgb_render_clip = torch.clamp(rendering['rgb'], max=1.0)
      resid_sq_clip = (rgb_render_clip - batch.rgb[..., :3])**2
      scaling_grad = 1.0 / (1e-3 + rgb_render_clip.detach())
      data_loss = resid_sq_clip * scaling_grad**2
    else:
      mask, robust_stats = robust.robustnerf_mask(resid_sq, loss_threshold,
                                                  config)
      data_loss = resid_sq * mask
      metrics.update(robust_stats)
    data_losses.append((lossmult * data_loss).sum() / denom)
    with torch.no_grad():
      if config.compute_disp_metrics:
        disp = 1 / (1 + rendering['distance_mean'])
        metrics.setdefault('disparity_mses', []).append(
            ((disp - batch.disps)**2).mean())
      if config.compute_normal_metrics:
        if 'normals' in rendering:
          mae_weights = rendering['acc'] * batch.alphas
          normal_mae = ref_utils.compute_weighted_mae(
              mae_weights, ref_utils.l2_normalize(rendering['normals']),
              ref_utils.l2_normalize(batch.normals),
              weight_sum=mesh.all_reduce_sum(mae_weights.sum(),
                                             mesh.data_group()))
        else:
          normal_mae = torch.full((), torch.nan, device=denom.device)
        metrics.setdefault('normal_maes', []).append(normal_mae)
  data_losses = torch.stack(data_losses)
  loss = (config.data_coarse_loss_mult * torch.sum(data_losses[:-1]) +
          config.data_loss_mult * data_losses[-1])
  stats = {'mses': torch.stack(mses).detach()}
  stats.update({k: torch.stack(v) if isinstance(v, list) else v
                for k, v in metrics.items()})
  return loss, stats


def interlevel_loss(ray_history, config):
  """Proposal supervision: each proposal histogram must envelope the
  final level's (held fixed)."""
  last = ray_history[-1]
  c = last['sdist'].detach()
  w = last['weights'].detach()
  loss = torch.zeros((), device=c.device)  # A tensor with one level too.
  for ray_results in ray_history[:-1]:
    loss = loss + torch.mean(stepfun.lossfun_outer(
        c, w, ray_results['sdist'], ray_results['weights']))
  return config.interlevel_loss_mult * loss


def distortion_loss(ray_history, config):
  """The mip-NeRF 360 distortion regularizer on the final level."""
  last = ray_history[-1]
  loss = torch.mean(stepfun.lossfun_distortion(last['sdist'],
                                               last['weights']))
  return config.distortion_loss_mult * loss


def orientation_loss(rays, model, ray_history, config):
  """Ref-NeRF's orientation loss: the weighted squared n.v of the normals
  (``config.orientation_loss_target``) that face away from the camera."""
  total_loss = 0.0
  v = -1.0 * rays.viewdirs  # Points from the surface toward the camera.
  for i, ray_results in enumerate(ray_history):
    w = ray_results['weights']
    n = ray_results[config.orientation_loss_target]
    if n is None:
      raise ValueError('Normals cannot be None if orientation loss is on.')
    n_dot_v = (n * v[..., None, :]).sum(dim=-1)
    loss = torch.mean((w * torch.clamp(n_dot_v, max=0.0)**2).sum(dim=-1))
    mult = (config.orientation_coarse_loss_mult
            if i < model.cfg.num_levels - 1
            else config.orientation_loss_mult)
    total_loss = total_loss + mult * loss
  return total_loss


def predicted_normal_loss(model, ray_history, config):
  """Ref-NeRF's supervision of the predicted normals by the density
  gradient's: the weighted 1 - n.n_pred."""
  total_loss = 0.0
  for i, ray_results in enumerate(ray_history):
    w = ray_results['weights']
    n = ray_results['normals']
    n_pred = ray_results['normals_pred']
    if n is None or n_pred is None:
      raise ValueError('Predicted and gradient normals cannot be None if '
                       'predicted normal loss is on.')
    loss = torch.mean(
        (w * (1.0 - torch.sum(n * n_pred, dim=-1))).sum(dim=-1))
    mult = (config.predicted_normal_coarse_loss_mult
            if i < model.cfg.num_levels - 1
            else config.predicted_normal_loss_mult)
    total_loss = total_loss + mult * loss
  return total_loss


def clip_gradients(grads, config, sharded=()):
  """Clip the gradients of each top-level module (NerfMLP_0, PropMLP_0)
  on its own: by value, then by the module's norm (train_lib.py:192).  A
  NaN anywhere in a module makes its norm NaN, and so every entry of it.
  The leaves named in `sharded` are this rank's parts of leaves split over
  the model group: their squares are summed over it."""
  if config.grad_max_val > 0:
    grads = {k: torch.clamp(v, -config.grad_max_val, config.grad_max_val)
             for k, v in grads.items()}
  squares = {}
  if config.grad_max_norm > 0:
    squares = {k: torch.sum(v**2) for k, v in grads.items()}
    parts = {k: v for k, v in squares.items() if k in sharded}
    if parts and mesh.model_size() > 1:
      squares.update(_model_sum(parts))
  modules = {}
  for name in grads:
    modules.setdefault(name.split('/')[0], []).append(name)
  out = {}
  for names in modules.values():
    g = {k: grads[k] for k in names}
    if config.grad_max_norm > 0:
      norm = torch.sqrt(sum(squares[k] for k in names))
      ratio = config.grad_max_norm / (_F32_EPS + norm)
      mult = torch.minimum(torch.ones_like(ratio), ratio)  # NaN stays NaN.
      g = {k: mult * v for k, v in g.items()}
    out.update(g)
  return out


# --- Optimizer. -------------------------------------------------------------------


def learning_rate_fn(config):
  """step -> learning rate, the schedule of create_optimizer."""
  return functools.partial(
      mathx.learning_rate_decay, lr_init=config.lr_init,
      lr_final=config.lr_final, max_steps=config.max_steps,
      lr_delay_steps=config.lr_delay_steps,
      lr_delay_mult=config.lr_delay_mult)


def create_optimizer(config, params):
  """(Adam over `params` ({flax name: nn.Parameter}), lr_fn).  The train
  step sets the rate to lr_fn(count) before each update, count being the
  number of updates already applied (optax's count): the first update uses
  lr_fn(0)."""
  lr_fn = learning_rate_fn(config)
  optimizer = torch.optim.Adam(
      list(params.values()), lr=float(lr_fn(0)),
      betas=(config.adam_beta1, config.adam_beta2), eps=config.adam_eps)
  return optimizer, lr_fn


def apply_gradients(state, grads, config, lr_fn):
  """Clip `grads` ({flax name: tensor}), zero their NaNs and apply one
  Adam update at lr_fn(state.step) to `state.params`, the parameters of
  `state.optimizer`.  Returns the TrainState one step on."""
  optimizer = state.optimizer
  sharded = tensor.splits_of(state.params)
  for name, g in clip_gradients(grads, config, sharded).items():
    state.params[name].grad = torch.nan_to_num(g)
  for group in optimizer.param_groups:
    group['lr'] = float(lr_fn(state.step))
  optimizer.step()
  return checkpoints.TrainState(step=state.step + 1, params=state.params,
                                optimizer=optimizer)


# --- Train step. ------------------------------------------------------------------


def batch_to_device(batch, device):
  """A host Batch -> tensors on `device`: floats as float32, the unit
  patch axes of patch_size 1 dropped ([P, 1, 1, C] -> [P, C]).  To a CUDA
  device the arrays go through pinned memory, copied ``non_blocking`` on
  the current stream."""
  device = torch.device(device)
  pin = device.type == 'cuda'

  def move(x):
    if x is None:
      return None
    x = np.asarray(x)
    if x.ndim >= 3 and x.shape[1:3] == (1, 1):
      x = x.reshape((x.shape[0],) + x.shape[3:])
    if np.issubdtype(x.dtype, np.floating):
      x = x.astype(np.float32)
    host = torch.from_numpy(np.array(x))  # A writable copy.
    if pin:
      return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)

  rays = type(batch.rays)(**{f: move(getattr(batch.rays, f))
                             for f in batch.rays.__dataclass_fields__})
  return types.Batch(rays=rays, **{f: move(getattr(batch, f))
                                   for f in _TARGETS})


_TARGETS = ('rgb', 'disps', 'normals', 'alphas')


def _tensors(batch):
  return [t for t in [getattr(batch, f) for f in _TARGETS] +
          [getattr(batch.rays, f) for f in batch.rays.__dataclass_fields__]
          if t is not None]


class Prefetcher:
  """Host batches of `batches` on `device`, one step ahead (train.py:41-48
  of the JAX package).  ``stage()`` takes the next host batch and issues
  its copy, on a CUDA device from pinned memory on a side stream;
  ``take()`` returns the staged batch (staging one first if none is), the
  consumer's stream waiting for its copy.  The train loop stages the next
  batch once it has launched a step: the copy, and the dataset's producer
  thread refilling its queue, then overlap that step on the device instead
  of contending with the launches for the interpreter lock."""

  def __init__(self, batches, device):
    self._batches = batches
    self._device = torch.device(device)
    self._stream = (torch.cuda.Stream(self._device)
                    if self._device.type == 'cuda' else None)
    self._staged = None

  def stage(self):
    host = next(self._batches)
    if self._stream is None:
      self._staged = (batch_to_device(host, self._device), None)
      return
    with torch.cuda.stream(self._stream):
      self._staged = (batch_to_device(host, self._device),
                      self._stream.record_event())

  def take(self):
    if self._staged is None:
      self.stage()
    (batch, copied), self._staged = self._staged, None
    if copied is not None:
      consumer = torch.cuda.current_stream(self._device)
      consumer.wait_event(copied)
      for t in _tensors(batch):
        t.record_stream(consumer)  # Allocated on the side stream.
    return batch


def flatten_patches(batch, config):
  """A patch batch ([P, ps, ps, ...], RobustNeRF's) with its rays
  flattened to [P * ps * ps, ...], and a function that gives a rendered
  [P * ps * ps, ...] tensor the patch shape back."""
  ps = config.patch_size
  if ps <= 1 or batch.rgb.dim() != 4:
    return batch.rays, lambda x: x
  flat = lambda x: None if x is None else x.reshape((-1,) + x.shape[3:])
  rays = type(batch.rays)(**{f: flat(getattr(batch.rays, f))
                             for f in batch.rays.__dataclass_fields__})
  return rays, lambda x: x.reshape(batch.rgb.shape[:3] + x.shape[1:])


def subtree_norm_sq(params, key):
  """The squared L2 norm of the parameters under `key` ('NerfMLP_0',
  'NerfMLP_0/Dense_0', ...): JAX's tree_norm_sq of that subtree.  The
  squares of a rank's parts of split leaves are summed over the model group
  (their gradient stays this rank's part)."""
  leaves = {name: p for name, p in params.items()
            if name == key or name.startswith(key + '/')}
  if not leaves:
    raise KeyError(key)
  sharded = tensor.splits_of(leaves)
  total = sum(torch.sum(p**2) for k, p in leaves.items() if k not in sharded)
  if sharded:
    total = total + tensor.reduce_from_model(
        sum(torch.sum(leaves[k]**2) for k in sharded))
  return total


# Statistics of a step that are means over a rank's rays: averaged over
# the ranks, which hold as many rays each.  The others are shares of a
# global sum, but for the ones in _NOT_SUMMED: the RobustNeRF threshold,
# already global, and the grid feedback, reduced by update_grid.
_RANK_MEANS = ('disparity_mses', 'is_inlier_loss', 'has_inlier_neighbors',
               'is_inlier_patch', 'mask', 'occ_keep_fracs')
_NOT_SUMMED = ('loss_threshold', 'occ_cells', 'occ_density')


def _reduce_over_ranks(loss, losses, stats, grads):
  """The global loss, loss terms, statistics and gradient from this rank's
  shares: one all-reduce of the gradients, one of the statistics, over the
  data group (a model group's ranks hold parts of one gradient)."""
  world = mesh.data_size()
  if world == 1:
    return loss, losses, stats, grads
  group = mesh.data_group()
  grads = mesh.all_reduce_sum_dict(grads, group)
  values = {'loss': loss}
  values.update({f'losses/{k}': v for k, v in losses.items()})
  values.update({k: v for k, v in stats.items() if k not in _NOT_SUMMED})
  values = mesh.all_reduce_sum_dict(values, group)
  for k in _RANK_MEANS:
    if k in values:
      values[k] = values[k] / world
  loss = values.pop('loss')
  losses = {k: values.pop(f'losses/{k}') for k in losses}
  stats = {k: values.get(k, v) for k, v in stats.items()}
  return loss, losses, stats, grads


def loss_and_grads(model, config, batch, train_frac, generator=None,
                   loss_threshold=1.0, cull=None):
  """The training loss of `batch` and its gradient (the loss_fn of
  train_lib.py:302-373 under value_and_grad, with ``zero_glo=False``):
  (loss, {name: loss term}, stats of compute_data_loss, {flax name: raw
  gradient}).  Leaves ``.grad`` set on the model's parameters: across
  ranks, this rank's part, while the gradient returned is the global one,
  as are the loss, its terms and the stats.  Patches of patch_size > 1 go
  through the model as flat rays and come back shaped [P, ps, ps, ...] for
  the data loss (RobustNeRF votes over them).  With occupancy culling the
  stats also hold the final level's grid feedback 'occ_cells' and
  'occ_density' (this rank's samples) and 'occ_keep_frac', the largest
  keep fraction any level reports."""
  rays, unflatten = flatten_patches(batch, config)
  compute_extras = (config.compute_disp_metrics or
                    config.compute_normal_metrics)
  renderings, ray_history = model(rays, train_frac,
                                  compute_extras=compute_extras,
                                  generator=generator, zero_glo=False,
                                  cull=cull)
  shaped = [{k: v if k.startswith('ray_') or v is None else unflatten(v)
             for k, v in r.items()} for r in renderings]
  losses = {}
  losses['data'], stats = compute_data_loss(batch, shaped, batch.rays,
                                            loss_threshold, config)
  if config.interlevel_loss_mult > 0:
    losses['interlevel'] = interlevel_loss(ray_history, config)
  if config.distortion_loss_mult > 0:
    losses['distortion'] = distortion_loss(ray_history, config)
  if (config.orientation_coarse_loss_mult > 0 or
      config.orientation_loss_mult > 0):
    losses['orientation'] = orientation_loss(rays, model, ray_history,
                                             config)
  if (config.predicted_normal_coarse_loss_mult > 0 or
      config.predicted_normal_loss_mult > 0):
    losses['predicted_normals'] = predicted_normal_loss(model, ray_history,
                                                        config)
  if config.weight_decay_mults:
    params = bridge.named_parameters(model)
    losses['weight'] = torch.sum(torch.stack([
        m * subtree_norm_sq(params, k)
        for k, m in config.weight_decay_mults.items()]))
  world = mesh.data_size()
  if world > 1:
    # Every term but the data loss is a mean over rays, or weight decay,
    # which counts once: this rank's share is 1 / world of it.
    losses = {k: v if k == 'data' else v / world for k, v in losses.items()}
  if config.occupancy_culling:
    stats['occ_cells'] = ray_history[-1]['occ_cells']
    stats['occ_density'] = ray_history[-1]['occ_density']
    stats['occ_keep_fracs'] = torch.stack([
        r['occ_keep_frac'] for r in ray_history
        if 'occ_keep_frac' in r]).detach()
  loss = torch.sum(torch.stack(list(losses.values())))
  loss.backward()
  grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in bridge.named_parameters(model).items()}
  loss, losses, stats, grads = _reduce_over_ranks(
      loss.detach(), {k: v.detach() for k, v in losses.items()}, stats,
      grads)
  if config.occupancy_culling:
    # Each level's keep fraction over the global batch, then their max.
    stats['occ_keep_frac'] = torch.max(stats.pop('occ_keep_fracs'))
  return loss, losses, stats, grads


def create_train_step(model, config, device, cull=None, dataset=None):
  """(generator, state, batch, train_frac, compute_stats[, loss_threshold])
  -> (state, stats).

  One optimizer step of `model` on a device Batch (``batch_to_device``),
  with ``state.optimizer`` holding Adam over the model's parameters.
  `generator` (a torch.Generator on `device`) draws the jitter when
  ``config.randomized``.  With `cull` (a capacity; needs
  Config.occupancy_culling) the final level runs culled.  With
  Config.cast_rays_in_train_step a batch of Pixels is cast on `device` by
  the cameras of `dataset` (the train split).  stats: 'loss',
  'losses/{data,interlevel,distortion,orientation,predicted_normals,
  weight}', 'mses', 'psnrs', 'psnr'
  and, with the metrics on, 'disparity_mses' and 'normal_maes', with the
  ``robustnerf`` loss 'loss_threshold' (this batch's inlier quantile, the
  next step's `loss_threshold`: a 0-d tensor on the device, so that
  feeding it back costs no host sync) and the mask's inlier shares
  (detached tensors), plus with
  `compute_stats` the tree statistics 'weight_l2s/...' (before the update),
  'grad_norms/...', 'grad_maxes/...' (raw gradients), 'opt_update_norms/...'
  and 'opt_update_maxes/...', and with occupancy culling 'occ_keep_frac'.
  """
  lr_fn = learning_rate_fn(config)
  cameras = None
  if config.cast_rays_in_train_step:
    if dataset is None:
      raise ValueError('cast_rays_in_train_step needs the train dataset, '
                       'whose cameras cast the pixels.')
    cameras = camera_lib.cameras_to_device(dataset.cameras, device)
    camtype = dataset.camtype

  def train_step(generator, state, batch, train_frac, compute_stats,
                 loss_threshold=1.0):
    if cameras is not None and isinstance(batch.rays, types.Pixels):
      batch = dataclasses.replace(batch, rays=camera_lib.cast_ray_batch(
          cameras, batch.rays, camtype, xnp=torch))
    params = bridge.named_parameters(model)
    state.optimizer.zero_grad(set_to_none=True)
    loss, losses, stats, grads = loss_and_grads(
        model, config, batch, train_frac,
        generator if config.randomized else None, loss_threshold, cull)

    stats = dict(stats, loss=loss)
    stats.update({f'losses/{k}': v for k, v in losses.items()})
    if compute_stats:
      sharded = tensor.splits_of(params)
      tree_stats = {'weight_l2s': norm_sq_stats(params, sharded),
                    'grad_norms': norm_stats(grads, sharded),
                    'grad_maxes': abs_max_stats(grads, sharded)}
      before = {k: p.detach().clone() for k, p in params.items()}

    state = apply_gradients(state, grads, config, lr_fn)
    if config.occupancy_culling:
      # After Adam, which never sees the grid (train_lib.py:390-398).
      grid = model.occupancy.grid
      with torch.no_grad():
        grid.copy_(culling.update_grid(
            grid, stats.pop('occ_cells'), stats.pop('occ_density'),
            config.occupancy_grid_decay))

    if compute_stats:
      delta = {k: p.detach() - before[k] for k, p in params.items()}
      tree_stats['opt_update_norms'] = norm_stats(delta, sharded)
      tree_stats['opt_update_maxes'] = abs_max_stats(delta, sharded)
      for family, values in tree_stats.items():
        stats.update({f'{family}/{k}': v for k, v in values.items()})
    stats['psnrs'] = image_ops.mse_to_psnr(stats['mses'])
    stats['psnr'] = stats['psnrs'][-1]
    return state, stats

  return train_step


# --- Holding a step against a reference step. ---------------------------------

# Two steps from the same weights on the same batch (the kernels against
# their plain versions, or the port against the JAX package) round features,
# activations and cotangents to bf16 at the same places.  They differ where
# an f32 value lands on the other side of a rounding boundary, and in
# summation order, and through the ReLU masks those gaps grow toward the
# first layers.  The reference step is that sensitive by itself: moving its
# ray origins by a relative NUDGE moves a gradient or update leaf by a
# relative L2 `sens`.  So each leaf's relative L2 gap to the reference is
# bounded by GAP_BASE + 2 * sens, and never by more than a fixed cap; a wrong
# gradient is off by O(1).
NUDGE = 1e-6
GAP_BASE = 5e-2
GAP_CAP = 0.1


def nudge_origins(batch):
  """`batch` with its ray origins moved by a relative NUDGE."""
  rays = dataclasses.replace(batch.rays,
                             origins=batch.rays.origins * (1 + NUDGE))
  return dataclasses.replace(batch, rays=rays)


def _rel_l2(got, want):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def leaf_gaps(got, want, want_nudged, cap=GAP_CAP):
  """{name: (gap, sens, bound)} over the leaves of `want`, each tree a
  {name: array or CPU tensor}: the relative L2 gap of `got` to the reference
  `want`, the reference's own gap `sens` when its ray origins move by NUDGE
  (`want_nudged`), and the bound min(GAP_BASE + 2 * sens, cap)."""
  out = {}
  for name, w in want.items():
    sens = _rel_l2(want_nudged[name], w)
    out[name] = (_rel_l2(got[name], w), sens, min(GAP_BASE + 2 * sens, cap))
  return out


# --- Rendering and setup. --------------------------------------------------------


def needs_gradients(model):
  """Whether rendering `model` differentiates it: its density normals."""
  return any(not m.cfg.disable_density_normals for m in model.modules()
             if isinstance(m, mlp_lib.MLP))


def create_render_fn(model, cull=None):
  """(train_frac, rays) -> (renderings, ray_history), deterministic, with
  the extras, under ``torch.inference_mode``; or under ``torch.no_grad``
  when the model computes density normals, which turn gradients on around
  their own backward pass (inference tensors cannot enter autograd).

  With `cull` the final level renders through the occupancy grid
  (train_lib.py:447-477): a float is the capacity fraction, True (any
  other true value) Config.occupancy_capacity_frac; None or False render
  every sample.  Culling needs Config.occupancy_culling."""
  capacity = None
  if cull:
    if not model.track_occupancy:
      raise ValueError('cull requires Config.occupancy_culling.')
    capacity = (cull if isinstance(cull, float)
                else model.cfg.config.occupancy_capacity_frac)
  no_graph = (torch.no_grad if needs_gradients(model)
              else torch.inference_mode)

  def render_eval_fn(train_frac, rays):
    with no_graph():
      return model(rays, train_frac=train_frac, compute_extras=True,
                   cull=capacity)

  return render_eval_fn


def setup_model(config, seed, device, dataset=None):
  """(model, state, render_eval_fn, train_step, lr_fn), as train_lib.py:480:
  the gin-configured Model with weights drawn from torch.Generator(seed),
  its TrainState at step 0 (the model's parameters and buffers, and the
  Adam optimizer over the parameters), its render function (unculled, as
  JAX renders: train_lib.py:487-492) and its unculled training step
  (casting pixels with `dataset`'s cameras under
  Config.cast_rays_in_train_step)."""
  generator = torch.Generator().manual_seed(seed)
  model = nerf_lib.construct_model(config, generator, device)
  optimizer, lr_fn = create_optimizer(config, bridge.named_parameters(model))
  state = checkpoints.TrainState(step=0, params=bridge.named_variables(model),
                                 optimizer=optimizer)
  return (model, state, create_render_fn(model),
          create_train_step(model, config, device, dataset=dataset), lr_fn)


def capacity_ladder(config):
  """The culled step's capacities, ascending (train.py:158-160)."""
  return tuple(sorted(config.occupancy_capacity_ladder or
                      (config.occupancy_capacity_frac,)))


class CullingGate:
  """The culling protocol of train.py:156-179 and 260-289, shared by the
  host path and the multi-step window.

  ``cull(step)`` is the capacity step `step` runs at: the engaged rung once
  past ``occupancy_warmup_steps``, else None (unculled).  ``after_step``,
  every ``occupancy_grid_refresh_every`` steps, refreshes the grid with
  jitter from a generator seeded by the step (JAX's PRNGKey(step)) and
  engages the smallest rung that holds the step's keep fraction, none
  above the top rung.  That keep fraction is the one value read back to
  the host, once per refresh.  ``keep_fracs`` records it by step, ``rungs``
  the capacity of every culled step."""

  def __init__(self, model, config):
    self.ladder = capacity_ladder(config)
    self.rung = None
    self.keep_fracs = {}
    self.rungs = {}
    self._model = model
    self._config = config

  def cull(self, step):
    if self.rung is not None and step > self._config.occupancy_warmup_steps:
      self.rungs[step] = self.rung
      return self.rung
    return None

  def after_step(self, step, stats):
    """Refresh and gate after `step`, whose stats are `stats`."""
    if step % self._config.occupancy_grid_refresh_every:
      return
    grid = self._model.occupancy.grid
    generator = torch.Generator(grid.device).manual_seed(step)
    culling.refresh_grid(self._model, self._config, generator)
    keep_frac = self.keep_fracs[step] = float(stats['occ_keep_frac'])
    self.rung = next((c for c in self.ladder if keep_frac <= c), None)
