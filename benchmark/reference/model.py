"""Plain PyTorch mip-NeRF 360 / Ref-NeRF model, loss and optimizer step.

The reference the benchmark holds the program's outputs against.  It
imports nothing of the program: the model is described by the "model"
section of a configuration file (``benchmark/configs/<name>.json``), its
weights are a {flax name: tensor} dict that the benchmark makes, and every
layer is a plain product.  Its semantics are the published ones, in the
JAX package's layout:

* MLP trunk (``Dense_0`` ...) on the lifted integrated positional encoding
  of the (contracted) frustum Gaussians, a skip concatenation of the
  features after every ``skip_layer``-th layer, hidden layers in
  ``trunk_dtype`` (flax ``nn.Dense(dtype=...)``: operands rounded to it),
  heads in f32; with ``fused_numerics`` the featurize -> Dense products in
  the numerics the configuration states for them (bf16 features and
  weights, f32 accumulation and bias, ``_fused_trunk``);
* Ref-NeRF: density-gradient normals from one batched autograd pass
  (differentiable again while training), predicted normals, diffuse and
  tint, roughness, the IDE of reflected directions, n.v;
* proposal sampling with dilation, annealing and jitter drawn from a
  ``torch.Generator`` in the same calls, shapes and order as the program's
  sampler, so that one seed gives both sides the same jitter;
* the data (charbonnier or mse), interlevel, distortion, orientation and
  predicted-normal losses, per-module clipping by norm and Adam on the
  log-linear schedule.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ops

_DTYPES = {'float32': None, 'bfloat16': torch.bfloat16}


def _schlick(t, slope):
  return (slope * t) / ((slope - 1) * t + 1)


def _is_skip(i, skip_layer):
  return i > 1 and (i - 1) % skip_layer == 0


def mlp_layers(mlp):
  """[(name, fan_in, fan_out)] of an MLP section, in creation order."""
  basis = ops.generate_basis(mlp['basis_shape'], mlp['basis_subdivisions'])
  feats = 2 * (mlp['max_deg_point'] - mlp.get('min_deg_point', 0)) * len(
      basis)
  width, depth, skip = mlp['net_width'], mlp['net_depth'], mlp['skip_layer']
  shapes = []
  for i in range(depth):
    fan_in = (feats if i == 0 else width) + (feats if _is_skip(i, skip) else 0)
    shapes.append((fan_in, width))
  x_width = width + (feats if _is_skip(depth, skip) else 0)
  shapes.append((x_width, 1))  # Density.
  if mlp.get('enable_pred_normals'):
    shapes.append((x_width, 3))
  if not mlp.get('disable_rgb'):
    if mlp.get('use_diffuse_color'):
      shapes.append((x_width, 3))
    if mlp.get('use_specular_tint'):
      shapes.append((x_width, 3))
    if mlp.get('enable_pred_roughness'):
      shapes.append((x_width, 1))
    deg = mlp['deg_view']
    inputs = (ops.ide_width(deg) if mlp.get('use_directional_enc')
              else 3 + 6 * deg) + int(bool(mlp.get('use_n_dot_v')))
    if mlp['bottleneck_width'] > 0:
      shapes.append((x_width, mlp['bottleneck_width']))
      inputs += mlp['bottleneck_width']
    x_width = inputs
    for i in range(mlp['net_depth_viewdirs']):
      shapes.append((x_width, mlp['net_width_viewdirs']))
      x_width = mlp['net_width_viewdirs']
      if i % mlp['skip_layer_dir'] == 0 and i > 0:
        x_width += inputs
    shapes.append((x_width, 3))
  return [(f'Dense_{i}', a, b) for i, (a, b) in enumerate(shapes)]


def param_shapes(model_cfg):
  """{flax name: shape} of every leaf of the model."""
  out = {}
  mlps = [('NerfMLP_0', model_cfg['nerf_mlp'])]
  if not model_cfg.get('single_mlp'):
    mlps.append(('PropMLP_0', model_cfg['prop_mlp']))
  for prefix, mlp in mlps:
    for name, fan_in, fan_out in mlp_layers(mlp):
      out[f'{prefix}/{name}/kernel'] = (fan_in, fan_out)
      out[f'{prefix}/{name}/bias'] = (fan_out,)
  return out


def make_weights(model_cfg, generator, device):
  """{flax name: f32 tensor} drawn on `device` from `generator` in one
  call: every kernel He-uniform (the configs' ``weight_init``), biases
  zero."""
  shapes = param_shapes(model_cfg)
  kernels = [k for k, s in shapes.items() if len(s) == 2]
  total = sum(math.prod(shapes[k]) for k in kernels)
  u = torch.rand(total, generator=generator, device=device)
  out, start = {}, 0
  for name, shape in shapes.items():
    if len(shape) == 1:
      out[name] = torch.zeros(shape, device=device)
      continue
    n = math.prod(shape)
    lim = math.sqrt(6.0 / shape[0])
    out[name] = (u[start:start + n].view(shape) * 2 - 1) * lim
    start += n
  return out


class MLP:
  """The NeRF MLP of one section, over parameters `params[prefix/...]`."""

  def __init__(self, cfg, prefix, params):
    self.cfg = cfg
    self.prefix = prefix
    self.params = params
    self.basis = ops.generate_basis(cfg['basis_shape'],
                                    cfg['basis_subdivisions']).T
    self.dtype = _DTYPES[cfg.get('trunk_dtype', 'float32')]
    self.ide = (ops.generate_ide_fn(cfg['deg_view'])
                if cfg.get('use_directional_enc') else None)

  def _dense(self, i, x, dtype=None):
    w = self.params[f'{self.prefix}/Dense_{i}/kernel']
    b = self.params[f'{self.prefix}/Dense_{i}/bias']
    if dtype is None:
      return x.to(w.dtype) @ w + b
    return x.to(dtype) @ w.to(dtype) + b.to(dtype)

  def _trunk(self, means, covs):
    """(trunk output, raw density where the trunk computes it)."""
    cfg = self.cfg
    if cfg.get('warp') == 'contract':
      means, covs = ops.contract_gaussian(means, covs)
    feats = ops.ipe_lifted(means, covs, self.basis,
                           cfg.get('min_deg_point', 0), cfg['max_deg_point'])
    if cfg.get('fused_numerics'):
      return self._fused_trunk(feats)
    x = feats
    for i in range(cfg['net_depth']):
      if _is_skip(i, cfg['skip_layer']):
        x = torch.cat([x.to(feats.dtype), feats], dim=-1)
      x = torch.relu(self._dense(i, x, self.dtype))
    if _is_skip(cfg['net_depth'], cfg['skip_layer']):
      x = torch.cat([x.to(feats.dtype), feats], dim=-1)
    return x, None

  def _bf16_f32(self, i, x, rows=slice(None), bias=True):
    """x @ kernel[rows] of bf16-rounded operands with f32 accumulation, plus
    the f32 bias: the featurize -> Dense products of the configuration."""
    w = self.params[f'{self.prefix}/Dense_{i}/kernel'][rows]
    y = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    return y + self.params[f'{self.prefix}/Dense_{i}/bias'] if bias else y

  def _fused_trunk(self, feats):
    """The trunk in the numerics of the configuration's featurize -> Dense
    products (bf16 features and weights, f32 accumulation and bias): a
    density-only trunk no deeper than its skip layer whole in them, each
    layer's output rounded to bf16 after its ReLU, with the density head;
    otherwise layer 0 and the feature rows of each skip layer in them, the
    skip layer's activation rows an f32 product, the other hidden layers
    in ``trunk_dtype``."""
    cfg = self.cfg
    depth, skip = cfg['net_depth'], cfg['skip_layer']
    if cfg.get('disable_rgb') and depth <= skip:
      x = feats
      for i in range(depth):
        x = torch.relu(self._bf16_f32(i, x)).to(torch.bfloat16)
      return x, self._bf16_f32(depth, x)[..., 0]
    x = torch.relu(self._bf16_f32(0, feats))
    for i in range(1, depth):
      if _is_skip(i, skip):
        w = self.params[f'{self.prefix}/Dense_{i}/kernel']
        width = x.shape[-1]
        x = x.to(w.dtype) @ w[:width] + self._bf16_f32(
            i, feats, slice(width, None))
        x = torch.relu(x)
      else:
        x = torch.relu(self._dense(i, x, self.dtype))
    return x, None

  def __call__(self, means, covs, viewdirs):
    cfg = self.cfg
    shape = means.shape[:-1]
    means = means.reshape(-1, 3)
    covs = covs.reshape(-1, 3, 3)
    n = means.shape[0]
    depth = cfg['net_depth']
    ids = iter(range(depth, 10**6))
    density_id = next(ids)

    def per_sample(a):
      return torch.broadcast_to(a[..., None, :], shape + a.shape[-1:]
                                ).reshape(n, a.shape[-1])

    normals = None
    if cfg.get('disable_density_normals'):
      x, raw_density = self._trunk(means, covs)
      if raw_density is None:
        raw_density = self._dense(density_id, x)[..., 0]
    else:
      create_graph = torch.is_grad_enabled()
      with torch.enable_grad():
        means = means.detach().requires_grad_(True)
        x, _ = self._trunk(means, covs)
        raw_density = self._dense(density_id, x)[..., 0]
        grad, = torch.autograd.grad(raw_density.sum(), means,
                                    create_graph=create_graph)
      if not create_graph:
        raw_density, x = raw_density.detach(), x.detach()
      normals = -ops.l2_normalize(grad)
    normals_pred = None
    use_normals = normals
    if cfg.get('enable_pred_normals'):
      normals_pred = -ops.l2_normalize(self._dense(next(ids), x))
      use_normals = normals_pred
    density = F.softplus(raw_density + cfg['density_bias'])
    if cfg.get('disable_rgb'):
      rgb = torch.zeros_like(means)
    else:
      if cfg.get('use_diffuse_color'):
        raw_diffuse = self._dense(next(ids), x)
      if cfg.get('use_specular_tint'):
        tint = torch.sigmoid(self._dense(next(ids), x))
      roughness = None
      if cfg.get('enable_pred_roughness'):
        roughness = F.softplus(self._dense(next(ids), x) - 1.0)
      parts = []
      if cfg['bottleneck_width'] > 0:
        parts.append(self._dense(next(ids), x))
      vd = per_sample(viewdirs)
      if cfg.get('use_reflections'):
        parts.append(self.ide(ops.reflect(-vd, use_normals), roughness))
      else:
        parts.append(per_sample(ops.pos_enc(viewdirs, 0, cfg['deg_view'])))
      if cfg.get('use_n_dot_v'):
        parts.append(torch.sum(use_normals * vd, dim=-1, keepdim=True))
      x = torch.cat(parts, dim=-1)
      inputs = x
      for i in range(cfg['net_depth_viewdirs']):
        x = torch.relu(self._dense(next(ids), x, self.dtype))
        if i % cfg['skip_layer_dir'] == 0 and i > 0:
          x = torch.cat([x.to(inputs.dtype), inputs], dim=-1)
      rgb = torch.sigmoid(self._dense(next(ids), x))
      if cfg.get('use_diffuse_color'):
        diffuse = torch.sigmoid(raw_diffuse - math.log(3.0))
        specular = tint * rgb if cfg.get('use_specular_tint') else 0.5 * rgb
        rgb = torch.clamp(ops.linear_to_srgb(specular + diffuse), 0, 1)
      rgb = rgb * (1 + 2 * 0.001) - 0.001
    unflat = lambda a: None if a is None else a.reshape(shape + a.shape[1:])
    return dict(density=unflat(density), rgb=unflat(rgb),
                normals=unflat(normals), normals_pred=unflat(normals_pred))


class Model:
  """All levels of a model over `params`."""

  def __init__(self, model_cfg, params):
    self.cfg = model_cfg
    self.nerf = MLP(model_cfg['nerf_mlp'], 'NerfMLP_0', params)
    self.prop = (self.nerf if model_cfg.get('single_mlp') else
                 MLP(model_cfg['prop_mlp'], 'PropMLP_0', params))

  def __call__(self, rays, train_frac, generator):
    """rays: {origins, directions, viewdirs, radii, near, far} on the
    device.  Returns (per-level rgb [R, 3], ray history)."""
    cfg = self.cfg
    near, far = rays['near'], rays['far']
    s_to_t = ops.ray_warps(cfg.get('raydist_fn'), near, far)
    s_edges = torch.cat([torch.zeros_like(near), torch.ones_like(far)], -1)
    weights = torch.ones_like(near)
    resolution = 1
    rgbs, history = [], []
    for level in range(cfg['num_levels']):
      final = level == cfg['num_levels'] - 1
      samples = cfg['num_nerf_samples'] if final else cfg['num_prop_samples']
      with torch.no_grad():
        if level > 0 and (cfg['dilation_bias'] > 0 or
                          cfg['dilation_multiplier'] > 0):
          pad = cfg['dilation_bias'] + cfg['dilation_multiplier'] / resolution
          s_edges, weights = ops.max_dilate_weights(s_edges, weights, pad,
                                                    (0.0, 1.0))
          s_edges, weights = s_edges[..., 1:-1], weights[..., 1:-1]
        resolution *= samples
        ease = (_schlick(train_frac, cfg['anneal_slope'])
                if cfg['anneal_slope'] > 0 else 1.0)
        logits = torch.where(s_edges[..., 1:] > s_edges[..., :-1],
                             ease * torch.log(weights +
                                              cfg['resample_padding']),
                             -torch.inf)
        s_edges = ops.sample_intervals(generator, s_edges, logits, samples,
                                       cfg['single_jitter'], (0.0, 1.0))
      t_edges = s_to_t(s_edges)
      means, covs = ops.cast_frustums(t_edges, rays['origins'],
                                      rays['directions'], rays['radii'])
      out = (self.nerf if final else self.prop)(means, covs, rays['viewdirs'])
      weights = ops.alpha_weights(out['density'], t_edges, rays['directions'],
                                  cfg.get('opaque_background', False))
      acc = weights.sum(dim=-1)
      rgb = ((weights[..., None] * out['rgb']).sum(dim=-2) +
             torch.clamp(1 - acc[..., None], min=0) * 1.0)
      rgbs.append(rgb)
      out.update(sdist=s_edges.clone(), weights=weights.clone())
      history.append(out)
    return rgbs, history


def losses(rgbs, history, rays, target, train):
  """{term: scalar} of the training loss (``train`` is the configuration
  file's "train" section)."""
  out = {}
  resid_sq = [(r - target)**2 for r in rgbs]
  if train['data_loss_type'] == 'charb':
    terms = [torch.sqrt(r + train['charb_padding']**2) for r in resid_sq]
  elif train['data_loss_type'] == 'mse':
    terms = resid_sq
  else:
    raise ValueError(train['data_loss_type'])
  means = [t.mean() for t in terms]
  out['data'] = (train['data_coarse_loss_mult'] * sum(means[:-1]) +
                 train['data_loss_mult'] * means[-1])
  last = history[-1]
  if train['interlevel_loss_mult'] > 0:
    c, w = last['sdist'].detach(), last['weights'].detach()
    out['interlevel'] = train['interlevel_loss_mult'] * sum(
        torch.mean(ops.lossfun_outer(c, w, h['sdist'], h['weights']))
        for h in history[:-1])
  if train['distortion_loss_mult'] > 0:
    out['distortion'] = train['distortion_loss_mult'] * torch.mean(
        ops.lossfun_distortion(last['sdist'], last['weights']))
  n_levels = len(history)
  if (train['orientation_loss_mult'] > 0 or
      train['orientation_coarse_loss_mult'] > 0):
    v = -rays['viewdirs']
    total = 0.0
    for i, h in enumerate(history):
      n_dot_v = (h[train['orientation_loss_target']] * v[..., None, :]).sum(-1)
      term = torch.mean((h['weights'] * torch.clamp(n_dot_v, max=0)**2
                         ).sum(-1))
      mult = (train['orientation_coarse_loss_mult'] if i < n_levels - 1
              else train['orientation_loss_mult'])
      total = total + mult * term
    out['orientation'] = total
  if (train['predicted_normal_loss_mult'] > 0 or
      train['predicted_normal_coarse_loss_mult'] > 0):
    total = 0.0
    for i, h in enumerate(history):
      term = torch.mean((h['weights'] * (
          1.0 - torch.sum(h['normals'] * h['normals_pred'], -1))).sum(-1))
      mult = (train['predicted_normal_coarse_loss_mult'] if i < n_levels - 1
              else train['predicted_normal_loss_mult'])
      total = total + mult * term
    out['predicted_normals'] = total
  return out


def clip_by_module(grads, max_norm):
  """Each top-level module's gradient scaled to norm <= max_norm, NaNs
  zeroed."""
  if max_norm <= 0:
    return {k: torch.nan_to_num(g) for k, g in grads.items()}
  modules = {}
  for k in grads:
    modules.setdefault(k.split('/')[0], []).append(k)
  out = {}
  for names in modules.values():
    norm = torch.sqrt(sum(torch.sum(grads[k]**2) for k in names))
    mult = torch.clamp(max_norm / (ops.F32_EPS + norm), max=1.0)
    out.update({k: torch.nan_to_num(mult * grads[k]) for k in names})
  return out


def gradients(model, params, rays, target, train_frac, generator, train,
              rows=None):
  """(loss, {name: raw gradient}) of one batch; `rows` keeps only those
  rays (a fault planted in the reference: part of the batch left out)."""
  if rows is not None:
    rays = {k: v[rows] for k, v in rays.items()}
    target = target[rows]
  rgbs, history = model(rays, train_frac, generator)
  terms = losses(rgbs, history, rays, target, train)
  loss = sum(terms.values())
  names = list(params)
  grads = torch.autograd.grad(loss, [params[k] for k in names],
                              allow_unused=True)
  grads = {k: torch.zeros_like(params[k]) if g is None else g
           for k, g in zip(names, grads)}
  return loss.detach(), grads
