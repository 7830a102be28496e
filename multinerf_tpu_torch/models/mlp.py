"""The NeRF MLP of the mip-NeRF 360 render and train paths (models/mlp.py).

Parameters keep the flax names and layout: ``Dense_{i}.kernel`` [in, out]
and ``Dense_{i}.bias`` [out], numbered in the JAX creation order
(mlp.py:250-257), so a JAX parameter tree loads by renaming alone
(``multinerf_tpu_torch.bridge``).

Only the fused path of the 360 config is ported:

* a density-only MLP (PropMLP: ``disable_rgb``, no in-trunk skip) runs
  whole in the fused density kernel (mlp.py:301-331);
* with ``trunk_dtype`` 'int8' or 'int8_hybrid' and a ReLU activation, the
  whole NerfMLP trunk runs in the fused int8 trunk kernel, which returns a
  bf16 activation (mlp.py:332-359);
* otherwise (NerfMLP) layer 0 and the feature half of every skip layer run
  in the fused featurize -> Dense kernel (mlp.py:360-374); the hidden layers
  are plain products in ``trunk_dtype`` ('float32' or 'bfloat16'), or
  ``quant.quant_dense`` for the int8 modes;
* then the density head, the bottleneck, the per-ray ``pos_enc`` view
  encoding, the view branch (its hidden layers ``quant.quant_dense`` under
  the int8 modes) and the rgb head (mlp.py:404-504); the heads are f32
  products, which promote a bf16 input.

``use_fused_featurize=None`` means the fused kernels.  Unlike mlp.py:288,
which takes the unfused f32 path on a CPU, the port runs the same call on
the CPU through the kernels' plain versions, so its CPU numerics are the
kernels' numerics.  Gradients reach every parameter: through the fused
kernels' backward passes (which give the sample positions none, as in the
JAX custom VJPs), the plain hidden-layer products, the heads and the view
branch.  Configurations outside this slice raise NotImplementedError
naming the ROADMAP item that brings them; so does training with density or
bottleneck noise.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from multinerf_tpu_torch import ginlite
from multinerf_tpu_torch.models import initializers
from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.ops import geopoly
from multinerf_tpu_torch.ops import quant
from multinerf_tpu_torch.ops.kernels import density_mlp as dm
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
_INT8 = ('int8', 'int8_hybrid')


@dataclasses.dataclass
class MLPConfig:
  """The fields of multinerf_tpu.models.mlp.MLP, with the same defaults."""
  net_depth: int = 8
  net_width: int = 256
  bottleneck_width: int = 256
  net_depth_viewdirs: int = 1
  net_width_viewdirs: int = 128
  net_activation: Callable[..., Any] = torch.relu
  min_deg_point: int = 0
  max_deg_point: int = 12
  weight_init: str = 'he_uniform'
  skip_layer: int = 4
  skip_layer_dir: int = 4
  num_rgb_channels: int = 3
  deg_view: int = 4
  use_reflections: bool = False
  use_directional_enc: bool = False
  enable_pred_roughness: bool = False
  roughness_activation: Callable[..., Any] = F.softplus
  roughness_bias: float = -1.0
  use_diffuse_color: bool = False
  use_specular_tint: bool = False
  use_n_dot_v: bool = False
  bottleneck_noise: float = 0.0
  density_activation: Callable[..., Any] = F.softplus
  density_bias: float = -1.0
  density_noise: float = 0.0
  rgb_premultiplier: float = 1.0
  rgb_activation: Callable[..., Any] = torch.sigmoid
  rgb_bias: float = 0.0
  rgb_padding: float = 0.001
  enable_pred_normals: bool = False
  disable_density_normals: bool = False
  disable_rgb: bool = False
  warp_fn: Callable[..., Any] = None
  basis_shape: str = 'icosahedron'
  basis_subdivisions: int = 2
  trunk_dtype: str = 'float32'
  use_fused_featurize: Any = None
  inputs_have_stop_gradient: bool = True


@ginlite.configurable(name='NerfMLP')
@dataclasses.dataclass
class NerfMLP(MLPConfig):
  pass


@ginlite.configurable(name='PropMLP')
@dataclasses.dataclass
class PropMLP(MLPConfig):
  pass


def _unsupported(cfg: MLPConfig):
  """The ROADMAP item of the first option this port does not cover."""
  ref_nerf = 'ROADMAP.md Queue 1: the rest of the model zoo, Ref-NeRF'
  unfused = 'ROADMAP.md Queue 1: serving slice, the unfused MLP path'
  checks = [
      (not cfg.disable_density_normals, 'density-gradient normals', ref_nerf),
      (cfg.enable_pred_normals, 'predicted normals', ref_nerf),
      (cfg.use_reflections, 'reflection directions', ref_nerf),
      (cfg.use_directional_enc, 'the integrated directional encoding',
       ref_nerf),
      (cfg.enable_pred_roughness, 'predicted roughness', ref_nerf),
      (cfg.use_diffuse_color, 'diffuse color', ref_nerf),
      (cfg.use_specular_tint, 'specular tint', ref_nerf),
      (cfg.use_n_dot_v, 'n.v features', ref_nerf),
      (cfg.trunk_dtype not in (*_DTYPES, *_INT8),
       f'trunk_dtype={cfg.trunk_dtype!r}',
       'the port takes float32, bfloat16, int8 and int8_hybrid'),
      (cfg.use_fused_featurize is False, 'the unfused featurization', unfused),
      (cfg.warp_fn not in (None, coord.contract) or
       not cfg.inputs_have_stop_gradient or
       (cfg.net_depth > 1 and (cfg.net_depth - 1) % cfg.skip_layer == 0),
       'a configuration the fused kernels cannot take',
       unfused),
  ]
  for bad, what, item in checks:
    if bad:
      return f'{what} ({item})'
  return None


class Dense(nn.Module):
  """flax ``nn.Dense``'s parameters: kernel [in, out], bias [out]."""

  def __init__(self, in_features, features, kernel_init, generator, device):
    super().__init__()
    self.kernel = nn.Parameter(
        kernel_init((in_features, features), generator).to(device))
    self.bias = nn.Parameter(torch.zeros(features, device=device))

  def forward(self, x, dtype=None):
    """x @ kernel + bias; with `dtype`, inputs, kernel and bias are cast to
    it first (flax ``nn.Dense(dtype=...)``), else x is promoted to f32."""
    if dtype is None:
      return x.to(self.kernel.dtype) @ self.kernel + self.bias
    return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


class MLP(nn.Module):
  """The positional-encoding MLP (forward at rng=None)."""

  def __init__(self, cfg: MLPConfig, use_viewdirs=True, *, generator,
               device):
    super().__init__()
    problem = _unsupported(cfg)
    if problem:
      raise NotImplementedError(f'Not ported yet: {problem}.')
    self.cfg = cfg
    self.use_viewdirs = use_viewdirs
    self.pos_basis_t = np.array(
        geopoly.generate_basis(cfg.basis_shape, cfg.basis_subdivisions)).T
    self.num_feats = 2 * (cfg.max_deg_point - cfg.min_deg_point) * (
        self.pos_basis_t.shape[-1])
    self.hidden_dtype = _DTYPES.get(cfg.trunk_dtype)
    self.int8 = cfg.trunk_dtype in _INT8
    self.hybrid = cfg.trunk_dtype == 'int8_hybrid'
    self.full_density_fusion = (cfg.disable_rgb and
                                cfg.net_depth <= cfg.skip_layer)
    kernel_init = getattr(initializers, cfg.weight_init)()
    ids = itertools.count()

    def dense(in_features, features):
      layer = Dense(in_features, features, kernel_init, generator, device)
      self.add_module(f'Dense_{next(ids)}', layer)
      return layer

    # Plain lists and a dict (not attributes) hold the layers, so that each
    # is registered once, under its Dense_i name.
    width = cfg.net_width
    self.trunk = []
    for i in range(cfg.net_depth):
      in_features = self.num_feats if i == 0 else width
      if self._is_skip(i):
        in_features += self.num_feats
      self.trunk.append(dense(in_features, width))
    self.heads = {'density': dense(width, 1)}
    self.view_branch = []
    if cfg.disable_rgb:
      return
    x_width = width
    if use_viewdirs:
      inputs_width = 3 + 6 * cfg.deg_view
      if cfg.bottleneck_width > 0:
        self.heads['bottleneck'] = dense(width, cfg.bottleneck_width)
        inputs_width += cfg.bottleneck_width
      x_width = inputs_width
      for i in range(cfg.net_depth_viewdirs):
        self.view_branch.append(dense(x_width, cfg.net_width_viewdirs))
        x_width = cfg.net_width_viewdirs
        if i % cfg.skip_layer_dir == 0 and i > 0:
          x_width += inputs_width
    self.heads['rgb'] = dense(x_width, cfg.num_rgb_channels)

  def _is_skip(self, i):
    """Layer i takes [x, features] (the fused path's numbering)."""
    return i > 1 and (i - 1) % self.cfg.skip_layer == 0

  def _hidden(self, layer, x):
    """A hidden layer's product in trunk_dtype (QuantDense under int8)."""
    if self.int8:
      return quant.quant_dense(layer, x, self.hybrid)
    return layer(x, self.hidden_dtype)

  def _trunk(self, means, covs):
    cfg = self.cfg
    kw = dict(basis=self.pos_basis_t, min_deg=cfg.min_deg_point,
              max_deg=cfg.max_deg_point,
              use_contract=cfg.warp_fn is coord.contract)
    if self.int8 and cfg.net_activation is torch.relu:
      return i8t.int8_trunk(
          means, covs, [l.kernel for l in self.trunk],
          [l.bias for l in self.trunk],
          skip_layers=[i for i in range(cfg.net_depth) if self._is_skip(i)],
          bwd_bf16=self.hybrid, **kw)
    first = self.trunk[0]
    x = cfg.net_activation(
        fd.featurize_dense(means, covs, first.kernel, first.bias, **kw))
    for i, layer in enumerate(self.trunk[1:], start=1):
      if self._is_skip(i):
        # concat([x, feats]) @ W == x @ W[:width] + feats @ W[width:]; the
        # feature half runs in the fused kernel, which adds the bias.
        width_x = x.shape[-1]
        x = x.to(layer.kernel.dtype) @ layer.kernel[:width_x] + (
            fd.featurize_dense(means, covs, layer.kernel[width_x:],
                               layer.bias, **kw))
      else:
        x = self._hidden(layer, x)
      x = cfg.net_activation(x)
    return x

  def forward(self, means, covs, viewdirs=None, generator=None):
    """Density and color of sample Gaussians.

    Args:
      means: [..., S, 3]; covs: [..., S, 3, 3] sample Gaussians.
      viewdirs: [..., 3] unit view directions per ray, or None.
      generator: the training step's torch.Generator, or None (the JAX
        rng=None); only density and bottleneck noise would draw from it.

    Returns:
      dict with 'density' [..., S] and 'rgb' [..., S, 3].
    """
    cfg = self.cfg
    if generator is not None and (cfg.density_noise > 0 or
                                  cfg.bottleneck_noise > 0):
      raise NotImplementedError(
          'Not ported yet: density and bottleneck noise (ROADMAP.md Queue 1 '
          'item 4: the rest of the model zoo, RawNeRF).')
    sample_shape = means.shape[:-1]
    means = means.reshape(-1, 3)
    covs = covs.reshape(-1, 3, 3)
    n_flat = means.shape[0]

    head = self.heads['density']
    if self.full_density_fusion:
      raw_density = dm.density_mlp(
          means, covs, [l.kernel for l in self.trunk],
          [l.bias for l in self.trunk], head.kernel, head.bias[0],
          self.pos_basis_t,
          min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
          use_contract=cfg.warp_fn is coord.contract)
      x = None
    else:
      x = self._trunk(means, covs)
      raw_density = head(x)[..., 0]
    density = cfg.density_activation(raw_density + cfg.density_bias)

    if cfg.disable_rgb:
      rgb = torch.zeros_like(means)
    else:
      if self.use_viewdirs:
        if viewdirs is None:
          raise ValueError('this MLP was built to take view directions.')
        parts = []
        if 'bottleneck' in self.heads:
          parts.append(self.heads['bottleneck'](x))
        # Encode per RAY (cheaper), then broadcast per sample.
        dir_enc = coord.pos_enc(viewdirs, min_deg=0, max_deg=cfg.deg_view,
                                append_identity=True)
        parts.append(torch.broadcast_to(
            dir_enc[..., None, :],
            sample_shape + (dir_enc.shape[-1],)).reshape(n_flat, -1))
        x = torch.cat(parts, dim=-1)
        inputs = x
        for i, layer in enumerate(self.view_branch):
          x = cfg.net_activation(self._hidden(layer, x))
          if i % cfg.skip_layer_dir == 0 and i > 0:
            x = torch.cat([x.to(inputs.dtype), inputs], dim=-1)
      rgb = cfg.rgb_activation(
          cfg.rgb_premultiplier * self.heads['rgb'](x) + cfg.rgb_bias)
      rgb = rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding

    return dict(density=density.reshape(sample_shape),
                rgb=rgb.reshape(sample_shape + rgb.shape[-1:]))
