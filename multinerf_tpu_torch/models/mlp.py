"""The NeRF MLP of the render and train paths (models/mlp.py).

Parameters keep the flax names and layout: ``Dense_{i}.kernel`` [in, out]
and ``Dense_{i}.bias`` [out], numbered in the JAX creation order
(mlp.py:250-257): the trunk, the density head, then the Ref-NeRF heads
(predicted normals, diffuse, tint, roughness), the bottleneck, the view
branch and the rgb head.  So a JAX parameter tree loads by renaming alone
(``multinerf_tpu_torch.bridge``).

The trunk takes one of two paths, chosen as mlp.py:281-289 chooses:

* fused, when the MLP is eligible (density normals off, sample Gaussians
  behind a stop-gradient, no warp or ``contract``, no skip at the trunk's
  last layer) and ``use_fused_featurize`` is None or True:
  - a density-only MLP (PropMLP: ``disable_rgb``, no in-trunk skip, no
    predicted normals) runs whole in the fused density kernel
    (mlp.py:301-331);
  - with ``trunk_dtype`` 'int8' or 'int8_hybrid' and a ReLU activation, the
    whole trunk runs in the fused int8 trunk kernel, which returns a bf16
    activation (mlp.py:332-359);
  - otherwise layer 0 and the feature half of every skip layer run in the
    fused featurize -> Dense kernel (mlp.py:360-374), the hidden layers are
    plain products in ``trunk_dtype`` ('float32' or 'bfloat16'), or
    ``quant.quant_dense`` for the int8 modes;
* unfused otherwise (mlp.py:375-403): the warp through
  ``coord.track_linearize``, f32 features from the lifted IPE, then every
  trunk layer a plain product in ``trunk_dtype`` (the first casts the f32
  features to it, as flax's ``nn.Dense(dtype=...)`` does; the JAX package
  stores them in bf16 on a TPU, a choice for its matrix unit).  This path
  is differentiable in the sample means: density-gradient normals (one
  batched ``torch.autograd.grad`` of the summed raw density, the sum trick
  of mlp.py:414-426, with ``create_graph`` whenever gradients are on, so
  that the orientation loss reaches the weights) and
  ``Model.stop_level_grad=False`` need it.

Then the density head, the Ref-NeRF heads, the bottleneck, the view
encoding (``pos_enc`` per ray, or the IDE of reflected directions per
sample), n.v, the view branch and the rgb head, with the diffuse/specular
combination through ``linear_to_srgb`` (mlp.py:404-504), the view branch taking
the per-ray GLO vector last (mlp.py:481-482).  The heads are f32 products,
which promote a bf16 input; on a layer whole on its rank such a product
(the heads', the skip layer's activation rows) runs on the card as bf16
products of the exact three-way bf16 split of the f32 weight, summed in
f32 (``_SplitProduct``).  ``use_fused_featurize=None`` takes the fused
kernels on the CPU too (through their plain versions), unlike mlp.py:288.
Density and bottleneck noise (RawNeRF's) are drawn from the training
step's ``torch.Generator`` and are off without one (eval, render).  Int8
trunks with density normals run unfused, their ``quant_dense`` layers
under the density-normal ``autograd.grad(create_graph=True)``: both int8
Functions' backwards are differentiable again (``ops/quant.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from multinerf_tpu_torch import ginlite
from multinerf_tpu_torch.models import initializers
from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.ops import geopoly
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.ops import quant
from multinerf_tpu_torch.ops import ref_utils
from multinerf_tpu_torch.ops.kernels import density_mlp as dm
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.parallel import tensor

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


def fused_eligible(cfg: MLPConfig):
  """Whether the fused kernels can take this MLP (mlp.py:281-286): they
  give the sample Gaussians no gradient, featurize unwarped or contracted
  Gaussians only, and cannot end the trunk on a skip."""
  return (cfg.disable_density_normals and cfg.inputs_have_stop_gradient and
          cfg.warp_fn in (None, coord.contract) and
          (cfg.net_depth <= 1 or (cfg.net_depth - 1) % cfg.skip_layer != 0))


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
      return _f32_product(x, self.kernel, self.split) + self.bias
    return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)

  @property
  def split(self):
    """The kernel's ``tensor.Split`` when this rank holds a part of it."""
    return getattr(self.kernel, 'tp_split', None)

  def shard_(self, splits):
    """Keep this rank's part of each leaf `splits` ({'kernel' or 'bias':
    Split}) names, as a contiguous parameter of its own."""
    for attr, split in splits.items():
      part = nn.Parameter(tensor.shard(getattr(self, attr).detach(), attr,
                                       splits))
      part.tp_split = split
      setattr(self, attr, part)

  def full(self):
    """A Dense of the whole kernel and bias, gathered over the model group
    where this rank holds a part (their gradients come back as this rank's
    part); this layer itself where it holds all of them."""
    if self.split is None:
      return self
    return _Whole(tensor.gather_from_model(self.kernel, self.split),
                  tensor.gather_from_model(
                      self.bias, getattr(self.bias, 'tp_split', None)))


class _Whole:
  """A Dense's gathered kernel and bias, called as the Dense is."""

  split = None

  def __init__(self, kernel, bias):
    self.kernel, self.bias = kernel, bias

  __call__ = Dense.forward


class _Bf16Product(torch.autograd.Function):
  """a @ b of bf16 operands with an f32 result (a row layer's partial sum
  under the bf16 trunk, summed over the model group before it is rounded),
  and the bf16 backward of the one-device bf16 product."""

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a, b)
    return _mm_f32(a, b)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    g = g.to(torch.bfloat16)
    return g @ b.T, a.T @ g


def _mm_f32(a, b, acc=None):
  """a @ b of bf16 operands, summed in f32 into an f32 result; with `acc`
  (on the card), added to it in place.  On the card one cuBLAS call (f32
  output, so no reduced-precision reduction); on the CPU the same product
  of the operands promoted to f32, where bf16 products are exact."""
  if not a.is_cuda:
    return a.float() @ b.float()
  if acc is None:
    return torch.mm(a, b, out_dtype=torch.float32)
  return torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)


# Products taken through _SplitProduct (forward), in the idiom of the
# kernel wrappers' `counts`.
split_counts = {'forward': 0}


def reset_split_counts():
  split_counts['forward'] = 0


def split_bf16(w):
  """(hi, mid, lo): bf16 pieces of the f32 `w` with hi + mid + lo == w
  exactly, each the bf16 rounding of what the pieces before it leave (each
  subtraction is exact in f32, and three 8-bit significands with their
  rounding cover f32's 24)."""
  hi = w.to(torch.bfloat16)
  rest = w - hi.float()
  mid = rest.to(torch.bfloat16)
  return hi, mid, (rest - mid.float()).to(torch.bfloat16)


# A product with at most this many output columns is narrow: bound by
# reading x, it reads it once.
_NARROW = 8
# Rows of w a narrow product's partial sums take.
_SLAB = 128


def _split_mm(x, w):
  """x @ w in f32 for a bf16 x [N, K] and an f32 w [K, M], as bf16
  products of w's exact split summed in f32: wide, x @ hi, then x @ mid
  and x @ lo added into it; narrow, one product of x with a block-diagonal
  weight that holds the three pieces' columns for each slab of _SLAB rows
  of w, whose partial sums are then added (the tensor cores' f32 sums lose
  more over a long K than a matrix-vector kernel's, and slabs of 128 keep
  them within its error)."""
  hi, mid, lo = split_bf16(w)
  k, m = w.shape
  if m > _NARROW:
    return _mm_f32(x, lo, _mm_f32(x, mid, _mm_f32(x, hi)))
  slabs = k // _SLAB if k % _SLAB == 0 else 1
  blocks = torch.stack([hi, mid, lo], 1).reshape(slabs, k // slabs, 3 * m)
  wide = torch.block_diag(*blocks.unbind(0))
  return _mm_f32(x, wide).view(-1, 3 * slabs, m).sum(1)


class _SplitProduct(torch.autograd.Function):
  """x @ w in f32 for a bf16 x and an f32 w: the product of x promoted to
  f32, on the card's tensor cores through ``_split_mm`` (the same f32
  product up to the order of its sums, where the promoted product runs on
  the CUDA cores with TF32 off); on the CPU its plain version, the promoted
  product itself.  The backward is the promoted product's, bit for bit:
  g @ w^T rounded to bf16 (as ``ToCopyBackward`` rounds it) and
  x.float()^T @ g, in plain operations that a double backward
  differentiates."""

  @staticmethod
  def forward(ctx, x, w):
    ctx.save_for_backward(x, w)
    split_counts['forward'] += 1
    x2 = x.reshape(-1, x.shape[-1])
    y = _split_mm(x2, w) if x.is_cuda else x2.float() @ w
    return y.view(*x.shape[:-1], w.shape[-1])

  @staticmethod
  def backward(ctx, g):
    x, w = ctx.saved_tensors
    g = g.reshape(-1, g.shape[-1])
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = g.mm(w.t()).to(x.dtype).view(x.shape)
    if ctx.needs_input_grad[1]:
      dw = x.reshape(-1, x.shape[-1]).float().t().mm(g)
    return dx, dw


def _f32_product(x, kernel, split):
  """x @ kernel in f32, x promoted as flax promotes a bf16 input of an f32
  Dense: through ``_SplitProduct`` when x is bf16, the kernel f32 and the
  layer whole on this rank (`split`, its Split, None: a one-device layer,
  or one gathered by ``Dense.full()``, as the int8 model's layers are under
  tensor parallelism); else the promoted product."""
  if (split is None and x.dtype == torch.bfloat16 and
      kernel.dtype == torch.float32):
    return _SplitProduct.apply(x, kernel)
  return x.to(kernel.dtype) @ kernel


class _ColumnBf16(torch.autograd.Function):
  """x @ w of bf16 operands with a bf16 result, for a column layer: its
  input's gradient, a partial sum over this rank's columns, is summed over
  the model group in f32 and then rounded to bf16, as the one-device
  product's is."""

  @staticmethod
  def forward(ctx, x, w):
    ctx.save_for_backward(x, w)
    return x @ w

  @staticmethod
  def backward(ctx, g):
    x, w = ctx.saved_tensors
    dx = tensor.reduce_from_model(_Bf16Product.apply(g, w.T))
    return dx.to(torch.bfloat16), x.T @ g


def _out_split(layer):
  """The Split of the columns a column layer leaves on the ranks; None for
  any other layer."""
  if layer.split is None or layer.split.kind != tensor.COLUMN:
    return None
  return tensor.activation_split(layer.split.shape[-1])


def _partial_product(x, kernel, dtype):
  """x @ kernel in f32, of bf16-rounded operands when `dtype` is bf16."""
  if dtype == torch.bfloat16:
    return _Bf16Product.apply(x.to(dtype), kernel.to(dtype))
  return x.to(kernel.dtype) @ kernel


def _summed(partial, bias, dtype):
  """The sum over the model group of a row layer's `partial` product,
  rounded to `dtype` as the one-device product is, plus the bias."""
  y = tensor.reduce_from_model(partial)
  if dtype == torch.bfloat16:
    return y.to(dtype) + bias.to(dtype)
  return y + bias


class MLP(nn.Module):
  """The positional-encoding MLP with its Ref-NeRF heads (forward at
  rng=None)."""

  def __init__(self, cfg: MLPConfig, use_viewdirs=True, num_glo_features=0,
               *, generator, device):
    """`num_glo_features`: the width of the GLO vector the view branch
    takes per ray (0: none)."""
    super().__init__()
    if cfg.trunk_dtype not in (*_DTYPES, *_INT8):
      raise NotImplementedError(
          f'Not ported yet: trunk_dtype={cfg.trunk_dtype!r} (the port takes '
          'float32, bfloat16, int8 and int8_hybrid).')
    if cfg.use_reflections and not (cfg.enable_pred_normals or
                                    not cfg.disable_density_normals):
      raise ValueError('Normals must be computed for reflection directions.')
    self.cfg = cfg
    self.use_viewdirs = use_viewdirs
    self.num_glo_features = num_glo_features
    self.pos_basis_t = np.array(
        geopoly.generate_basis(cfg.basis_shape, cfg.basis_subdivisions)).T
    self.num_feats = 2 * (cfg.max_deg_point - cfg.min_deg_point) * (
        self.pos_basis_t.shape[-1])
    self.hidden_dtype = _DTYPES.get(cfg.trunk_dtype)
    self.int8 = cfg.trunk_dtype in _INT8
    self.hybrid = cfg.trunk_dtype == 'int8_hybrid'
    self.fused = (cfg.use_fused_featurize is not False and
                  fused_eligible(cfg))
    self.full_density_fusion = (self.fused and cfg.disable_rgb and
                                not cfg.enable_pred_normals and
                                cfg.net_depth <= cfg.skip_layer)
    if cfg.use_directional_enc:
      self.dir_enc_fn = ref_utils.generate_ide_fn(cfg.deg_view)
    else:
      self.dir_enc_fn = lambda direction, _: coord.pos_enc(
          direction, min_deg=0, max_deg=cfg.deg_view, append_identity=True)
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
    # A skip after the trunk's last layer (unfused only) widens its output.
    x_width = width + (self.num_feats if self._is_skip(cfg.net_depth) else 0)
    self.heads = {'density': dense(x_width, 1)}
    if cfg.enable_pred_normals:
      self.heads['grad_pred'] = dense(x_width, 3)
    self.view_branch = []
    if cfg.disable_rgb:
      return
    if use_viewdirs:
      if cfg.use_diffuse_color:
        self.heads['diffuse'] = dense(x_width, cfg.num_rgb_channels)
      if cfg.use_specular_tint:
        self.heads['tint'] = dense(x_width, 3)
      if cfg.enable_pred_roughness:
        self.heads['roughness'] = dense(x_width, 1)
      inputs_width = (self._dir_enc_width() + int(cfg.use_n_dot_v) +
                      num_glo_features)
      if cfg.bottleneck_width > 0:
        self.heads['bottleneck'] = dense(x_width, cfg.bottleneck_width)
        inputs_width += cfg.bottleneck_width
      x_width = inputs_width
      for i in range(cfg.net_depth_viewdirs):
        self.view_branch.append(dense(x_width, cfg.net_width_viewdirs))
        x_width = cfg.net_width_viewdirs
        if i % cfg.skip_layer_dir == 0 and i > 0:
          x_width += inputs_width
    self.heads['rgb'] = dense(x_width, cfg.num_rgb_channels)

  def _dir_enc_width(self):
    cfg = self.cfg
    if cfg.use_directional_enc:
      return 2 * ref_utils.get_ml_array(cfg.deg_view).shape[1]
    return 3 + 6 * cfg.deg_view

  def _is_skip(self, i):
    """Layer i takes [x, features]: the features are concatenated after
    layer i - 1 when (i - 1) % skip_layer == 0 and i > 1."""
    return i > 1 and (i - 1) % self.cfg.skip_layer == 0

  def _dense(self, layer, x, x_split=None, dtype=None, hidden=False):
    """(y, y_split): `layer` on `x`, whole (`x_split` None) or split by
    columns over the model group (`x_split`, its Split), as a hidden layer
    (trunk_dtype; QuantDense under int8) or with `dtype`.  y_split is the
    Split of y's columns where a column layer leaves them split, else
    None."""
    dtype = self.hidden_dtype if hidden else dtype
    split = layer.split
    if split is not None and split.kind == tensor.ROW and not self.int8:
      if x_split is None:
        x = tensor.scatter_to_model(
            x, tensor.activation_split(x.shape[-1]))
      return _summed(_partial_product(x, layer.kernel, dtype), layer.bias,
                     dtype), None
    x = tensor.gather_from_model(x, x_split)
    if split is None or self.int8:
      # Int8 products quantize along the whole contraction axis: they run
      # on the gathered weights.
      layer = layer.full()
      if hidden and self.int8:
        return quant.quant_dense(layer, x, self.hybrid), None
      return layer(x, dtype), None
    if dtype == torch.bfloat16:
      y = _ColumnBf16.apply(x.to(dtype), layer.kernel.to(dtype)) + (
          layer.bias.to(dtype))
    else:
      y = layer(tensor.copy_to_model(x), dtype)
    return y, _out_split(layer)

  def _head(self, name, x):
    """A head's output, whole, from the whole trunk output `x`."""
    y, y_split = self._dense(self.heads[name], x)
    return tensor.gather_from_model(y, y_split)

  def _skip_dense(self, layer, x, x_split, feats_product, dtype):
    """(y, y_split) of the skip layer `layer` on [x, features], x whole or
    split (`x_split`), given `feats_product(kernel)`, the features' f32
    product with a kernel of feature rows, and the product's `dtype` (as
    ``_dense`` takes it).  A row-split skip layer multiplies x's columns by
    its x rows in place and puts its feature columns' product into its
    columns of the partial sum, the bias added after the sum; None for any
    other skip layer."""
    split = layer.split
    if split is None or split.kind != tensor.SKIP or self.int8:
      return None
    x_rows, feat_cols = tensor.skip_parts(layer.kernel, split,
                                          mesh.model_size())
    if x_split is None:
      x = tensor.scatter_to_model(x, tensor.activation_split(x.shape[-1]))
    width = split.shape[-1]
    cols = feat_cols.shape[-1]
    first = mesh.model_rank() * cols
    partial = _partial_product(x, x_rows, dtype) + F.pad(
        feats_product(feat_cols), (first, width - first - cols))
    return _summed(partial, layer.bias, dtype), None

  def _fused_trunk(self, means, covs):
    """(trunk output, its Split where it is split by columns)."""
    cfg = self.cfg
    kw = dict(basis=self.pos_basis_t, min_deg=cfg.min_deg_point,
              max_deg=cfg.max_deg_point,
              use_contract=cfg.warp_fn is coord.contract)
    if self.int8 and cfg.net_activation is torch.relu:
      layers = [l.full() for l in self.trunk]
      return i8t.int8_trunk(
          means, covs, [l.kernel for l in layers], [l.bias for l in layers],
          skip_layers=[i for i in range(cfg.net_depth) if self._is_skip(i)],
          bwd_bf16=self.hybrid, **kw), None
    first = self.trunk[0].full() if self.int8 else self.trunk[0]
    x = cfg.net_activation(
        fd.featurize_dense(means, covs, first.kernel, first.bias, **kw))
    x_split = _out_split(first)
    for i, layer in enumerate(self.trunk[1:], start=1):
      if self._is_skip(i):
        # The feature rows' product in the fused kernel: with no bias, into
        # this rank's columns of a row-split layer's partial sum.
        skip = self._skip_dense(
            layer, x, x_split,
            lambda w: fd.featurize_dense(means, covs, w,
                                         torch.zeros_like(w[0]), **kw),
            None)
        if skip is not None:
          x, x_split = skip
        else:
          # concat([x, feats]) @ W == x @ W[:width] + feats @ W[width:]; the
          # feature half runs in the fused kernel, which adds the bias (a
          # column layer: its own columns, from the whole x).
          x = tensor.gather_from_model(x, x_split)
          layer = layer.full() if self.int8 else layer
          if layer.split is not None:
            x = tensor.copy_to_model(x)
          width_x = x.shape[-1]
          x = _f32_product(x, layer.kernel[:width_x], layer.split) + (
              fd.featurize_dense(means, covs, layer.kernel[width_x:],
                                 layer.bias, **kw))
          x_split = _out_split(layer)
      else:
        x, x_split = self._dense(layer, x, x_split, hidden=True)
      x = cfg.net_activation(x)
    return x, x_split

  def _unfused_trunk(self, means, covs):
    """(trunk output, its Split where it is split by columns)."""
    cfg = self.cfg
    if cfg.warp_fn is not None:
      means, covs = coord.track_linearize(cfg.warp_fn, means, covs)
    feats = coord.integrated_pos_enc_lifted(
        means, covs, self.pos_basis_t, cfg.min_deg_point, cfg.max_deg_point)
    x, x_split = feats, None
    for i, layer in enumerate(self.trunk):
      skip = None
      if self._is_skip(i):
        dtype = self.hidden_dtype
        skip = self._skip_dense(
            layer, x, x_split,
            lambda w: _partial_product(tensor.copy_to_model(feats), w,
                                       dtype), dtype)
        if skip is None:
          x = torch.cat([tensor.gather_from_model(x, x_split).to(
              feats.dtype), feats], dim=-1)
          x_split = None
      x, x_split = skip or self._dense(layer, x, x_split, hidden=True)
      x = cfg.net_activation(x)
    if self._is_skip(cfg.net_depth):
      x = torch.cat([tensor.gather_from_model(x, x_split).to(feats.dtype),
                     feats], dim=-1)
      x_split = None
    return x, x_split

  def _predict_density(self, means, covs, paths=None):
    """(raw density [N], trunk output [N, C] or None); `paths` is a
    (fused, full_density_fusion) pair other than this MLP's."""
    cfg = self.cfg
    head = self.heads['density']
    fused, full_density_fusion = paths or (self.fused,
                                           self.full_density_fusion)
    if full_density_fusion:
      layers = [l.full() for l in self.trunk]
      head = head.full()
      raw_density = dm.density_mlp(
          means, covs, [l.kernel for l in layers],
          [l.bias for l in layers], head.kernel, head.bias[0],
          self.pos_basis_t,
          min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
          use_contract=cfg.warp_fn is coord.contract)
      return raw_density, None
    trunk = self._fused_trunk if fused else self._unfused_trunk
    x, x_split = trunk(means, covs)
    x = tensor.gather_from_model(x, x_split)
    return self._head('density', x)[..., 0], x

  def probe_density(self, means, covs):
    """The density of this MLP's trunk and density head alone, with no
    noise: the occupancy grid's probe (culling.py:146-161), which JAX runs
    as a clone with ``disable_rgb`` and ``disable_density_normals`` on the
    trained parameters.  The clone's paths are taken: the fused kernels
    whenever the clone is eligible, the whole fused density kernel for a
    trunk no deeper than its skip layer."""
    probe = dataclasses.replace(self.cfg, disable_rgb=True,
                                disable_density_normals=True)
    fused = probe.use_fused_featurize is not False and fused_eligible(probe)
    paths = (fused, fused and not probe.enable_pred_normals and
             probe.net_depth <= probe.skip_layer)
    raw_density, _ = self._predict_density(
        means.reshape(-1, 3), covs.reshape(-1, 3, 3), paths)
    density = probe.density_activation(raw_density + probe.density_bias)
    return density.reshape(means.shape[:-1])

  def forward(self, means, covs, viewdirs=None, glo_vec=None,
              generator=None):
    """Density, color, normals and roughness of sample Gaussians.

    Args:
      means: [..., S, 3]; covs: [..., S, 3, 3] sample Gaussians.
      viewdirs: [..., 3] unit view directions per ray, or None.
      glo_vec: [..., num_glo_features] GLO vector per ray, or None.
      generator: the training step's torch.Generator, or None (the JAX
        rng=None): the density noise, then the bottleneck noise, are drawn
        from it when their multipliers are positive.

    Returns:
      dict with 'density' [..., S], 'rgb' [..., S, 3], and 'normals',
      'raw_grad_density', 'normals_pred', 'grad_pred' [..., S, 3] and
      'roughness' [..., S, 1], each None where the MLP has no such output.
    """
    cfg = self.cfg
    takes_glo = (self.num_glo_features > 0 and self.use_viewdirs and
                 not cfg.disable_rgb)
    if (glo_vec is not None) != takes_glo:
      raise ValueError(f'this MLP takes {self.num_glo_features} GLO '
                       'features in its view branch.')
    sample_shape = means.shape[:-1]
    means = means.reshape(-1, 3)
    covs = covs.reshape(-1, 3, 3)
    n_flat = means.shape[0]

    def per_sample(a):
      """[..., C] per ray -> [N, C] per sample."""
      return torch.broadcast_to(a[..., None, :],
                                sample_shape + a.shape[-1:]).reshape(
                                    n_flat, a.shape[-1])

    raw_grad_density = normals = None
    if cfg.disable_density_normals:
      raw_density, x = self._predict_density(means, covs)
    else:
      # Per-sample density gradients in one batched backward pass: each
      # sample's density depends on its own mean alone, so the gradient of
      # the sum is the per-sample gradient field.  With gradients on, the
      # pass is itself differentiable (the predicted-normal loss reaches the
      # weights through it); else its graph is dropped once it has run.
      create_graph = torch.is_grad_enabled()
      with torch.enable_grad():
        if not means.requires_grad:
          means = means.detach().requires_grad_(True)
        raw_density, x = self._predict_density(means, covs)
        raw_grad_density, = torch.autograd.grad(
            raw_density.sum(), means, create_graph=create_graph)
      if not create_graph:
        raw_density, x = raw_density.detach(), x.detach()
      # Normals point against the (pre-activation) density gradient.
      normals = -ref_utils.l2_normalize(raw_grad_density)

    def noise(x, scale):
      """x plus `scale` times unit normal noise from the generator (on the
      fused path after the kernel, as mlp.py:328-330 adds it)."""
      return x + scale * torch.randn(x.shape, generator=generator,
                                     dtype=x.dtype, device=x.device)

    if generator is not None and cfg.density_noise > 0:
      raw_density = noise(raw_density, cfg.density_noise)

    grad_pred = normals_pred = None
    normals_to_use = normals
    if cfg.enable_pred_normals:
      grad_pred = self._head('grad_pred', x)
      normals_pred = -ref_utils.l2_normalize(grad_pred)
      normals_to_use = normals_pred

    density = cfg.density_activation(raw_density + cfg.density_bias)

    roughness = None
    x_split = None
    if cfg.disable_rgb:
      rgb = torch.zeros_like(means)
    else:
      if self.use_viewdirs:
        if viewdirs is None:
          raise ValueError('this MLP was built to take view directions.')
        if cfg.use_diffuse_color:
          raw_rgb_diffuse = self._head('diffuse', x)
        if cfg.use_specular_tint:
          tint = torch.sigmoid(self._head('tint', x))
        if cfg.enable_pred_roughness:
          roughness = cfg.roughness_activation(
              self._head('roughness', x) + cfg.roughness_bias)
        parts = []
        if 'bottleneck' in self.heads:
          bottleneck = self._head('bottleneck', x)
          if generator is not None and cfg.bottleneck_noise > 0:
            bottleneck = noise(bottleneck, cfg.bottleneck_noise)
          parts.append(bottleneck)
        if cfg.use_reflections or cfg.use_n_dot_v:
          viewdirs_flat = per_sample(viewdirs)
        if cfg.use_reflections:
          # viewdirs point camera -> point; reflect() wants point -> camera.
          refdirs = ref_utils.reflect(-viewdirs_flat, normals_to_use)
          parts.append(self.dir_enc_fn(refdirs, roughness))
        else:
          # Encode per RAY (cheaper), then broadcast per sample.
          parts.append(per_sample(self.dir_enc_fn(viewdirs, roughness)))
        if cfg.use_n_dot_v:
          parts.append(torch.sum(normals_to_use * viewdirs_flat, dim=-1,
                                 keepdim=True))
        if glo_vec is not None:
          parts.append(per_sample(glo_vec))
        x = torch.cat(parts, dim=-1)
        inputs = x
        for i, layer in enumerate(self.view_branch):
          x, x_split = self._dense(layer, x, x_split, hidden=True)
          x = cfg.net_activation(x)
          if i % cfg.skip_layer_dir == 0 and i > 0:
            x = torch.cat([tensor.gather_from_model(x, x_split).to(
                inputs.dtype), inputs], dim=-1)
            x_split = None
      rgb, rgb_split = self._dense(self.heads['rgb'], x, x_split)
      rgb = cfg.rgb_activation(
          cfg.rgb_premultiplier * tensor.gather_from_model(rgb, rgb_split) +
          cfg.rgb_bias)
      if cfg.use_diffuse_color:
        # Diffuse starts near 0.25, so the combined linear color is ~0.5.
        diffuse_linear = torch.sigmoid(raw_rgb_diffuse - math.log(3.0))
        specular_linear = (tint * rgb if cfg.use_specular_tint
                           else 0.5 * rgb)
        rgb = torch.clamp(image_ops.linear_to_srgb(
            specular_linear + diffuse_linear, xnp=torch), 0, 1)
      rgb = rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding

    def unflatten(a):
      return None if a is None else a.reshape(sample_shape + a.shape[1:])

    return dict(density=unflatten(density), rgb=unflatten(rgb),
                raw_grad_density=unflatten(raw_grad_density),
                grad_pred=unflatten(grad_pred), normals=unflatten(normals),
                normals_pred=unflatten(normals_pred),
                roughness=unflatten(roughness))
