"""The exact three-way bf16 split of an f32 weight (``models/mlp.py``:
``split_bf16``, ``_SplitProduct``), which the heads and the skip layer's
activation rows take for a bf16 activation, on the CPU.

The split is exact: hi + mid + lo == w in float64.  The forward is the f32
product of the promoted activation up to the order of its sums, so it is
held per output to 1e-6 of that output's sum of |x * w| (f32 sums over
K = 1,024 terms stay near 1e-7 of it).  The backward is the promoted
product's own, so dx and dW are held bit for bit.  Engagement is held by
``split_counts``: 4 a NerfMLP forward under a bf16 trunk at 360.gin's widths
(skip layer, density, bottleneck, rgb), 0 under an f32 trunk.  On the CPU
the Function's forward is its plain version, the promoted product itself,
so a model's outputs are the promoted products' bit for bit; the split's
own layouts are held here through ``_split_mm`` and on the card in
tests/test_torch_cuda.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

# configs registers the gin externals (coord.contract) that 360.gin names.
from multinerf_tpu_torch import configs  # noqa: F401
from multinerf_tpu_torch import ginlite
from multinerf_tpu_torch.models import mlp as mlp_lib

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

# (in, out) of the 360 NerfMLP's products: the skip layer's kernel (1,024
# activation rows over 504 feature rows), its activation rows, the
# bottleneck, the density head and the rgb head.
SKIP_KERNEL = (1528, 1024)
SHAPES = [(1024, 1024), (1024, 256), (1024, 1), (128, 3)]


def _he_uniform(shape, seed):
  gen = torch.Generator().manual_seed(seed)
  lim = np.sqrt(6.0 / shape[0])
  return (torch.rand(shape, generator=gen) * 2 - 1) * lim


def _activation(rows, k, seed):
  gen = torch.Generator().manual_seed(seed)
  return torch.relu(torch.randn(rows, k, generator=gen)).to(torch.bfloat16)


def _pieces_sum(w):
  return sum(p.double() for p in mlp_lib.split_bf16(w))


@pytest.mark.parametrize('shape', [SKIP_KERNEL, (1024, 256), (1024, 1)])
def test_split_is_exact_on_he_uniform_weights(shape):
  w = _he_uniform(shape, seed=shape[1])
  assert all(p.dtype == torch.bfloat16 for p in mlp_lib.split_bf16(w))
  assert torch.equal(_pieces_sum(w), w.double())


@pytest.mark.parametrize('value', [0.0, 1e-30, -1e-30, 3e38, -3e38])
def test_split_is_exact_at_the_edges_of_the_range(value):
  w = torch.full((4, 2), value, dtype=torch.float32)
  w[0, 0] = 1.0 / 3.0  # A value with all 24 bits of its significand set.
  assert torch.equal(_pieces_sum(w), w.double())


def _mm_promoted(a, b, acc=None):
  """_mm_f32 of the card on the CPU: the bf16 operands' product promoted
  to f32 (where bf16 products are exact), added into `acc` if given."""
  y = a.float() @ b.float()
  return y if acc is None else acc.add_(y)


@pytest.mark.parametrize('shape', SHAPES)
def test_forward_is_the_promoted_product(shape, monkeypatch):
  # _split_mm's layouts (wide: three products into one f32 sum; narrow:
  # one block-diagonal product and its partial sums) run here on products
  # promoted to f32, where bf16 products are exact, as on the card.
  monkeypatch.setattr(mlp_lib, '_mm_f32', _mm_promoted)
  k, m = shape
  x = _activation(512, k, seed=1)
  w = _he_uniform(shape, seed=2)
  got = mlp_lib._split_mm(x, w)
  want = x.float() @ w
  scale = x.double().abs() @ w.double().abs()
  assert got.dtype == torch.float32 and got.shape == (512, m)
  err = float(((got.double() - want.double()).abs() / scale).max())
  assert err <= 1e-6, err
  # The Function's plain version (the CPU's) is the promoted product.
  assert torch.equal(mlp_lib._SplitProduct.apply(x, w), want)


@pytest.mark.parametrize('layout,products', [
    ('one_device', 1), ('gathered', 1), ('model_split', 0)])
def test_engagement_by_layout(layout, products):
  # A layer whole on this rank takes the split: on one device, or gathered
  # by Dense.full() (the int8 model's layers under tensor parallelism).  A
  # layer split over the model group keeps its own products.
  x = _activation(16, 128, seed=9)
  w = _he_uniform((128, 3), seed=10)
  b = torch.zeros(3)
  mlp_lib.reset_split_counts()
  if layout == 'gathered':
    y = mlp_lib._Whole(w, b)(x)
  else:
    split = None if layout == 'one_device' else object()
    y = mlp_lib._f32_product(x, w, split) + b
  assert mlp_lib.split_counts['forward'] == products
  assert torch.equal(y, x.float() @ w + b)


def _grads(product, x, w, g, create_graph=False):
  x = x.detach().requires_grad_(True)
  w_leaf = w.detach().requires_grad_(True)
  # The skip layer multiplies a row slice of its kernel.
  rows = w_leaf[:x.shape[-1]]
  y = product(x, rows)
  return torch.autograd.grad(y, (x, w_leaf), g, create_graph=create_graph), (
      x, w_leaf)


def _promoted(x, w):
  return x.to(torch.float32) @ w


@pytest.mark.parametrize('shape', SHAPES + [SKIP_KERNEL])
def test_backward_is_the_promoted_products_bit_for_bit(shape):
  x = _activation(384, 1024 if shape == SKIP_KERNEL else shape[0], seed=3)
  w = _he_uniform(shape, seed=4)
  g = torch.randn(384, shape[1], generator=torch.Generator().manual_seed(5))
  (dx, dw), _ = _grads(mlp_lib._SplitProduct.apply, x, w, g)
  (want_dx, want_dw), _ = _grads(_promoted, x, w, g)
  assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
  assert torch.equal(dx, want_dx)
  assert torch.equal(dw, want_dw)


def test_backward_is_differentiable_again():
  # Density normals under an int8 trunk differentiate the heads' backward
  # (a create_graph pass): its products are recorded like any other.
  x = _activation(64, 128, seed=6)
  w = _he_uniform((128, 3), seed=7)
  g = torch.randn(64, 3, generator=torch.Generator().manual_seed(8))
  out = []
  for product in (mlp_lib._SplitProduct.apply, _promoted):
    (dx, dw), (x_leaf, w_leaf) = _grads(product, x, w, g, create_graph=True)
    out.append(torch.autograd.grad((dx.float() ** 2).sum() + dw.sum(),
                                   (x_leaf, w_leaf)))
  for got, want in zip(*out):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _nerf_mlp(gin_file, bindings):
  ginlite.clear_config()
  ginlite.parse_config_files_and_bindings([gin_file], list(bindings))
  return mlp_lib.MLP(ginlite.make('NerfMLP'),
                     generator=torch.Generator().manual_seed(0),
                     device='cpu')


def _forward(model, n_rays=8, n_samples=4):
  means, covs = tp.gaussians(n_rays * n_samples, seed=1, far_frac=0.1)
  viewdirs = tp.rays(n_rays, seed=2)['viewdirs']
  shape = (n_rays, n_samples)
  with torch.no_grad():
    return model(torch.as_tensor(means).reshape(*shape, 3),
                 torch.as_tensor(covs).reshape(*shape, 3, 3),
                 torch.as_tensor(viewdirs))


REFNERF = os.path.join(tp.REPO, 'configs', 'blender_refnerf.gin')


@pytest.mark.parametrize('gin_file,bindings,products', [
    (tp.CONFIG_360, ("NerfMLP.trunk_dtype = 'bfloat16'",), 4),
    (tp.CONFIG_360, (), 0),
    (REFNERF, (), 0),
])
def test_engagement_by_dtype(gin_file, bindings, products, monkeypatch):
  model = _nerf_mlp(gin_file, bindings)
  mlp_lib.reset_split_counts()
  got = _forward(model)
  assert mlp_lib.split_counts['forward'] == products
  # The same forward with every such product promoted (the code path
  # before the split).
  monkeypatch.setattr(
      mlp_lib, '_f32_product',
      lambda x, kernel, split: x.to(kernel.dtype) @ kernel)
  want = _forward(model)
  assert mlp_lib.split_counts['forward'] == products
  # On the CPU the split products run their plain version, the promoted
  # product, so the outputs are bit for bit the same either way.
  for key, value in want.items():
    if value is None:
      assert got[key] is None, key
    else:
      assert torch.equal(got[key], value), key
