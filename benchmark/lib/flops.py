"""The yardstick's arithmetic: published peaks of the card, model FLOPs of
a step or a frame, and the least time each hand-written kernel could take.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W limit.  Model FLOPs: every Dense [in, out] costs 2 * n * in * out
forward for its n samples, three times that for training (the backward's
dX and dW products); recomputation and Ref-NeRF's double backward get no
credit.  Kernel bounds (K1-K4 of the port): each input read once (a
sample's mean and covariance, 48 bytes, plus K1's 4-byte output), each
output written once, the weights once, the trunk's products at 2
operations a multiply-add; the larger of bytes over bandwidth and
operations over the bf16 peak.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def model_flops(shapes, model_cfg, rays, training):
  """Model FLOPs of `rays` rays: {flax name: shape} -> float."""
  levels = model_cfg['num_levels']
  prop_n = rays * model_cfg['num_prop_samples'] * (levels - 1)
  nerf_n = rays * model_cfg['num_nerf_samples']
  if model_cfg.get('single_mlp'):
    nerf_n, prop_n = nerf_n + prop_n, 0
  total = 0.0
  for name, shape in shapes.items():
    if len(shape) != 2:
      continue
    n = prop_n if name.startswith('PropMLP') else nerf_n
    total += 2.0 * n * shape[0] * shape[1]
  return 3.0 * total if training else total


def _bound_s(nbytes, ops):
  return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def kernel_bound_s(kernel, n, feats, width, depth=None):
  """Least seconds of one launch over `n` samples.  K1 (density_mlp) and K3
  (its backward) take the whole density trunk: `feats` features, `depth`
  layers of `width`.  K2 (featurize_dense) and K4 (its dW) take one
  featurize -> Dense of `feats` rows and `width` columns."""
  if kernel in ('K1', 'K3'):
    trunk = feats * width + (depth - 1) * width * width
    if kernel == 'K1':
      return _bound_s(52 * n + 2 * (trunk + width), 2 * n * (trunk + width))
    return _bound_s(52 * n + 4 * (trunk + (depth + 1) * width + 1),
                    2 * n * (2 * trunk + (depth - 1) * width * width + width))
  if kernel == 'K2':
    return _bound_s(48 * n + 4 * n * width + 2 * feats * width + 4 * width,
                    2 * n * feats * width)
  if kernel == 'K4':
    return _bound_s(48 * n + 4 * n * width + 4 * feats * width,
                    2 * n * feats * width)
  raise ValueError(kernel)
