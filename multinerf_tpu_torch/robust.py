"""RobustNeRF's inlier / outlier mask over patches of residuals (port of
robust.py, arxiv.org/abs/2302.00833).

A pixel is an inlier when its error is below the running loss threshold,
or when enough of its 3x3 neighbours are; a patch's inner square is kept
whole when enough of the patch's pixels are inliers.  The stats carry this
batch's inlier quantile of the errors, ``loss_threshold``, which the
training loop feeds back as the next step's threshold.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from multinerf_tpu_torch.parallel import mesh

_EPS = 1e-3


def _inner_patch_mask(inner, outer, dtype=torch.float32, device=None):
  """[1, outer, outer, 1] mask that is 1 on the centered inner square."""
  lo = (outer - inner) // 2
  hi = outer - (inner + lo)
  return F.pad(torch.ones((1, inner, inner, 1), dtype=dtype, device=device),
               (0, 0, lo, hi, lo, hi))


def robustnerf_mask(errors: torch.Tensor, loss_threshold, config
                    ) -> Tuple[torch.Tensor, Mapping[str, torch.Tensor]]:
  """The RobustNeRF inlier mask of a batch of error patches.

  Args:
    errors: f32[n, h, w, c] per-subpixel squared errors.
    loss_threshold: scalar (a float or a 0-d tensor on the errors' device);
      pixels with an error below it count as inliers.
    config: Config with the robustnerf_* settings.

  Returns:
    (mask [n, h, w, 1], stats): the stats hold 'loss_threshold', this
    batch's inlier quantile of the per-pixel errors (the next step's
    threshold; across ranks, of the global batch's errors), and the inlier
    shares 'is_inlier_loss', 'has_inlier_neighbors', 'is_inlier_patch' and
    'mask' of these patches, all 0-d tensors with no gradient.  The mask
    depends only on `loss_threshold` and each patch, so each rank makes
    its own.
  """
  dtype = errors.dtype
  error_per_pixel = torch.mean(errors, dim=-1, keepdim=True)  # [n, h, w, 1]
  epp = error_per_pixel.detach()
  stats = {
      'loss_threshold': torch.quantile(
          mesh.all_gather_rows(epp.flatten(), mesh.data_group()),
          config.robustnerf_inlier_quantile),
  }
  mask = torch.ones_like(epp)

  if config.enable_robustnerf_loss:
    if config.robustnerf_inner_patch_size > config.patch_size:
      raise ValueError(
          'patch_size must be >= robustnerf_inner_patch_size.')

    is_inlier_pixel = (epp < loss_threshold).to(dtype)
    stats['is_inlier_loss'] = torch.mean(is_inlier_pixel)

    # Neighborhood vote: an f x f box filter ('SAME', zero padded), then
    # at least the smoothed inlier quantile of the neighbours.
    f = config.robustnerf_smoothed_filter_size
    window = torch.ones((1, 1, f, f), dtype=dtype,
                        device=errors.device) / (f * f)
    neighbors = F.conv2d(is_inlier_pixel.permute(0, 3, 1, 2), window,
                         padding='same').permute(0, 2, 3, 1)
    has_inlier_neighbors = (
        neighbors > 1 - config.robustnerf_smoothed_inlier_quantile).to(dtype)
    stats['has_inlier_neighbors'] = torch.mean(has_inlier_neighbors)
    is_inlier_pixel = (has_inlier_neighbors + is_inlier_pixel > _EPS).to(
        dtype)

    # Patch vote: the inner patch goes in or out as a whole.
    inner_mask = _inner_patch_mask(config.robustnerf_inner_patch_size,
                                   config.patch_size, dtype, errors.device)
    is_inlier_patch = torch.mean(is_inlier_pixel, dim=(1, 2), keepdim=True)
    is_inlier_patch = (
        is_inlier_patch > 1 - config.robustnerf_inner_patch_inlier_quantile
    ).to(dtype) * inner_mask
    stats['is_inlier_patch'] = torch.mean(is_inlier_patch)

    # An inlier by either vote.
    mask = (is_inlier_patch + is_inlier_pixel > _EPS).to(dtype)

  stats['mask'] = torch.mean(mask)
  return mask, stats
