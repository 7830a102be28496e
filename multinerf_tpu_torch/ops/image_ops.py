"""Image transforms and quality metrics (port of ops/image_ops.py).

PSNR, SSIM (11×11 Gaussian window, sigma 1.5, k1 = 0.01, k2 = 0.03, VALID
padding: the settings of the JAX ``ssim``) and the quadratic color
correction of eval.  Metrics are computed on host images, as the eval and
train drivers hold them: SSIM in float32 on the CPU, where no convolution
takes TF32 or bf16 inputs (the JAX package asks for ``Precision.HIGHEST``
because reduced-precision inputs bias the ``E[x^2] - mu^2`` variance
terms).  LPIPS (``ops/lpips.py``) runs where the harness is told, on the
card in the eval entry point, when ``Config.lpips_weights_path`` names
weights.
"""

from __future__ import annotations

import math
import types
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def mse_to_psnr(mse):
  """PSNR of a torch MSE, for a maximum pixel value of 1."""
  return -10.0 / math.log(10.0) * torch.log(mse)


def psnr_to_mse(psnr):
  """The torch MSE of a PSNR, for a maximum pixel value of 1."""
  return torch.exp(-0.1 * math.log(10.0) * psnr)


def ssim_to_dssim(ssim):
  """Structural dissimilarity from SSIM."""
  return (1 - ssim) / 2


def dssim_to_ssim(dssim):
  """SSIM from structural dissimilarity."""
  return 1 - 2 * dssim


def linear_to_srgb(linear, eps: Optional[float] = None,
                   xnp: types.ModuleType = np):
  """sRGB OETF for linear in [0, 1]; `xnp` is numpy or torch."""
  if eps is None:
    eps = float(np.finfo(np.float32).eps)
  srgb0 = 323 / 25 * linear
  srgb1 = (211 * xnp.maximum(linear, xnp.full_like(linear, eps))**(5 / 12) -
           11) / 200
  return xnp.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb, eps: Optional[float] = None,
                   xnp: types.ModuleType = np):
  """Inverse sRGB OETF for srgb in [0, 1]; `xnp` is numpy or torch."""
  if eps is None:
    eps = float(np.finfo(np.float32).eps)
  linear0 = 25 / 323 * srgb
  linear1 = xnp.maximum((200 * srgb + 11) / 211,
                        xnp.full_like(srgb, eps))**(12 / 5)
  return xnp.where(srgb <= 0.04045, linear0, linear1)


def downsample(img, factor):
  """Area downsample; `factor` must divide the image height and width."""
  sh = img.shape
  if not (sh[0] % factor == 0 and sh[1] % factor == 0):
    raise ValueError(
        f'Downsampling factor {factor} does not evenly divide image '
        f'shape {sh[:2]}')
  img = img.reshape(
      (sh[0] // factor, factor, sh[1] // factor, factor) + sh[2:])
  return img.mean((1, 3))


def color_correct(img, ref, num_iters=5, eps=0.5 / 255):
  """Fit a per-channel quadratic color transform warping img toward ref
  (host numpy, as image_ops.py:72-110 of the JAX package).

  Saturated pixels are masked out of the least-squares fit; because the
  saturation set changes as the fit improves, the solve is iterated.
  """
  if img.shape[-1] != ref.shape[-1]:
    raise ValueError(
        f"img's {img.shape[-1]} and ref's {ref.shape[-1]} channels must match")
  num_channels = img.shape[-1]
  img_mat = np.asarray(img).reshape([-1, num_channels])
  ref_mat = np.asarray(ref).reshape([-1, num_channels])

  def is_unclipped(z):  # Pixels near the [0, 1] rails carry no signal.
    return (z >= eps) & (z <= 1 - eps)

  mask0 = is_unclipped(img_mat)
  for _ in range(num_iters):
    # Quadratic expansion of each pixel: upper-triangular channel products,
    # then the linear terms, then a bias.
    quads = [img_mat[:, c:c + 1] * img_mat[:, c:] for c in range(num_channels)]
    a_mat = np.concatenate(quads + [img_mat, np.ones_like(img_mat[:, :1])],
                           axis=-1)
    warp = []
    for c in range(num_channels):
      b = ref_mat[:, c]
      mask = mask0[:, c] & is_unclipped(img_mat[:, c]) & is_unclipped(b)
      w = np.linalg.lstsq(np.where(mask[:, None], a_mat, 0),
                          np.where(mask, b, 0), rcond=-1)[0]
      if not np.isfinite(w).all():
        raise FloatingPointError('color_correct: non-finite fit.')
      warp.append(w)
    img_mat = np.clip(a_mat @ np.stack(warp, axis=-1), 0, 1)
  return img_mat.reshape(img.shape)


def _gaussian_kernel1d(filter_size: int, filter_sigma: float):
  """Normalized 1D Gaussian window (float32)."""
  offsets = (torch.arange(filter_size, dtype=torch.float32) -
             (filter_size - 1) / 2)
  g = torch.exp(-0.5 * (offsets / filter_sigma)**2)
  return g / torch.sum(g)


def _filter2d(img, kernel1d):
  """Separable VALID filtering of an [H, W, C] (or [H, W]) image."""
  squeeze = img.ndim == 2
  if squeeze:
    img = img[..., None]
  c = img.shape[-1]
  chw = img.permute(2, 0, 1)[None]  # [1, C, H, W], one group per channel.
  k = kernel1d.shape[0]
  out = F.conv2d(chw, kernel1d.reshape(1, 1, k, 1).expand(c, 1, k, 1),
                 groups=c)
  out = F.conv2d(out, kernel1d.reshape(1, 1, 1, k).expand(c, 1, 1, k),
                 groups=c)
  out = out[0].permute(1, 2, 0)
  return out[..., 0] if squeeze else out


def ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
         k1=0.01, k2=0.03, return_map=False):
  """Structural similarity (Wang et al. 2004) between two images.

  Args:
    img0, img1: [H, W, C] or [H, W] images in [0, max_val] (numpy arrays
      or tensors; computed in float32 on the CPU).
    max_val: dynamic range of the inputs.
    filter_size, filter_sigma: Gaussian window parameters.
    k1, k2: stabilization constants.
    return_map: return the per-pixel SSIM map instead of its mean.

  Returns:
    A float32 tensor: the mean SSIM, or the SSIM map over the VALID region.
  """
  img0 = torch.as_tensor(np.asarray(img0, np.float32))
  img1 = torch.as_tensor(np.asarray(img1, np.float32))
  kernel = _gaussian_kernel1d(filter_size, filter_sigma)

  mu0 = _filter2d(img0, kernel)
  mu1 = _filter2d(img1, kernel)
  mu00 = mu0 * mu0
  mu11 = mu1 * mu1
  mu01 = mu0 * mu1
  sigma00 = _filter2d(img0 * img0, kernel) - mu00
  sigma11 = _filter2d(img1 * img1, kernel) - mu11
  sigma01 = _filter2d(img0 * img1, kernel) - mu01

  c1 = (k1 * max_val)**2
  c2 = (k2 * max_val)**2
  numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
  denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
  ssim_map = numer / denom
  return ssim_map if return_map else torch.mean(ssim_map)


class MetricHarness:
  """PSNR and SSIM between a predicted and a ground-truth host image, and
  LPIPS on `device` when a weight file is configured."""

  def __init__(self, lpips_weights_path=None, device='cpu'):
    from multinerf_tpu_torch.ops import lpips as lpips_lib
    self.lpips_fn = lpips_lib.try_load(lpips_weights_path, device)

  def __call__(self, rgb_pred, rgb_gt, name_fn=lambda s: s):
    mse = np.mean((np.asarray(rgb_pred) - np.asarray(rgb_gt))**2)
    # The JAX harness takes the log of the float32 MSE.
    psnr = float(mse_to_psnr(torch.tensor(mse, dtype=torch.float32)))
    out = {name_fn('psnr'): psnr,
           name_fn('ssim'): float(ssim(rgb_pred, rgb_gt))}
    if self.lpips_fn is not None:
      out[name_fn('lpips')] = self.lpips_fn(rgb_pred, rgb_gt)
    return out


def make_postprocess_fns(config, dataset):
  """(tonemap fn, color-correction fn) for a dataset's color space
  (image_ops.py:199-215): RawNeRF's raw tonemap (the dataset's
  ``metadata['postprocess_fn']``, exposure as its optional second argument)
  or the identity; the affine match of raw-space eval
  (``Config.eval_raw_affine_cc``) or ``color_correct``."""
  from multinerf_tpu_torch.data import raw  # data imports this module.
  if config.rawnerf_mode:
    postprocess_fn = dataset.metadata['postprocess_fn']
  else:
    postprocess_fn = lambda z: z
  cc_fn = (raw.match_images_affine if config.eval_raw_affine_cc
           else color_correct)
  return postprocess_fn, cc_fn
