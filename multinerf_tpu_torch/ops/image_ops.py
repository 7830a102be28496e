"""Image transforms and metrics (port of parts of ops/image_ops.py)."""

from __future__ import annotations

import math
import types
from typing import Optional

import numpy as np
import torch


def mse_to_psnr(mse):
  """PSNR of a torch MSE, for a maximum pixel value of 1."""
  return -10.0 / math.log(10.0) * torch.log(mse)


def linear_to_srgb(linear, eps: Optional[float] = None,
                   xnp: types.ModuleType = np):
  """sRGB OETF for linear in [0, 1]; `xnp` is numpy or torch."""
  if eps is None:
    eps = float(np.finfo(np.float32).eps)
  srgb0 = 323 / 25 * linear
  srgb1 = (211 * xnp.maximum(linear, xnp.full_like(linear, eps))**(5 / 12) -
           11) / 200
  return xnp.where(linear <= 0.0031308, srgb0, srgb1)


def make_postprocess_fns(config, dataset):
  """(tonemap fn, color-correction fn) for a dataset's color space.

  Only the tonemap of the render path is ported: the identity.
  """
  del dataset
  if config.rawnerf_mode:
    raise NotImplementedError(
        'Not ported yet: the RawNeRF tonemap (ROADMAP.md Queue 1: the rest '
        'of the model zoo).')
  return (lambda z: z), None
