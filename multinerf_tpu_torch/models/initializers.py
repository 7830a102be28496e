"""Dense-kernel initializers named as in ``jax.nn.initializers``.

Each factory returns ``init(shape, generator) -> f32 tensor`` for a kernel
of shape [fan_in, fan_out], drawn on the CPU from an explicit
``torch.Generator``, so one seed gives the same weights on every device.
The distributions are JAX's; the bits are not (the generators differ).
"""

from __future__ import annotations

import math

import torch

# Std of a unit normal truncated to [-2, 2] (jax.nn.initializers).
_TRUNC_STD = 0.87962566103423978


def variance_scaling(scale, mode, distribution):
  def init(shape, generator):
    fan_in, fan_out = shape[-2], shape[-1]
    fan = {'fan_in': fan_in, 'fan_out': fan_out,
           'fan_avg': (fan_in + fan_out) / 2}[mode]
    variance = scale / fan
    out = torch.empty(shape, dtype=torch.float32)
    if distribution == 'uniform':
      lim = math.sqrt(3 * variance)
      return out.uniform_(-lim, lim, generator=generator)
    std = math.sqrt(variance) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                                       generator=generator)
  return init


def he_uniform():
  return variance_scaling(2.0, 'fan_in', 'uniform')


def he_normal():
  return variance_scaling(2.0, 'fan_in', 'truncated_normal')


def glorot_uniform():
  return variance_scaling(1.0, 'fan_avg', 'uniform')


def glorot_normal():
  return variance_scaling(1.0, 'fan_avg', 'truncated_normal')
