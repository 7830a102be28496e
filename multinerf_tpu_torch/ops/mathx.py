"""Numerically-safe math primitives (torch port of ``multinerf_tpu.ops.mathx``).

The trig range reduction is a floor modulo (``torch.remainder``, the sign of
the divisor), exactly what ``jnp.remainder`` computes; ``torch.fmod`` would
truncate and give a different argument for negative inputs.
"""

from __future__ import annotations

import math

import torch

# Fold trig arguments into [-100pi, 100pi) first (mathx.py:24).
TRIG_PERIOD = 100.0 * math.pi

# exp(89.) overflows f32.
_EXP_CLAMP = 88.0


def _reduce(x):
  return torch.where(torch.abs(x) < TRIG_PERIOD, x,
                     torch.remainder(x, TRIG_PERIOD))


def safe_sin(x):
  """sin(x) that stays finite and accurate for arbitrarily large x."""
  return torch.sin(_reduce(x))


def safe_cos(x):
  """cos(x) that stays finite and accurate for arbitrarily large x."""
  return torch.cos(_reduce(x))


def safe_exp(x):
  """exp(x) with finite output (forward only; the straight-through
  gradient of the JAX version comes with the training port)."""
  return torch.exp(torch.clamp(x, max=_EXP_CLAMP))


def interp_gather(x, xp, fp):
  """Batched ``jnp.interp`` by binary search + gather (GPU-friendly form).

  Follows ``jnp.interp`` step for step: the right-most fencepost <= x
  brackets from below, zero-width brackets return the lower value, and
  queries outside [xp[0], xp[-1]] clamp to the end values.
  """
  n = xp.shape[-1]
  hi = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
  hi = hi.clamp(1, n - 1)
  lo = hi - 1
  xp0, xp1 = torch.gather(xp, -1, lo), torch.gather(xp, -1, hi)
  fp0, fp1 = torch.gather(fp, -1, lo), torch.gather(fp, -1, hi)
  dx = xp1 - xp0
  flat = torch.abs(dx) <= torch.finfo(xp.dtype).eps**2  # np.spacing(eps).
  out = torch.where(
      flat, fp0, fp0 + (x - xp0) / torch.where(flat, 1.0, dx) * (fp1 - fp0))
  out = torch.where(x < xp[..., :1], fp[..., :1], out)
  return torch.where(x > xp[..., -1:], fp[..., -1:], out)


def interp_sorted(x, xp, fp):
  """Batched linear interpolation where `x`, `xp`, `fp` are all sorted.

  The masked-reduction form of mathx.py:90-117, kept literally so that ties
  (flat CDF runs, repeated fenceposts) resolve exactly as in the JAX
  package: the last fencepost <= x brackets from below, the first one > x
  from above, and out-of-range queries clamp to the end values.
  """
  ge = x[..., None, :] >= xp[..., :, None]  # [..., num_fence, num_query]

  def bracket(vals):
    lo = torch.where(ge, vals[..., None], vals[..., :1, None]).amax(dim=-2)
    hi = torch.where(ge, vals[..., -1:, None], vals[..., None]).amin(dim=-2)
    return lo, hi

  fp0, fp1 = bracket(fp)
  xp0, xp1 = bracket(xp)
  frac = torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0).clamp(0, 1)
  return fp0 + frac * (fp1 - fp0)
