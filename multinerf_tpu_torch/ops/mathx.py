"""Numerically-safe math primitives (torch port of ``multinerf_tpu.ops.mathx``).

The trig range reduction is a floor modulo (``torch.remainder``, the sign of
the divisor), exactly what ``jnp.remainder`` computes; ``torch.fmod`` would
truncate and give a different argument for negative inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Fold trig arguments into [-100pi, 100pi) first (mathx.py:24).
TRIG_PERIOD = 100.0 * math.pi

# exp(89.) overflows f32.
_EXP_CLAMP = 88.0


_CONSTANTS = {}


def constant(array, device, dtype=torch.float32):
  """A host constant (a table, a basis) as a tensor on `device`, copied
  there once per process: a copy from pageable host memory waits for the
  device's queue to drain, so the per-call paths take their tables from
  here.  Do not write to the tensor returned."""
  host = np.ascontiguousarray(array, dtype=torch.empty((), dtype=dtype)
                              .numpy().dtype)
  key = (host.tobytes(), host.shape, str(dtype), str(torch.device(device)))
  if key not in _CONSTANTS:
    # A normal tensor even when first asked for under inference_mode, so
    # that autograd may save it later.
    with torch.inference_mode(False):
      _CONSTANTS[key] = torch.from_numpy(host.copy()).to(device)
  return _CONSTANTS[key]


class _MatmulHP(torch.autograd.Function):
  """a @ b with TF32 off on the CUDA backend, forward and backward."""

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a, b)
    return _f32_product(a, b)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    # Through matmul_hp again, so a second derivative is also full f32.
    grad_a = grad_b = None
    if ctx.needs_input_grad[0]:
      grad_a = matmul_hp(g, b.transpose(-1, -2)).sum_to_size(a.shape)
    if ctx.needs_input_grad[1]:
      grad_b = matmul_hp(a.transpose(-1, -2), g).sum_to_size(b.shape)
    return grad_a, grad_b


def _f32_product(a, b):
  flags = torch.backends.cuda.matmul
  allow_tf32 = flags.allow_tf32
  flags.allow_tf32 = False
  try:
    return a @ b
  finally:
    flags.allow_tf32 = allow_tf32


def matmul_hp(a, b):
  """f32 product at full precision whatever the backend's TF32 setting
  (mathx.py:29's ``Precision.HIGHEST``), in its gradients too.  `a` is
  [..., K] and `b` [K, N], or both batched, [..., M, K] and [..., K, N],
  their batch axes broadcast."""
  if a.dim() > 2 and b.dim() == 2:
    out = matmul_hp(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(a.shape[:-1] + out.shape[-1:])
  return _MatmulHP.apply(a, b)


def _reduce(x):
  return torch.where(torch.abs(x) < TRIG_PERIOD, x,
                     torch.remainder(x, TRIG_PERIOD))


def safe_sin(x):
  """sin(x) that stays finite and accurate for arbitrarily large x."""
  return torch.sin(_reduce(x))


def safe_cos(x):
  """cos(x) that stays finite and accurate for arbitrarily large x."""
  return torch.cos(_reduce(x))


class _SafeExp(torch.autograd.Function):
  """exp(min(x, 88)) whose gradient is exp(min(x, 88)), not 0, past the
  clamp (the custom JVP of mathx.py:45-57)."""

  @staticmethod
  def forward(ctx, x):
    y = torch.exp(torch.clamp(x, max=_EXP_CLAMP))
    ctx.save_for_backward(y)
    return y

  @staticmethod
  def backward(ctx, g):
    y, = ctx.saved_tensors
    return g * y


def safe_exp(x):
  """exp(x) with finite output and a nonzero gradient for large x."""
  return _SafeExp.apply(x)


def log_lerp(t, v0, v1):
  """Interpolate log-linearly from v0 (t=0) to v1 (t=1); t clipped to [0,1]."""
  if v0 <= 0 or v1 <= 0:
    raise ValueError(f'Interpolants {v0} and {v1} must be positive.')
  lv0, lv1 = np.log(v0), np.log(v1)
  return np.exp(np.clip(t, 0, 1) * (lv1 - lv0) + lv0)


def learning_rate_decay(step, lr_init, lr_final, max_steps, lr_delay_steps=0,
                        lr_delay_mult=1):
  """Log-linear decay from lr_init (step 0) to lr_final (max_steps), with
  an optional sine-eased warm-up scaled by lr_delay_mult at step 0 and
  reaching 1 at lr_delay_steps (mathx.py:68-81).  Numbers or numpy arrays."""
  if lr_delay_steps > 0:
    delay = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
        0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
  else:
    delay = 1.0
  return delay * log_lerp(step / max_steps, lr_init, lr_final)


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
