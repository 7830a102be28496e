"""Fused featurize -> Dense: CUDA kernel wrappers, plain versions, autograd.

Forward (K2) replaces ``multinerf_tpu/ops/pallas/featurize_dense.py:
_fwd_kernel``: ``bf16(IPE(contract(means, covs))) @ bf16(W) + bias`` with
f32 accumulation, the features never stored in device memory.  At the 360
config (131,072 samples per 4,096-ray batch, W = 1,024) it is 137 GFLOP of
bf16 products against 0.54 GB of f32 output, two bounds that are close (0.14
and 0.16 ms).  The design notes (a persistent wgmma tile pass fed by a TMA
weight ring, the output stored by TMA from shared memory) are in
``csrc/featurize_dense.cu``; the launch plan in ``plans.py``.

Backward (K4) replaces ``_dw_kernel``: ``dW = bf16(feats)^T @ bf16(g)``
with f32 accumulation, the features computed once per sample per call;
``db = g.sum(0)`` in f32 (featurize_dense.py:249-254).  The design notes (a
featurize stage, then the split-K TMA + wgmma GEMM of ``csrc/wgmma_dw.cuh``
and an ordered reduce, deterministic) are in ``csrc/featurize_dense_dw.cu``;
the launch plan in ``plans.py``.
The sample positions get no gradient: means and covs are stop-gradient
inputs, as in the JAX custom VJP.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version, in both directions, so that the CPU path
has the same stop-gradient semantics: ``featurize_dense_plain`` (the port
of ``featurize_dense_reference``) and ``featurize_dense_dw_plain`` (the
port of ``_dw_kernel``), with the same bf16 roundings.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.ops.kernels import build
from multinerf_tpu_torch.ops.kernels import plans

# launches: kernel launches; plain_calls: calls served by the plain version.
counts = {'launches': 0, 'plain_calls': 0}  # Forward (K2).
bwd_counts = {'launches': 0, 'plain_calls': 0}  # dW (K4).

_BASIS_CACHE = {}


def reset_counts():
  for c in (counts, bwd_counts):
    for k in c:
      c[k] = 0


def device_basis(basis, min_deg, device):
  """(basis_t [L, 3], bb_t [L, 9]) f32 on `device`, uploaded once."""
  basis = np.asarray(basis, np.float32)
  key = (basis.tobytes(), basis.shape, int(min_deg), str(device))
  if key not in _BASIS_CACHE:
    basis_t, bb_t = coord.lifted_basis(basis, min_deg)
    _BASIS_CACHE[key] = (torch.as_tensor(basis_t, device=device),
                         torch.as_tensor(bb_t, device=device))
  return _BASIS_CACHE[key]


def padded_bf16_rows(kernel, rows, cols=None):
  """kernel [F, W] -> bf16 [rows, cols or W], zero rows (K padding) and
  columns appended."""
  w = kernel.to(torch.bfloat16)
  pad_cols = 0 if cols is None else cols - w.shape[1]
  return F.pad(w, (0, pad_cols, 0, rows - w.shape[0])).contiguous()


def check_gaussians(means, covs):
  """Shared input checks of the fused kernels: [N, 3] and [N, 9] f32."""
  if means.dtype != torch.float32 or covs.dtype != torch.float32:
    raise TypeError(f'means/covs must be float32, got {means.dtype}, '
                    f'{covs.dtype}.')
  if means.shape[-1] != 3 or covs.shape[-1] != 9 or (
      means.shape[0] != covs.shape[0]):
    raise ValueError(f'bad shapes: means {tuple(means.shape)}, '
                     f'covs {tuple(covs.shape)}.')
  if not (means.is_contiguous() and covs.is_contiguous()):
    raise ValueError('means/covs must be contiguous.')
  if means.shape[0] >= 2**31:
    raise ValueError('too many samples for one launch.')


def plain_features(means, covs, basis, min_deg, max_deg, use_contract):
  """bf16 IPE features [..., F] of (contracted) Gaussians, as in the kernels."""
  if use_contract:
    means, covs = coord.contract_gaussian(means, covs)
  return coord.integrated_pos_enc_lifted_recurrence(
      means, covs, basis, min_deg, max_deg).to(torch.bfloat16)


def featurize_dense_plain(means, covs, kernel, bias, basis, min_deg=0,
                          max_deg=12, use_contract=True):
  """Plain PyTorch version of K2: [..., 3], [..., 3, 3] -> [..., W] f32."""
  feats = plain_features(means, covs, basis, min_deg, max_deg, use_contract)
  # bf16 x bf16 products are exact in f32, so an f32 product of the
  # bf16-rounded operands is the bf16-in / f32-accumulate dot.
  return feats.float() @ kernel.to(torch.bfloat16).float() + bias


def featurize_dense_dw_plain(means, covs, g, basis, min_deg=0, max_deg=12,
                             use_contract=True):
  """Plain PyTorch version of K4 (line for line ``_dw_kernel``):
  [N, 3], [N, 3, 3], g [N, W] -> dW [F, W] f32 = bf16(feats)^T @ bf16(g)."""
  feats = plain_features(means, covs, basis, min_deg, max_deg, use_contract)
  return feats.float().T @ g.to(torch.bfloat16).float()


def check_dense(means, width, basis, min_deg, max_deg, kernel_rows=None):
  """(basis_t, bb_t, num_dims, num_degs) after the shape checks."""
  basis_t, bb_t = device_basis(basis, min_deg, means.device)
  num_dims = basis_t.shape[0]
  num_degs = max_deg - min_deg
  if kernel_rows is not None and kernel_rows != 2 * num_degs * num_dims:
    raise ValueError(f'kernel has {kernel_rows} rows, expected '
                     f'{2 * num_degs * num_dims} features.')
  if width % 32 != 0:
    raise ValueError(f'width {width} must be a multiple of 32.')
  return basis_t, bb_t, num_dims, num_degs


def _launch(means, covs, kernel, bias, basis, min_deg, max_deg,
            use_contract):
  check_gaussians(means, covs)
  num_feats, width = kernel.shape
  basis_t, bb_t, num_dims, num_degs = check_dense(
      means, width, basis, min_deg, max_deg, kernel_rows=num_feats)
  if bias.shape != (width,) or bias.dtype != torch.float32:
    raise ValueError(f'bias must be float32 [{width}].')
  for t in (covs, kernel, bias):
    if t.device != means.device:
      raise ValueError('all inputs must be on one device.')
  n = means.shape[0]
  out = torch.empty((n, width), dtype=torch.float32, device=means.device)
  if n == 0:
    return out
  plan = fwd_plan(plans.featurize_dense_fwd_plan, 'featurize_dense',
                  num_feats, width, num_dims, n)
  w_bf = padded_bf16_rows(kernel, plan.kpad, plan.padded_cols)
  bias = bias.contiguous()
  lib = build.load('featurize_dense')
  fn = lib.featurize_dense_forward
  fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), w_bf.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), n, width, num_dims, num_degs,
                 int(use_contract), plan.width, plan.grid, plan.stages,
                 int(plan.staged),
                 torch.cuda.current_stream(means.device).cuda_stream),
              'featurize_dense')
  return out


def _launch_dw(means, covs, g, basis, min_deg, max_deg, use_contract):
  check_gaussians(means, covs)
  if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != means.shape[0]:
    raise ValueError(f'g must be float32 [{means.shape[0]}, W], got '
                     f'{g.dtype} {tuple(g.shape)}.')
  if g.device != means.device or covs.device != means.device:
    raise ValueError('all inputs must be on one device.')
  g = g.contiguous()
  n, width = g.shape
  basis_t, bb_t, num_dims, num_degs = check_dense(
      means, width, basis, min_deg, max_deg)
  num_feats = 2 * num_degs * num_dims
  device = means.device
  if n == 0:
    return torch.zeros((num_feats, width), device=device)
  plan = plans.featurize_dense_dw_plan(num_feats, width, num_dims, n,
                                       num_sms(device))
  gemm = plan.gemm
  empty = lambda shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  feats = empty((n, plan.kpad), torch.bfloat16)
  g16 = empty((n, width), torch.bfloat16)
  part = empty((gemm.splits, plan.kpad, width))
  out = empty((num_feats, width))
  lib = build.load('featurize_dense_dw')
  fn = lib.featurize_dense_dw
  fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  bwd_counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), g.data_ptr(), feats.data_ptr(),
                 g16.data_ptr(), part.data_ptr(), out.data_ptr(), n, width,
                 num_dims, num_degs, int(use_contract), gemm.bn, gemm.splits,
                 gemm.per, torch.cuda.current_stream(device).cuda_stream),
              'featurize_dense_dw')
  return out


def num_sms(device):
  return torch.cuda.get_device_properties(device).multi_processor_count


_MAX_CLUSTERS = {}


def max_clusters(name, width, smem):
  """The most clusters of csrc/<name>.cu's width-`width` forward kernel
  with `smem` bytes per CTA that the card holds at once."""
  key = (name, width, smem)
  if key not in _MAX_CLUSTERS:
    fn = getattr(build.load(name), f'{name}_max_clusters')
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    count = fn(width, smem)
    if count < 1:
      raise RuntimeError(f'{name}: the card holds no cluster of the kernel '
                         f'(CUDA error {-count}).')
    _MAX_CLUSTERS[key] = count
  return _MAX_CLUSTERS[key]


def fwd_plan(plan_fn, name, *args):
  """plan_fn's launch plan (K1's or K2's) with as many clusters as the
  card holds at once."""
  layout = plan_fn(*args, 1)
  return plan_fn(*args, max_clusters(name, layout.width, layout.smem))


def check_device(t):
  if t.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'unsupported device {t.device}.')


def featurize_dense_forward(means, covs, kernel, bias, basis, min_deg,
                            max_deg, use_contract):
  """K2 on a CUDA tensor, its plain version on a CPU one: [N, 3],
  [N, 3, 3] -> [N, W].  No autograd."""
  check_device(means)
  if means.device.type == 'cpu':
    counts['plain_calls'] += 1
    return featurize_dense_plain(means, covs, kernel, bias, basis, min_deg,
                                 max_deg, use_contract)
  return _launch(means, covs.reshape(-1, 9), kernel, bias, basis,
                 int(min_deg), int(max_deg), bool(use_contract))


def featurize_dense_dw(means, covs, g, basis, min_deg=0, max_deg=12,
                       use_contract=True):
  """K4 on a CUDA tensor, its plain version on a CPU one: [N, 3],
  [N, 3, 3], g [N, W] -> dW [F, W] f32."""
  check_device(means)
  if means.device.type == 'cpu':
    bwd_counts['plain_calls'] += 1
    return featurize_dense_dw_plain(means, covs, g, basis, min_deg, max_deg,
                                    use_contract)
  return _launch_dw(means, covs.reshape(-1, 9), g, basis, int(min_deg),
                    int(max_deg), bool(use_contract))


class _FeaturizeDense(torch.autograd.Function):
  """K2 forward, K4 + ``g.sum(0)`` backward; no gradient to the samples."""

  @staticmethod
  def forward(ctx, means, covs, kernel, bias, static):
    ctx.save_for_backward(means, covs)
    ctx.static = static
    return featurize_dense_forward(means, covs, kernel, bias, *static)

  @staticmethod
  def backward(ctx, g):
    means, covs = ctx.saved_tensors
    dw = db = None
    if ctx.needs_input_grad[2]:
      dw = featurize_dense_dw(means, covs, g, *ctx.static)
    if ctx.needs_input_grad[3]:
      db = g.sum(0)
    return None, None, dw, db, None


def featurize_dense(means, covs, kernel, bias, basis, min_deg=0, max_deg=12,
                    use_contract=True):
  """Fused featurize + Dense: [..., 3], [..., 3, 3] -> [..., W] f32.

  Equivalent (to bf16 matmul rounding) to contract -> IPE -> feats @ kernel
  + bias.  Gradients flow to (kernel, bias) only, through K4.
  """
  check_device(means)
  batch_shape = means.shape[:-1]
  static = (basis, int(min_deg), int(max_deg), bool(use_contract))
  out = _FeaturizeDense.apply(means.reshape(-1, 3), covs.reshape(-1, 3, 3),
                              kernel, bias, static)
  return out.reshape(batch_shape + (kernel.shape[-1],))
