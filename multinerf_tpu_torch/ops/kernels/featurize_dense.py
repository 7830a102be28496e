"""Fused featurize -> Dense forward: CUDA kernel wrapper and plain version.

Replaces ``multinerf_tpu/ops/pallas/featurize_dense.py:_fwd_kernel``:
``bf16(IPE(contract(means, covs))) @ bf16(W) + bias`` with f32 accumulation,
the features never stored in device memory.  At the 360 config (131,072
samples per 4,096-ray chunk, W = 1,024) it is 137 GFLOP of bf16 products
against 0.5 GB of f32 output, so the tensor cores bound it; the design notes
are in ``csrc/featurize_dense.cu``.

Forward only: rendering needs no gradient.  The dW kernel and the
``torch.autograd.Function`` around both come with the training port.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs ``featurize_dense_plain``, the line-for-line port of
``featurize_dense_reference`` with the same bf16 roundings.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.ops.kernels import build

# launches: kernel launches; plain_calls: calls served by the plain version.
counts = {'launches': 0, 'plain_calls': 0}

_BASIS_CACHE = {}


def reset_counts():
  for k in counts:
    counts[k] = 0


def device_basis(basis, min_deg, device):
  """(basis_t [L, 3], bb_t [L, 9]) f32 on `device`, uploaded once."""
  basis = np.asarray(basis, np.float32)
  key = (basis.tobytes(), basis.shape, int(min_deg), str(device))
  if key not in _BASIS_CACHE:
    basis_t, bb_t = coord.lifted_basis(basis, min_deg)
    _BASIS_CACHE[key] = (torch.as_tensor(basis_t, device=device),
                         torch.as_tensor(bb_t, device=device))
  return _BASIS_CACHE[key]


def padded_bf16_rows(kernel, rows):
  """kernel [F, W] -> bf16 [rows, W], zero rows appended (K padding)."""
  w = kernel.to(torch.bfloat16)
  return F.pad(w, (0, 0, 0, rows - w.shape[0])).contiguous()


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


def featurize_dense_plain(means, covs, kernel, bias, basis, min_deg=0,
                          max_deg=12, use_contract=True):
  """Plain PyTorch version: [..., 3], [..., 3, 3] -> [..., W] f32."""
  if use_contract:
    means, covs = coord.contract_gaussian(means, covs)
  feats = coord.integrated_pos_enc_lifted_recurrence(
      means, covs, basis, min_deg, max_deg).to(torch.bfloat16)
  # bf16 x bf16 products are exact in f32, so an f32 product of the
  # bf16-rounded operands is the bf16-in / f32-accumulate dot.
  return feats.float() @ kernel.to(torch.bfloat16).float() + bias


def _launch(means, covs, kernel, bias, basis, min_deg, max_deg,
            use_contract):
  check_gaussians(means, covs)
  num_feats, width = kernel.shape
  basis_t, bb_t = device_basis(basis, min_deg, means.device)
  num_dims = basis_t.shape[0]
  num_degs = max_deg - min_deg
  if num_feats != 2 * num_degs * num_dims:
    raise ValueError(f'kernel has {num_feats} rows, expected '
                     f'{2 * num_degs * num_dims} features.')
  if width % 32 != 0:
    raise ValueError(f'width {width} must be a multiple of 32.')
  if bias.shape != (width,) or bias.dtype != torch.float32:
    raise ValueError(f'bias must be float32 [{width}].')
  for t in (covs, kernel, bias):
    if t.device != means.device:
      raise ValueError('all inputs must be on one device.')
  w_bf = padded_bf16_rows(kernel, -(-num_feats // 16) * 16)
  bias = bias.contiguous()
  out = torch.empty((means.shape[0], width), dtype=torch.float32,
                    device=means.device)
  lib = build.load('featurize_dense')
  fn = lib.featurize_dense_forward
  fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), w_bf.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), means.shape[0], width, num_dims, num_degs,
                 int(use_contract),
                 torch.cuda.current_stream(means.device).cuda_stream),
              'featurize_dense')
  return out


def featurize_dense(means, covs, kernel, bias, basis, min_deg=0, max_deg=12,
                    use_contract=True):
  """Fused featurize + Dense: [..., 3], [..., 3, 3] -> [..., W] f32.

  Equivalent (to bf16 matmul rounding) to contract -> IPE -> feats @ kernel
  + bias.  Forward only.
  """
  batch_shape = means.shape[:-1]
  if means.device.type == 'cpu':
    counts['plain_calls'] += 1
    return featurize_dense_plain(means, covs, kernel, bias, basis, min_deg,
                                 max_deg, use_contract)
  if means.device.type != 'cuda':
    raise ValueError(f'unsupported device {means.device}.')
  out = _launch(means.reshape(-1, 3), covs.reshape(-1, 9), kernel, bias,
                basis, int(min_deg), int(max_deg), bool(use_contract))
  return out.reshape(batch_shape + (kernel.shape[-1],))
