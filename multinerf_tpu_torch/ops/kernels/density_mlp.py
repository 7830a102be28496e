"""Fully fused density MLP forward: CUDA kernel wrapper and plain version.

Replaces ``multinerf_tpu/ops/pallas/density_mlp.py:_fwd_kernel`` (with
``_trunk_forward`` and ``_density_row``): contract -> IPE features -> a ReLU
trunk of bf16-in / f32-accumulate layers -> the density head as an f32 sum
of bf16-rounded products.  At the 360 config (4 x 256 trunk, 262,144 samples
per proposal level of a 4,096-ray chunk) that is 172 GFLOP for 52 bytes of
device-memory traffic per sample, so the tensor cores bound it; the design
notes (weights streamed through L2, activations ping-ponged in shared
memory) are in ``csrc/density_mlp.cu``.

Forward only: rendering needs no gradient.  The backward kernel and the
``torch.autograd.Function`` come with the training port.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs ``density_mlp_plain``, the line-for-line port of
``density_mlp_reference`` with the same bf16 roundings.
"""

from __future__ import annotations

import ctypes

import torch

from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.ops.kernels import build
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd

# launches: kernel launches; plain_calls: calls served by the plain version.
counts = {'launches': 0, 'plain_calls': 0}


def reset_counts():
  for k in counts:
    counts[k] = 0


def density_mlp_plain(means, covs, ws, bs, wd, bd, basis, min_deg=0,
                      max_deg=12, use_contract=True):
  """Plain PyTorch version: [..., 3], [..., 3, 3] -> raw density [...]."""
  if use_contract:
    means, covs = coord.contract_gaussian(means, covs)
  x = coord.integrated_pos_enc_lifted_recurrence(
      means, covs, basis, min_deg, max_deg).to(torch.bfloat16)
  for w, b in zip(ws, bs):
    pre = x.float() @ w.to(torch.bfloat16).float() + b
    x = torch.relu(pre).to(torch.bfloat16)
  return (x.float() @ wd.to(torch.bfloat16).float() + bd)[..., 0]


def _launch(means, covs, ws, bs, wd, bd, basis, min_deg, max_deg,
            use_contract):
  fd.check_gaussians(means, covs)
  device = means.device
  basis_t, bb_t = fd.device_basis(basis, min_deg, device)
  num_dims = basis_t.shape[0]
  num_degs = max_deg - min_deg
  num_feats = 2 * num_degs * num_dims
  depth = len(ws)
  width = ws[-1].shape[-1]
  if width % 32 != 0:
    raise ValueError(f'width {width} must be a multiple of 32.')
  want = [(num_feats, width)] + [(width, width)] * (depth - 1)
  if [tuple(w.shape) for w in ws] != want:
    raise ValueError(f'trunk shapes {[tuple(w.shape) for w in ws]}, '
                     f'expected {want}.')
  if [tuple(b.shape) for b in bs] != [(width,)] * depth:
    raise ValueError('each trunk bias must be [width].')
  if tuple(wd.shape) != (width, 1) or bd.numel() != 1:
    raise ValueError('density head must be [width, 1] + a scalar bias.')
  for t in (covs, *ws, *bs, wd, bd):
    if t.device != device:
      raise ValueError('all inputs must be on one device.')
  w0 = fd.padded_bf16_rows(ws[0], -(-num_feats // 16) * 16)
  if depth > 1:
    w_hidden = torch.stack([w.to(torch.bfloat16) for w in ws[1:]])
  else:
    w_hidden = torch.zeros((1,), dtype=torch.bfloat16, device=device)
  biases = torch.stack([b.float() for b in bs]).contiguous()
  wd_bf = wd.reshape(-1).to(torch.bfloat16).contiguous()
  bd_f = bd.reshape(1).float().contiguous()
  out = torch.empty((means.shape[0],), dtype=torch.float32, device=device)
  lib = build.load('density_mlp')
  fn = lib.density_mlp_forward
  fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
      ctypes.c_void_p]
  fn.restype = ctypes.c_int
  counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), w0.data_ptr(), w_hidden.data_ptr(),
                 biases.data_ptr(), wd_bf.data_ptr(), bd_f.data_ptr(),
                 out.data_ptr(), means.shape[0], width, depth, num_dims,
                 num_degs, int(use_contract),
                 torch.cuda.current_stream(device).cuda_stream),
              'density_mlp')
  return out


def density_mlp(means, covs, ws, bs, wd, bd, basis, min_deg=0, max_deg=12,
                use_contract=True):
  """Fused featurize + trunk + density head: -> raw density [...] f32.

  Args:
    means: [..., 3]; covs: [..., 3, 3].
    ws/bs: trunk kernels [C_in, W] / biases [W] (uniform width W).
    wd/bd: density head [W, 1] kernel and scalar bias.
  """
  batch_shape = means.shape[:-1]
  if means.device.type == 'cpu':
    counts['plain_calls'] += 1
    return density_mlp_plain(means, covs, ws, bs, wd, bd, basis, min_deg,
                             max_deg, use_contract)
  if means.device.type != 'cuda':
    raise ValueError(f'unsupported device {means.device}.')
  out = _launch(means.reshape(-1, 3), covs.reshape(-1, 9), list(ws),
                list(bs), wd, bd, basis, int(min_deg), int(max_deg),
                bool(use_contract))
  return out.reshape(batch_shape)
