"""Fully fused density MLP: CUDA kernel wrappers, plain versions, autograd.

Forward (K1) replaces ``multinerf_tpu/ops/pallas/density_mlp.py:_fwd_kernel``
(with ``_trunk_forward`` and ``_density_row``): contract -> IPE features ->
a ReLU trunk of bf16-in / f32-accumulate layers -> the density head as an
f32 sum of bf16-rounded products.  At the 360 config (4 x 256 trunk, 262,144
samples per proposal level of a 4,096-ray batch) that is 172 GFLOP for 52
bytes of device-memory traffic per sample, so the tensor cores bound it.
The design notes (the forward half of K3's persistent wgmma tile pass, fed
by a TMA weight ring) are in ``csrc/density_mlp.cu``; the launch plan in
``plans.py``.  A trunk narrower than 64, 128 or 256 runs zero-padded to
that width; wider trunks are refused, as K3 refuses them.

Backward (K3) replaces ``_bwd_kernel``: it recomputes the forward per tile
and returns every trunk and head weight and bias gradient, with the
numerics of the Pallas kernel rather than autograd's of the forward (f32
head weight and last activation for da_L and dwd, cotangents rounded to
bf16 before each product, ReLU masks from the recomputed activations).  The
sample positions get no gradient.  Design notes (a wgmma tile pass fed by
TMA, then the four dW products on the split-K TMA + wgmma GEMM of
``csrc/wgmma_dw.cuh`` and ordered reduces, deterministic) are in
``csrc/density_mlp_bwd.cu``; the launch plans in ``plans.py``.  A trunk
narrower than 64, 128 or 256 runs zero-padded to that width.  Where the
feature tile does not fit beside the rest (672 features: blender_512.gin
and llff_512.gin), layer 0 runs in two K-parts, the sin and the cos half of
the features: the wrapper lays w0's rows out part by part
(``BwdPlan.w0_rows``) and the kernel returns dW_0 in the features' order.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version, in both directions: ``density_mlp_plain``
(the port of ``density_mlp_reference``) and ``density_mlp_bwd_plain`` (the
line-for-line port of ``_bwd_kernel``), with the same bf16 roundings.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multinerf_tpu_torch.ops.kernels import build
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
from multinerf_tpu_torch.ops.kernels import plans

# launches: kernel launches; plain_calls: calls served by the plain version.
counts = {'launches': 0, 'plain_calls': 0}  # Forward (K1).
bwd_counts = {'launches': 0, 'plain_calls': 0}  # Backward (K3).


def reset_counts():
  for c in (counts, bwd_counts):
    for k in c:
      c[k] = 0


def density_mlp_plain(means, covs, ws, bs, wd, bd, basis, min_deg=0,
                      max_deg=12, use_contract=True):
  """Plain PyTorch version of K1: [..., 3], [..., 3, 3] -> raw density."""
  x = fd.plain_features(means, covs, basis, min_deg, max_deg, use_contract)
  for w, b in zip(ws, bs):
    pre = x.float() @ w.to(torch.bfloat16).float() + b
    x = torch.relu(pre).to(torch.bfloat16)
  return (x.float() @ wd.to(torch.bfloat16).float() + bd)[..., 0]


def density_mlp_bwd_plain(means, covs, ws, bs, wd, g, basis, min_deg=0,
                          max_deg=12, use_contract=True):
  """Plain PyTorch version of K3, line for line ``_bwd_kernel``.

  Args: means [N, 3], covs [N, 3, 3], the trunk and head as in
    ``density_mlp``, g [N] the cotangent of the raw density.
  Returns: (dws, dbs, dwd [W, 1], dbd []) in f32.
  """
  feats = fd.plain_features(means, covs, basis, min_deg, max_deg,
                            use_contract)
  g = g.reshape(-1)
  acts = []
  x = feats
  for w, b in zip(ws, bs):
    act = torch.clamp_min(x.float() @ w.to(torch.bfloat16).float() + b, 0.0)
    acts.append(act)
    x = act.to(torch.bfloat16)
  dwd = (acts[-1] * g[:, None]).sum(0)[:, None]
  dbd = g.sum()
  da = wd.reshape(-1).float() * g[:, None] * (acts[-1] > 0)
  dws, dbs = [None] * len(ws), [None] * len(ws)
  for l in range(len(ws) - 1, -1, -1):
    x_in = feats if l == 0 else acts[l - 1].to(torch.bfloat16)
    da_bf = da.to(torch.bfloat16).float()
    dws[l] = x_in.float().T @ da_bf
    dbs[l] = da.sum(0)
    if l > 0:
      da = (da_bf @ ws[l].to(torch.bfloat16).float().T) * (acts[l - 1] > 0)
  return dws, dbs, dwd, dbd


def _check_trunk(means, ws, bs, wd, bd, basis, min_deg, max_deg):
  """(basis_t, bb_t, num_dims, num_degs, num_feats, depth, width) after the
  checks of what the kernels take."""
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
  if tuple(wd.shape) != (width, 1) or (bd is not None and bd.numel() != 1):
    raise ValueError('density head must be [width, 1] + a scalar bias.')
  for t in (*ws, *bs, wd) + (() if bd is None else (bd,)):
    if t.device != device:
      raise ValueError('all inputs must be on one device.')
  return basis_t, bb_t, num_dims, num_degs, num_feats, depth, width


def _trunk_operands(ws, bs, kpad, parts=None):
  """(w0 [kpad, W] bf16, w_hidden [depth-1, W, W] bf16, biases [depth, W]).
  parts: (first feature, first row, count) of each K-part of w0's rows
  (K3's ``BwdPlan.w0_rows``); by default the features in order."""
  if parts is None:
    w0 = fd.padded_bf16_rows(ws[0], kpad)
  else:
    w0 = torch.zeros((kpad, ws[0].shape[-1]), dtype=torch.bfloat16,
                     device=ws[0].device)
    for f0, r0, count in parts:
      w0[r0:r0 + count] = ws[0][f0:f0 + count]
  if len(ws) > 1:
    w_hidden = torch.stack([w.to(torch.bfloat16) for w in ws[1:]])
  else:
    w_hidden = torch.zeros((1,), dtype=torch.bfloat16, device=ws[0].device)
  return w0, w_hidden, torch.stack([b.float() for b in bs]).contiguous()


def _launch(means, covs, ws, bs, wd, bd, basis, min_deg, max_deg,
            use_contract):
  fd.check_gaussians(means, covs)
  if covs.device != means.device:
    raise ValueError('all inputs must be on one device.')
  basis_t, bb_t, num_dims, num_degs, num_feats, depth, width = _check_trunk(
      means, ws, bs, wd, bd, basis, min_deg, max_deg)
  n = means.shape[0]
  out = torch.empty((n,), dtype=torch.float32, device=means.device)
  if n == 0:
    return out
  plan = fd.fwd_plan(plans.density_mlp_fwd_plan, 'density_mlp', num_feats,
                     width, num_dims, n)
  ws, bs, wd = _pad_trunk(ws, bs, wd, plan.width)
  w0, w_hidden, biases = _trunk_operands(ws, bs, plan.kpad)
  wd_bf = wd.reshape(-1).to(torch.bfloat16).contiguous()
  bd_f = bd.reshape(1).float().contiguous()
  lib = build.load('density_mlp')
  fn = lib.density_mlp_forward
  fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
      ctypes.c_void_p]
  fn.restype = ctypes.c_int
  counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), w0.data_ptr(), w_hidden.data_ptr(),
                 biases.data_ptr(), wd_bf.data_ptr(), bd_f.data_ptr(),
                 out.data_ptr(), n, plan.width, depth, num_dims, num_degs,
                 int(use_contract), plan.grid, plan.stages,
                 torch.cuda.current_stream(means.device).cuda_stream),
              'density_mlp')
  return out


def _launch_bwd(means, covs, ws, bs, wd, g, basis, min_deg, max_deg,
                use_contract):
  fd.check_gaussians(means, covs)
  device = means.device
  basis_t, bb_t, num_dims, num_degs, num_feats, depth, width = _check_trunk(
      means, ws, bs, wd, None, basis, min_deg, max_deg)
  if depth < 2:
    raise ValueError('the backward kernel needs a trunk of depth >= 2.')
  n = means.shape[0]
  if g.dtype != torch.float32 or g.numel() != n:
    raise ValueError(f'g must be float32 with {n} elements.')
  for t in (covs, g):
    if t.device != device:
      raise ValueError('all inputs must be on one device.')
  g = g.reshape(-1).contiguous()
  if n == 0:
    return ([torch.zeros_like(w, dtype=torch.float32) for w in ws],
            [torch.zeros((width,), device=device) for _ in bs],
            torch.zeros((width, 1), device=device),
            torch.zeros((), device=device))
  plan = plans.density_mlp_bwd_plan(num_feats, width, depth, num_dims, n,
                                    fd.num_sms(device))
  wp = plan.width  # The kernel's width: the trunk zero-padded to it.
  ws, bs, wd = _pad_trunk(ws, bs, wd, wp)
  w0, w_hidden, biases = _trunk_operands(
      ws, bs, plan.kpad, plan.w0_rows(num_feats) if plan.parts > 1 else None)
  wd_f = wd.reshape(-1).float().contiguous()
  vstride = (depth + 1) * wp + 1
  empty = lambda shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  feats = empty((plan.n_pad, plan.kpad), torch.bfloat16)
  acts = empty((depth - 1, plan.n_pad, wp), torch.bfloat16)
  das = empty((depth, plan.n_pad, wp), torch.bfloat16)
  vec_part = empty((2 * plan.tiles, vstride))
  part = empty((max(plan.dw0.splits * plan.kpad, plan.dw1.splits * wp), wp))
  dw_out = empty((num_feats * wp + (depth - 1) * wp * wp,))
  vec_out = empty((vstride,))
  lib = build.load('density_mlp_bwd')
  fn = lib.density_mlp_backward
  fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 14 + [
      ctypes.c_void_p]
  fn.restype = ctypes.c_int
  bwd_counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), w0.data_ptr(), w_hidden.data_ptr(),
                 biases.data_ptr(), wd_f.data_ptr(), g.data_ptr(),
                 feats.data_ptr(), acts.data_ptr(), das.data_ptr(),
                 vec_part.data_ptr(), part.data_ptr(), dw_out.data_ptr(),
                 vec_out.data_ptr(), n, wp, depth, num_dims, num_degs,
                 int(use_contract), plan.parts, plan.grid, plan.dw0.bn,
                 plan.dw0.splits,
                 plan.dw0.per, plan.dw1.bn, plan.dw1.splits, plan.dw1.per,
                 torch.cuda.current_stream(device).cuda_stream),
              'density_mlp_bwd')
  dws = [dw_out[:num_feats * wp].view(num_feats, wp)]
  for l in range(depth - 1):
    off = num_feats * wp + l * wp * wp
    dws.append(dw_out[off:off + wp * wp].view(wp, wp))
  dbs = [vec_out[l * wp:(l + 1) * wp] for l in range(depth)]
  dwd = vec_out[depth * wp:(depth + 1) * wp].view(wp, 1)
  if wp != width:
    dws = [dws[0][:, :width].contiguous()] + [
        d[:width, :width].contiguous() for d in dws[1:]]
    dbs = [d[:width].contiguous() for d in dbs]
    dwd = dwd[:width].contiguous()
  return dws, dbs, dwd, vec_out[-1]


def _pad_trunk(ws, bs, wd, wp):
  """The trunk and head zero-padded from width W to wp: the padded units
  are 0 forward (ReLU of 0) and get cotangent 0, so the density and every
  real gradient are unchanged."""
  pad = wp - ws[-1].shape[-1]
  if pad == 0:
    return ws, bs, wd
  return ([F.pad(ws[0], (0, pad))] +
          [F.pad(w, (0, pad, 0, pad)) for w in ws[1:]],
          [F.pad(b, (0, pad)) for b in bs], F.pad(wd, (0, 0, 0, pad)))


def density_mlp_forward(means, covs, ws, bs, wd, bd, basis, min_deg,
                        max_deg, use_contract):
  """K1 on a CUDA tensor, its plain version on a CPU one: [N, 3],
  [N, 3, 3] -> raw density [N].  No autograd."""
  fd.check_device(means)
  if means.device.type == 'cpu':
    counts['plain_calls'] += 1
    return density_mlp_plain(means, covs, ws, bs, wd, bd, basis, min_deg,
                             max_deg, use_contract)
  return _launch(means, covs.reshape(-1, 9), list(ws), list(bs), wd, bd,
                 basis, int(min_deg), int(max_deg), bool(use_contract))


def density_mlp_backward(means, covs, ws, bs, wd, g, basis, min_deg=0,
                         max_deg=12, use_contract=True):
  """K3 on a CUDA tensor, its plain version on a CPU one:
  -> (dws, dbs, dwd [W, 1], dbd [])."""
  fd.check_device(means)
  if means.device.type == 'cpu':
    bwd_counts['plain_calls'] += 1
    return density_mlp_bwd_plain(means, covs, ws, bs, wd, g, basis, min_deg,
                                 max_deg, use_contract)
  return _launch_bwd(means, covs.reshape(-1, 9), list(ws), list(bs), wd, g,
                     basis, int(min_deg), int(max_deg), bool(use_contract))


class _DensityMLP(torch.autograd.Function):
  """K1 forward, K3 backward; no gradient to the samples."""

  @staticmethod
  def forward(ctx, means, covs, static, wd, bd, *wbs):
    depth = len(wbs) // 2
    ctx.save_for_backward(means, covs, wd, bd, *wbs)
    ctx.static = static
    return density_mlp_forward(means, covs, wbs[:depth], wbs[depth:], wd, bd,
                               *static)

  @staticmethod
  def backward(ctx, g):
    means, covs, wd, bd, *wbs = ctx.saved_tensors
    depth = len(wbs) // 2
    ws, bs = wbs[:depth], wbs[depth:]
    dws, dbs, dwd, dbd = density_mlp_backward(means, covs, ws, bs, wd, g,
                                              *ctx.static)
    return (None, None, None, dwd.to(wd.dtype),
            dbd.reshape(bd.shape).to(bd.dtype),
            *[d.to(w.dtype) for d, w in zip(dws, ws)],
            *[d.to(b.dtype) for d, b in zip(dbs, bs)])


def density_mlp(means, covs, ws, bs, wd, bd, basis, min_deg=0, max_deg=12,
                use_contract=True):
  """Fused featurize + trunk + density head: -> raw density [...] f32.

  Args:
    means: [..., 3]; covs: [..., 3, 3].
    ws/bs: trunk kernels [C_in, W] / biases [W] (uniform width W).
    wd/bd: density head [W, 1] kernel and scalar bias.

  Gradients flow to every weight and bias, through K3.
  """
  fd.check_device(means)
  batch_shape = means.shape[:-1]
  static = (basis, int(min_deg), int(max_deg), bool(use_contract))
  out = _DensityMLP.apply(means.reshape(-1, 3), covs.reshape(-1, 3, 3),
                          static, wd, bd, *ws, *bs)
  return out.reshape(batch_shape)
