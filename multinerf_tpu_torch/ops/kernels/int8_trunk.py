"""Fused int8 NerfMLP trunk: CUDA kernel wrappers, plain versions, autograd.

Forward (K5) replaces ``multinerf_tpu/ops/pallas/int8_trunk.py:_fwd_kernel``
(with ``_tile_forward``, ``_qcols`` and, outside the kernel,
``quantize_weights``): contract -> IPE features -> layer 0 in bf16 -> layers
1.. as int8 products with per-sample activation scales and per-output-
channel weight scales, the skip layers adding ``bf16(feats) @ bf16(W_tail)``
-> ReLU after each layer; the output is the last activation in bf16.  At the
360 config (8 x 1,024 trunk, 131,072 samples per 4,096-ray chunk) the
tensor cores bound it (1,924 GOP of int8 and 271 GFLOP of bf16 products,
1.25 ms); the design notes are in ``csrc/int8_trunk.cu`` and
``csrc/int8_tile_pass.cuh``, the tile pass it shares with K6.

Backward (K6) replaces ``_bwd_kernel`` (with ``_qrows``): it recomputes the
forward, walks back through the ReLU masks, and returns every dW_l and db_l.
``bwd_bf16=False`` ('int8'): dx through the per-input-channel weight copy
(wq2, sw2) with da quantized per sample; the hidden dW_l as int8 products
with x_in and da quantized per channel over each group of samples, the
group being the JAX kernel's sample tile (``jax_groups``: N is padded as
the JAX kernel pads it, and the padded samples enter the last group's
scales).  ``bwd_bf16=True`` ('int8_hybrid'): dx through bf16(w_q * sw) and
dW_l = bf16(x_in)^T @ bf16(da).  Layer 0 and the skip layers' feature rows
get bf16 dW in both modes.  Design notes in ``csrc/int8_trunk_bwd.cu``.
The sample positions get no gradient (the JAX VJP returns zeros).

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version, in both directions:
``int8_trunk_plain`` (the port of ``int8_trunk_reference``) and
``int8_trunk_bwd_plain`` (line for line ``_bwd_kernel``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multinerf_tpu_torch.ops import quant
from multinerf_tpu_torch.ops.kernels import build
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
from multinerf_tpu_torch.ops.kernels import plans

# launches: kernel launches; plain_calls: calls served by the plain version.
counts = {'launches': 0, 'plain_calls': 0}  # Forward (K5).
bwd_counts = {'launches': 0, 'plain_calls': 0}  # Backward (K6).


def reset_counts():
  for c in (counts, bwd_counts):
    for k in c:
      c[k] = 0


def pick_tile(n, prefer=512):
  """The JAX kernel's sample tile (featurize_dense.py:_pick_tile at the
  int8 trunk's prefer=512), or 0 when N needs padding."""
  for tile in (prefer, 512, 256, 128):
    if n % tile == 0:
      return tile
  return 0


def jax_groups(n):
  """(n_pad, group): the JAX kernel's padded sample count and tile
  (int8_trunk.py:256-267), the groups of K6's int8 dW scales."""
  tile = pick_tile(n)
  if tile:
    return n, tile
  n_pad = n + (-n) % 256
  return n_pad, pick_tile(n_pad)


def quantize_weights(ws, width):
  """Per-step weight quantization, outside the kernels (int8_trunk.py:94).

  Returns per layer: (w0 bf16,) for layer 0; (w_q, sw [1, W], wq2,
  sw2 [W, 1]) for a hidden layer, + the bf16 feature rows [F, W] for a
  skip layer.  Only the leading [W] rows (the x half) are quantized: w_q
  per output channel, wq2 per input channel (for the backward's dx).
  """
  out = []
  for l, w in enumerate(ws):
    if l == 0:
      out.append((w.to(torch.bfloat16),))
      continue
    x_part, tail = w[:width], w[width:]
    w_q, sw = quant.absmax_quantize(x_part, 0)
    wq2, sw2 = quant.absmax_quantize(x_part, 1)
    out.append((w_q, sw, wq2, sw2) +
               ((tail.to(torch.bfloat16),) if tail.shape[0] else ()))
  return out


def _plain_forward(feats, qlayers, bs, skip_layers):
  """Every layer's f32 activation [N, W] from the bf16 features [N, F]."""
  f = feats.float()
  x = torch.clamp_min(f @ qlayers[0][0].float() + bs[0], 0.0)
  acts = [x]
  for l in range(1, len(qlayers)):
    w_q, sw = qlayers[l][:2]
    x_q, sx = quant.absmax_quantize(x, -1)
    y = quant.int8_dot(x_q, w_q).float() * (sx * sw)
    if l in skip_layers:
      # bf16 x bf16 products are exact in f32: an f32 product of the
      # rounded operands is the bf16-in / f32-accumulate dot.
      y = y + f @ qlayers[l][-1].float()
    x = torch.clamp_min(y + bs[l], 0.0)
    acts.append(x)
  return acts


def int8_trunk_plain(means, covs, ws, bs, basis, min_deg=0, max_deg=12,
                     use_contract=True, skip_layers=()):
  """Plain PyTorch version of K5: [..., 3], [..., 3, 3] -> [..., W] bf16."""
  width = ws[-1].shape[-1]
  feats = fd.plain_features(means, covs, basis, min_deg, max_deg,
                            use_contract)
  acts = _plain_forward(feats.reshape(-1, feats.shape[-1]),
                        quantize_weights(ws, width), bs, set(skip_layers))
  return acts[-1].to(torch.bfloat16).reshape(feats.shape[:-1] + (width,))


def int8_trunk_bwd_plain(means, covs, ws, bs, g, basis, min_deg=0,
                         max_deg=12, use_contract=True, skip_layers=(),
                         bwd_bf16=False):
  """Plain PyTorch version of K6, line for line ``_bwd_kernel``.

  Args: means [N, 3], covs [N, 3, 3], the trunk as in ``int8_trunk``, g
    [N, W] the cotangent of its output.
  Returns: (dws, dbs) in f32, shaped as ws and bs.

  int8 mode: each group product contracts over at most 512 samples, so its
  int8 x int8 sums are below 2^24 and exact in f32: the groups run as one
  batched f32 product (TF32 must be off, PyTorch's default for matmuls).
  """
  width = ws[-1].shape[-1]
  skip_layers = set(skip_layers)
  n = means.shape[0]
  n_pad, group = jax_groups(n)
  means = F.pad(means, (0, 0, 0, n_pad - n))
  covs = F.pad(covs.reshape(n, 9), (0, 0, 0, n_pad - n)).reshape(n_pad, 3, 3)
  f = fd.plain_features(means, covs, basis, min_deg, max_deg,
                        use_contract).float()
  q = quantize_weights(ws, width)
  acts = _plain_forward(f, q, bs, skip_layers)
  da = F.pad(g.float(), (0, 0, 0, n_pad - n))
  dws, dbs = [None] * len(ws), [None] * len(ws)
  for l in range(len(ws) - 1, -1, -1):
    da = da * (acts[l] > 0)
    da16 = da.to(torch.bfloat16).float()
    if l == 0:
      dws[0] = f.T @ da16
    else:
      if bwd_bf16:
        dw = acts[l - 1].to(torch.bfloat16).float().T @ da16
      else:
        groups = n_pad // group
        xq, sx = quant.absmax_quantize(
            acts[l - 1].view(groups, group, width), 1)
        dq, sd = quant.absmax_quantize(da.view(groups, group, width), 1)
        dw = ((xq.float().transpose(1, 2) @ dq.float()) *
              (sx.transpose(1, 2) * sd)).sum(0)
      if l in skip_layers:
        dw = torch.cat([dw, f.T @ da16])
      dws[l] = dw
    dbs[l] = da.sum(0)
    if l > 0:
      if bwd_bf16:
        w_q, sw = q[l][:2]
        da = da16 @ (w_q.float() * sw).to(torch.bfloat16).float().T
      else:
        wq2, sw2 = q[l][2:4]
        dq, sdac = quant.absmax_quantize(da, -1)
        da = quant.int8_dot(dq, wq2.T).float() * (sdac * sw2.T)
  return dws, dbs


def _check_trunk(means, ws, bs, basis, min_deg, max_deg, skip_layers):
  """(basis_t, bb_t, num_dims, num_degs, num_feats, width, skip_mask) after
  the checks of what the kernels take."""
  basis_t, bb_t, num_dims, num_degs = fd.check_dense(
      means, ws[-1].shape[-1], basis, min_deg, max_deg)
  num_feats = 2 * num_degs * num_dims
  width = ws[-1].shape[-1]
  depth = len(ws)
  if not all(1 <= s < depth for s in skip_layers) or depth > 31:
    raise ValueError(f'skip layers {skip_layers} outside 1..{depth - 1}.')
  if width % 64:
    raise ValueError(f'width {width} must be a multiple of 64.')
  want = [(num_feats, width)] + [
      (width + (num_feats if l in skip_layers else 0), width)
      for l in range(1, depth)]
  if [tuple(w.shape) for w in ws] != want:
    raise ValueError(f'trunk shapes {[tuple(w.shape) for w in ws]}, '
                     f'expected {want}.')
  if [tuple(b.shape) for b in bs] != [(width,)] * depth:
    raise ValueError('each trunk bias must be [width].')
  for t in (*ws, *bs):
    if t.device != means.device:
      raise ValueError('all inputs must be on one device.')
  skip_mask = sum(1 << s for s in skip_layers)
  return basis_t, bb_t, num_dims, num_degs, num_feats, width, skip_mask


def _stack(ts, dtype, device):
  """torch.stack(ts), contiguous; one zero for an empty list (a trunk
  without hidden or skip layers), which the kernels never read."""
  if not ts:
    return torch.zeros((1,), dtype=dtype, device=device)
  return torch.stack(ts).contiguous()


def _operands(ws, bs, width, num_feats, skip_layers):
  """The kernels' weight operands (csrc/int8_tile_pass.cuh: I8TrunkArgs)
  and the quantized layers."""
  q = quantize_weights(ws, width)
  kpad = -(-num_feats // 32) * 32  # csrc/int8_tile_pass.cuh: i8_kpad.
  device = ws[0].device
  padded_t = lambda w: F.pad(w, (0, 0, 0, kpad - num_feats)).T.contiguous()
  hidden = q[1:]
  ops = dict(
      w0t=padded_t(q[0][0]),
      wqt=_stack([t[0].T for t in hidden], torch.int8, device),
      sw=_stack([t[1].reshape(-1) for t in hidden], torch.float32, device),
      tailt=_stack([padded_t(q[l][-1]) for l in sorted(skip_layers)],
                   torch.bfloat16, device),
      biases=torch.stack([b.float() for b in bs]).contiguous())
  return ops, q


def _stream(device):
  return torch.cuda.current_stream(device).cuda_stream


def _launch(means, covs, ws, bs, basis, min_deg, max_deg, use_contract,
            skip_layers):
  fd.check_gaussians(means, covs)
  if covs.device != means.device:
    raise ValueError('all inputs must be on one device.')
  basis_t, bb_t, num_dims, num_degs, num_feats, width, skip_mask = (
      _check_trunk(means, ws, bs, basis, min_deg, max_deg, skip_layers))
  n = means.shape[0]
  out = torch.empty((n, width), dtype=torch.bfloat16, device=means.device)
  if n == 0:
    return out
  ops, _ = _operands(ws, bs, width, num_feats, skip_layers)
  plan = plans.i8_fwd_plan(num_feats, width, num_dims, n,
                           fd.num_sms(means.device))
  stage = torch.empty((plan.stage_floats,), dtype=torch.float32,
                      device=means.device)
  lib = build.load('int8_trunk')
  fn = lib.int8_trunk_forward
  fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
      ctypes.c_void_p]
  fn.restype = ctypes.c_int
  counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), ops['w0t'].data_ptr(),
                 ops['wqt'].data_ptr(), ops['sw'].data_ptr(),
                 ops['tailt'].data_ptr(), ops['biases'].data_ptr(),
                 stage.data_ptr(), out.data_ptr(), n, width, len(ws),
                 num_dims, num_degs, int(use_contract), skip_mask, plan.bn,
                 plan.stages, plan.grid, _stream(means.device)),
              'int8_trunk')
  return out


def _launch_bwd(means, covs, ws, bs, g, basis, min_deg, max_deg,
                use_contract, skip_layers, bwd_bf16):
  fd.check_gaussians(means, covs)
  device = means.device
  basis_t, bb_t, num_dims, num_degs, num_feats, width, skip_mask = (
      _check_trunk(means, ws, bs, basis, min_deg, max_deg, skip_layers))
  n = means.shape[0]
  depth = len(ws)
  if g.dtype != torch.bfloat16 or tuple(g.shape) != (n, width):
    raise ValueError(f'g must be bfloat16 [{n}, {width}], got {g.dtype} '
                     f'{tuple(g.shape)}.')
  for t in (covs, g):
    if t.device != device:
      raise ValueError('all inputs must be on one device.')
  if n == 0:
    raise ValueError('the backward kernel needs at least one sample.')
  g = g.contiguous()
  ops, q = _operands(ws, bs, width, num_feats, skip_layers)
  # dx weights, [in][out]: wq2 and sw2 (int8), or bf16(w_q * sw) (hybrid).
  if bwd_bf16:
    wdx = _stack([(t[0].float() * t[1]).to(torch.bfloat16) for t in q[1:]],
                 torch.bfloat16, device)
    swdx = ops['sw']
  else:
    wdx = _stack([t[2] for t in q[1:]], torch.int8, device)
    swdx = _stack([t[3].reshape(-1) for t in q[1:]], torch.float32, device)
  n_pad, group = jax_groups(n)
  plan = plans.int8_bwd_plan(num_feats, width, depth, len(skip_layers), n,
                             n_pad, group, num_dims, fd.num_sms(device),
                             bwd_bf16)
  groups = n_pad // group
  empty = lambda shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  scratch = torch.bfloat16 if plan.hybrid else torch.float32
  acts = empty((plan.acts_planes, n_pad, width), scratch)
  das = empty((plan.das_planes, n_pad, width), scratch)
  d16 = empty((plan.d16_planes, n_pad, width) if plan.d16_planes else (1,),
              torch.bfloat16)
  stage = empty((max(plan.stage_floats, 1),))
  # Group absmaxes as f32 bit patterns (atomicMax), zero = +0.0.
  x_max, d_max = [
      torch.zeros((max(planes, 1), groups, width) if not bwd_bf16 else (1,),
                  dtype=torch.int32, device=device)
      for planes in (depth - 1, depth)]
  vec_part = empty((plan.tile.tiles, depth * width))
  feats = empty((n, plan.kpad), torch.bfloat16)
  qbuf = empty((1,) if bwd_bf16 else (2, n_pad, width), torch.int8)
  gemms = [plan.features] + ([plan.hidden] if bwd_bf16 else [])
  part = empty((max([m.splits * m.rows * width for m in gemms] +
                    ([] if bwd_bf16 else [plan.s8.splits * width * width])),))
  rows = [num_feats] + [width + (num_feats if l in skip_layers else 0)
                        for l in range(1, depth)]
  dw_out = empty((sum(r * width for r in rows),))
  db_out = empty((depth * width,))
  # (bn, splits, per) of the hybrid hidden dW and of the int8 one; the
  # other mode's are not read.
  hidden = ((plan.hidden.bn, plan.hidden.splits, plan.hidden.per)
            if plan.hidden else (0, 0, 0))
  s8 = (plan.s8.bn, plan.s8.splits, plan.s8.per) if plan.s8 else (0, 0, 0)
  lib = build.load('int8_trunk_bwd')
  fn = lib.int8_trunk_backward
  fn.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 22 + [
      ctypes.c_void_p]
  fn.restype = ctypes.c_int
  bwd_counts['launches'] += 1
  build.check(fn(means.data_ptr(), covs.data_ptr(), basis_t.data_ptr(),
                 bb_t.data_ptr(), ops['w0t'].data_ptr(),
                 ops['wqt'].data_ptr(), ops['sw'].data_ptr(),
                 ops['tailt'].data_ptr(), ops['biases'].data_ptr(),
                 wdx.data_ptr(), swdx.data_ptr(), g.data_ptr(),
                 acts.data_ptr(), das.data_ptr(), d16.data_ptr(),
                 stage.data_ptr(), x_max.data_ptr(), d_max.data_ptr(),
                 vec_part.data_ptr(), feats.data_ptr(), part.data_ptr(), qbuf.data_ptr(),
                 dw_out.data_ptr(), db_out.data_ptr(), n, n_pad, group,
                 width, depth, num_dims, num_degs, int(use_contract),
                 skip_mask, int(bwd_bf16), plan.tile.bn, plan.tile.stages,
                 plan.tile.grid, plan.features.bn, plan.features.splits,
                 plan.features.per, *hidden, *s8,
                 _stream(device)),
              'int8_trunk_bwd')
  dws, off = [], 0
  for r in rows:
    dws.append(dw_out[off:off + r * width].view(r, width))
    off += r * width
  dbs = [db_out[l * width:(l + 1) * width] for l in range(depth)]
  return dws, dbs


def int8_trunk_forward(means, covs, ws, bs, basis, min_deg, max_deg,
                       use_contract, skip_layers):
  """K5 on a CUDA tensor, its plain version on a CPU one: [N, 3],
  [N, 3, 3] -> [N, W] bf16.  No autograd."""
  fd.check_device(means)
  if means.device.type == 'cpu':
    counts['plain_calls'] += 1
    return int8_trunk_plain(means, covs, ws, bs, basis, min_deg, max_deg,
                            use_contract, skip_layers)
  return _launch(means, covs.reshape(-1, 9), list(ws), list(bs), basis,
                 int(min_deg), int(max_deg), bool(use_contract),
                 tuple(skip_layers))


def int8_trunk_backward(means, covs, ws, bs, g, basis, min_deg=0, max_deg=12,
                        use_contract=True, skip_layers=(), bwd_bf16=False):
  """K6 on a CUDA tensor, its plain version on a CPU one: -> (dws, dbs)."""
  fd.check_device(means)
  if means.device.type == 'cpu':
    bwd_counts['plain_calls'] += 1
    return int8_trunk_bwd_plain(means, covs, ws, bs, g, basis, min_deg,
                                max_deg, use_contract, skip_layers, bwd_bf16)
  return _launch_bwd(means, covs.reshape(-1, 9), list(ws), list(bs), g, basis,
                     int(min_deg), int(max_deg), bool(use_contract),
                     tuple(skip_layers), bool(bwd_bf16))


class _Int8Trunk(torch.autograd.Function):
  """K5 forward, K6 backward; no gradient to the samples."""

  @staticmethod
  def forward(ctx, means, covs, static, *wbs):
    depth = len(wbs) // 2
    ctx.save_for_backward(means, covs, *wbs)
    ctx.static = static
    basis, min_deg, max_deg, use_contract, skip_layers, _ = static
    return int8_trunk_forward(means, covs, wbs[:depth], wbs[depth:], basis,
                              min_deg, max_deg, use_contract, skip_layers)

  @staticmethod
  def backward(ctx, g):
    means, covs, *wbs = ctx.saved_tensors
    depth = len(wbs) // 2
    ws, bs = wbs[:depth], wbs[depth:]
    dws, dbs = int8_trunk_backward(means, covs, ws, bs, g, *ctx.static)
    return (None, None, None, *[d.to(w.dtype) for d, w in zip(dws, ws)],
            *[d.to(b.dtype) for d, b in zip(dbs, bs)])


def int8_trunk(means, covs, ws, bs, basis, min_deg=0, max_deg=12,
               use_contract=True, skip_layers=(), bwd_bf16=False):
  """Fused featurize + int8 trunk: [..., 3], [..., 3, 3] -> [..., W] bf16.

  ws: trunk kernels, ws[0] [F, W], skip layers [W + F, W], else [W, W];
  bs: biases [W].  skip_layers: the layers that take [x, features].
  bwd_bf16: the hybrid backward ('int8_hybrid').  Gradients flow to every
  weight and bias, through K6.
  """
  fd.check_device(means)
  batch_shape = means.shape[:-1]
  static = (basis, int(min_deg), int(max_deg), bool(use_contract),
            tuple(sorted(int(s) for s in skip_layers)), bool(bwd_bf16))
  out = _Int8Trunk.apply(means.reshape(-1, 3), covs.reshape(-1, 3, 3),
                         static, *ws, *bs)
  return out.reshape(batch_shape + (ws[-1].shape[-1],))
