"""Dynamically quantized int8 matmuls (port of multinerf_tpu/ops/quant.py).

The int8 view branch of the NerfMLP (``MLP.trunk_dtype='int8'`` or
``'int8_hybrid'``) and, with a non-ReLU activation, its hidden trunk layers:

* forward: ``y = (q8(x) @ q8(w)) * (sx * sw)``, int8 products summed in
  int32, x quantized per row and w per output channel;
* ``int8_matmul``'s backward runs both gradient products in int8 as well,
  each operand requantized along its contraction axis (quant.py:92-105);
* ``int8_matmul_hybrid``'s backward runs them unquantized in bf16, dx
  through the forward's own dequantized weights ``q8(w) * sw``
  (quant.py:123-139).

Both backwards are differentiable again, as density-gradient normals need
(a loss on the gradient of the density in the sample means): their ops
are torch ops on the saved inputs, so a second derivative flows through
the absmax scales and the bf16 casts, and not through the quantized
values, whose round and int8 cast carry no gradient, as in JAX's autodiff
of its backward rules.  The hybrid's backward uses the forward's saved
``q8(w) * sw``, and recomputes it from the saved ``w`` when it is itself
differentiated (``create_graph``).  The Functions' outputs keep
their custom backward at every order.  JAX's hybrid forward rule computes
its output in plain code instead (quant.py:123-127), so under
``jax.value_and_grad`` that output's derivative reaches ``w`` through the
scales alone; the port follows the function JAX's rule means to define,
whose forward rule returns the custom function's own output, as
``int8_matmul``'s does (quant.py:88-89).

Scales are ``max(absmax, 1e-30) / 127`` in f32; the quantizer divides by
the scale (no reciprocal) and rounds half to even, as ``jnp.round``.  These
are plain products, as in the JAX package, where XLA computes them outside
any kernel: ``torch._int_mm`` for the int8 ones (exact int32 sums), f32
products of bf16-rounded operands for the hybrid backward (exact products,
f32 sums; TF32 must be off, PyTorch's default for matmuls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# One absmax floor for every scale: all-zero slices quantize to 0.
SCALE_FLOOR = 1e-30


def absmax_quantize(v, dim):
  """Symmetric int8 quantization with one scale per slice along `dim`:
  (int8 values, f32 scales with `dim` kept as size 1)."""
  v = v.float()
  scale = torch.clamp_min(v.abs().amax(dim=dim, keepdim=True),
                          SCALE_FLOOR) / 127.0
  return torch.round(v / scale).to(torch.int8), scale


def int8_dot(aq, bq):
  """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exact.

  Zero rows and columns are appended to meet torch._int_mm's CUDA shape
  rules (M > 16, K and N multiples of 8; here all multiples of 16), and
  the right operand is passed column-major: cuBLASLt's int8 products take
  that layout and refuse some row-major ones.  Zeros add nothing to the
  sums.
  """
  m, k = aq.shape
  n = bq.shape[1]
  up = lambda x: -(-x // 16) * 16
  mp, kp, np_ = max(up(m), 32), up(k), up(n)
  a = F.pad(aq, (0, kp - k, 0, mp - m)).contiguous()
  b = F.pad(bq, (0, np_ - n, 0, kp - k)).T.contiguous().T
  return torch._int_mm(a, b)[:m, :n]


def _forward(x, w):
  """(y f32 [N, M], wq, sw): the int8 forward of both Functions."""
  xq, sx = absmax_quantize(x, -1)  # [N, K], [N, 1]
  wq, sw = absmax_quantize(w, 0)  # [K, M], [1, M]
  return int8_dot(xq, wq).float() * (sx * sw), wq, sw


class _Int8Matmul(torch.autograd.Function):
  """x [N, K] @ w [K, M], int8 forward and int8 backward."""

  @staticmethod
  def forward(ctx, x, w):
    ctx.save_for_backward(x, w)
    return _forward(x, w)[0]

  @staticmethod
  def backward(ctx, g):
    x, w = ctx.saved_tensors
    g = g.float()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      # dx[n, k] = sum_m g[n, m] w[k, m]: both quantized along m.
      gq, sg = absmax_quantize(g, -1)  # [N, M], [N, 1]
      wq, sw = absmax_quantize(w, 1)  # [K, M], [K, 1]
      dx = (int8_dot(gq, wq.T).float() * (sg * sw.T)).to(x.dtype)
    if ctx.needs_input_grad[1]:
      # dw[k, m] = sum_n x[n, k] g[n, m]: both quantized along n.
      xq, sx = absmax_quantize(x, 0)  # [N, K], [1, K]
      gq, sg = absmax_quantize(g, 0)  # [N, M], [1, M]
      dw = int8_dot(xq.T, gq).float() * (sx.T * sg)
    return dx, dw


class _Int8MatmulHybrid(torch.autograd.Function):
  """x [N, K] @ w [K, M], int8 forward and unquantized bf16 backward."""

  @staticmethod
  def forward(ctx, x, w):
    y, wq, sw = _forward(x, w)
    ctx.save_for_backward(x, w, wq.float() * sw)
    return y

  @staticmethod
  def backward(ctx, g):
    x, w, w_deq = ctx.saved_tensors
    if torch.is_grad_enabled():
      # A backward that is differentiated again: the same dequantized
      # weights, recomputed to be differentiable in w through sw.
      wq, sw = absmax_quantize(w, 0)
      w_deq = wq.float() * sw
    g16 = g.to(torch.bfloat16).float()
    dx = dw = None
    # bf16 x bf16 products are exact in f32: an f32 product of the rounded
    # operands is the bf16-in / f32-accumulate dot.
    if ctx.needs_input_grad[0]:
      dx = (g16 @ w_deq.to(torch.bfloat16).float().T).to(x.dtype)
    if ctx.needs_input_grad[1]:
      dw = x.to(torch.bfloat16).float().T @ g16
    return dx, dw


def int8_matmul(x, w):
  """y = x @ w, f32 [N, M], through int8 in both directions."""
  return _Int8Matmul.apply(x, w)


def int8_matmul_hybrid(x, w):
  """int8 forward (the same values as int8_matmul), bf16 backward."""
  return _Int8MatmulHybrid.apply(x, w)


def quant_dense(layer, x, hybrid=False):
  """quant.QuantDense on a ``Dense`` layer's parameters: the int8 product,
  then the f32 bias outside the Function, then bf16.  [..., K] ->
  [..., M] bf16."""
  lead = x.shape[:-1]
  matmul = int8_matmul_hybrid if hybrid else int8_matmul
  y = matmul(x.reshape(-1, x.shape[-1]), layer.kernel)
  y = (y + layer.bias).to(torch.bfloat16)
  return y.reshape(lead + (y.shape[-1],))
