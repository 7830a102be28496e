"""The port's int8 matmuls (multinerf_tpu_torch/ops/quant.py) against the
JAX package's (multinerf_tpu/ops/quant.py) on the same numpy inputs.

Tolerances:
* quantized values, scales, forward outputs and the int8 backward: bitwise.
  Both sides take the absmax, divide by 127 and by the scale in IEEE f32,
  round half to even, sum int8 products exactly in int32 and multiply by
  the same f32 scale products.
* the hybrid backward's bf16 products: the same bf16-rounded operands and
  exact products, summed in f32 in another order, so 1e-6 of the largest
  value.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.ops import quant as jquant  # noqa: E402
from multinerf_tpu_torch.models import mlp as mlp_lib  # noqa: E402
from multinerf_tpu_torch.ops import quant  # noqa: E402

# The view branch of 360.gin: [N, 256 + 27] -> 128, here with N ragged.
N, K, M = 33, 283, 128


def _inputs(seed=0, n=N, k=K, m=M):
  rng = np.random.RandomState(seed)
  x = (rng.randn(n, k) * rng.uniform(0.1, 3.0, (n, 1))).astype(np.float32)
  x[3] = 0.0  # An all-zero row takes the scale floor.
  w = (rng.randn(k, m) / np.sqrt(k)).astype(np.float32)
  g = rng.randn(n, m).astype(np.float32)
  return x, w, g


@pytest.mark.parametrize('dim', [0, 1, -1])
def test_absmax_quantize_is_bitwise_jax(dim):
  x, _, _ = _inputs()
  q, s = quant.absmax_quantize(torch.as_tensor(x), dim)
  jq, js = jquant.absmax_quantize(jnp.asarray(x), dim)
  assert q.dtype == torch.int8 and s.dtype == torch.float32
  np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
  np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize('shape', [(N, K, M), (600, 59, 32), (5, 16, 8)])
def test_int8_dot_is_exact(shape):
  n, k, m = shape
  rng = np.random.RandomState(1)
  a = rng.randint(-127, 128, (n, k)).astype(np.int8)
  b = rng.randint(-127, 128, (k, m)).astype(np.int8)
  got = quant.int8_dot(torch.as_tensor(a), torch.as_tensor(b))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(
      got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize('hybrid', [False, True])
def test_forward_and_backward_match_jax(hybrid):
  x, w, g = _inputs(seed=2)
  jfn = jquant.int8_matmul_hybrid if hybrid else jquant.int8_matmul
  want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
  want_dx, want_dw = vjp(jnp.asarray(g))
  xt = torch.as_tensor(x).requires_grad_()
  wt = torch.as_tensor(w).requires_grad_()
  fn = quant.int8_matmul_hybrid if hybrid else quant.int8_matmul
  got = fn(xt, wt)
  got.backward(torch.as_tensor(g))
  # The hybrid forward is int8_matmul's: bitwise in both modes.
  np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
  for name, a, b in (('dx', xt.grad, want_dx), ('dw', wt.grad, want_dw)):
    b = np.asarray(b)
    if hybrid:
      tp.assert_close(a.numpy(), b, atol=1e-6 * float(np.abs(b).max()),
                      what=name)
    else:
      np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize('hybrid', [False, True])
def test_quant_dense_matches_quant_dense_of_jax(hybrid):
  """QuantDense on the same parameters: bf16 forward bitwise; the gradient
  through the bf16 cast (its cotangent is rounded to bf16 on both sides)
  as above."""
  x, w, g = _inputs(seed=3)
  b = np.random.RandomState(4).randn(M).astype(np.float32) * 0.1
  module = jquant.QuantDense(M, hybrid=hybrid)
  params = {'params': {'kernel': jnp.asarray(w), 'bias': jnp.asarray(b)}}

  def jax_loss(p, x):
    y = module.apply(p, x)
    return jnp.sum(y.astype(jnp.float32) * g), y

  (_, want), (want_p, want_dx) = jax.value_and_grad(
      jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
  layer = mlp_lib.Dense(K, M, lambda shape, gen: torch.zeros(shape), None,
                        'cpu')
  with torch.no_grad():
    layer.kernel.copy_(torch.as_tensor(w))
    layer.bias.copy_(torch.as_tensor(b))
  xt = torch.as_tensor(x).requires_grad_()
  got = quant.quant_dense(layer, xt, hybrid)
  (got.float() * torch.as_tensor(g)).sum().backward()
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.detach().float().numpy(),
                                np.asarray(want.astype(jnp.float32)))
  grads = {'kernel': (layer.kernel.grad, want_p['params']['kernel']),
           'bias': (layer.bias.grad, want_p['params']['bias']),
           'x': (xt.grad, want_dx)}
  for name, (a, b) in grads.items():
    b = np.asarray(b)
    if hybrid or name == 'bias':
      # The bias gradient is a sum over rows: its order may differ.
      tp.assert_close(a.numpy(), b, atol=1e-6 * float(np.abs(b).max()),
                      what=name)
    else:
      np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
