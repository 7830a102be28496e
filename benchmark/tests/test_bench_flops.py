"""The yardstick's arithmetic against hand-worked numbers."""

import pytest

from benchmark.lib import flops
from benchmark.lib import harness
from benchmark.reference import model as ref_model


def _config(cell):
  return harness.Cell(cell).config['model']


def test_mipnerf360_train_step_flops():
  model = _config('mipnerf360_bf16.train')
  # Multiply-adds a sample: PropMLP 504x256 + 3 x 256x256 + 256x1; NerfMLP
  # 504x1024, six 1024x1024, the skip layer 1528x1024, density 1024x1,
  # bottleneck 1024x256, view 283x128 (256 + 27 of the encoding), rgb 128x3.
  prop = 504 * 256 + 3 * 256 * 256 + 256
  nerf = (504 * 1024 + 6 * 1024 * 1024 + 1528 * 1024 + 1024 + 1024 * 256 +
          283 * 128 + 128 * 3)
  assert (prop, nerf) == (325_888, 8_672_000)
  want = 3 * 2 * (16384 * 64 * 2 * prop + 16384 * 32 * nerf)
  got = flops.model_flops(ref_model.param_shapes(model), model, 16384, True)
  assert got == want == 31_380_373_241_856  # 31.4 TFLOP a step.


def test_refnerf_train_step_flops():
  model = _config('refnerf.train')
  # One MLP at 128 + 128 samples a ray: 96 features (the octahedron's 3
  # directions at 16 degrees), trunk 96x256, four 256x256, the skip layer
  # 352x256, two 256x256; heads density, normals, diffuse,
  # tint, roughness, bottleneck (1 + 3 + 3 + 3 + 1 + 128 columns); view
  # branch 201x128 (bottleneck 128 + IDE 72 + n.v), four 128x128, its skip
  # layer 329x128, two 128x128; rgb 128x3.
  per_sample = (96 * 256 + 4 * 256 * 256 + 352 * 256 + 2 * 256 * 256 +
                256 * 139 + 201 * 128 + 4 * 128 * 128 + 329 * 128 +
                2 * 128 * 128 + 128 * 3)
  assert per_sample == 710_016
  got = flops.model_flops(ref_model.param_shapes(model), model, 4096, True)
  assert got == 6 * 4096 * 256 * per_sample


def test_render_frame_flops_are_forward_only():
  model = _config('mipnerf360_bf16.render')
  shapes = ref_model.param_shapes(model)
  assert flops.model_flops(shapes, model, 1237 * 822, False) * 3 == (
      flops.model_flops(shapes, model, 1237 * 822, True))


def test_kernel_bounds():
  n, f, w = 524_288, 504, 1024
  # K2: 48 bytes a sample in, 4 * W out, bf16 weights in, f32 bias.
  k2_bytes = 48 * n + 4 * n * w + 2 * f * w + 4 * w
  assert k2_bytes == 2_173_685_760
  assert flops.kernel_bound_s('K2', n, f, w) == pytest.approx(
      k2_bytes / 3.35e12, rel=1e-12)  # Bytes bound it: 0.649 ms.
  assert flops.kernel_bound_s('K2', n, f, w) == pytest.approx(6.4886e-4,
                                                              rel=1e-4)
  # K1 over 1,048,576 samples of the 4 x 256 PropMLP: 2 operations a
  # multiply-add of the trunk and head, 683.4 GFLOP; operations bound it.
  n1, h = 1_048_576, 256
  ops = 2 * n1 * (f * h + 3 * h * h + h)
  assert ops == 683_436_670_976
  assert flops.kernel_bound_s('K1', n1, f, h, 4) == pytest.approx(
      ops / 989e12, rel=1e-12)  # 0.691 ms.
  # K4 reads the features' inputs and g, writes the f32 dW.
  assert flops.kernel_bound_s('K4', n, f, w) == pytest.approx(
      (48 * n + 4 * n * w + 4 * f * w) / 3.35e12, rel=1e-12)
  with pytest.raises(ValueError):
    flops.kernel_bound_s('K9', n, f, w)
