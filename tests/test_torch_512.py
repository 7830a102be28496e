"""The slice of configs/blender_512.gin and configs/llff_512.gin against the
JAX package: 672 features (16 degrees on the icosahedron basis) through
the kernels' plans and plain versions, one blender_512 train step, and the
file formats their scenes come in.

- K3's plan at 672 features fits in two K-parts of layer 0 (the sin and
  the cos half of the features, each padded to 384 columns), and 360.gin's
  stays in one; K1, K2 and K4 plan the same shapes.
- The two-part layout (w0's rows and the feats columns of the dW_0 GEMM,
  as the wrapper and csrc/density_mlp_bwd.cu lay them out) gives layer 0's
  product and dW_0 of the one-part layout, in float64 to 1e-12.
- K3's plain version at 672 features, through autograd, against JAX's
  interpreted Pallas ``_bwd_kernel``: per leaf within 2e-2 * max |want|,
  the bf16-level bound of tests/test_torch_train_ops.py.
- One blender_512.gin train step, the MLPs narrowed (PropMLP 4 x 32,
  NerfMLP 8 x 64, fewer samples) and the 672 features kept, against JAX's
  ``create_train_step(jit=False)`` by ``train_lib.leaf_gaps``, the data loss
  within 1e-3 relative (tests/test_torch_capture_slice.py's bounds).
- The blender loader with ``Config.use_tiffs`` and ``_disp.tiff``
  (compute_disp_metrics) against JAX's loader, bitwise; an llff capture
  whose ``images_N`` level is JPEG (baseline and progressive, Pillow's)
  against JAX's loader, bitwise, since the decoder gives Pillow's arrays.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import test_torch_capture_slice as slice_tests  # noqa: E402
import test_torch_datasets_capture as capture  # noqa: E402
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.ops import geopoly as jgeopoly  # noqa: E402
from multinerf_tpu.ops.pallas import density_mlp as jdm  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.ops.kernels import density_mlp as dm  # noqa: E402
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd  # noqa: E402
from multinerf_tpu_torch.ops.kernels import plans  # noqa: E402
from multinerf_tpu_torch.utils import io as io_lib  # noqa: E402

BASIS = np.array(jgeopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
F512 = 672  # 2 x 16 degrees x 21 directions.
SMS = 132  # H100 SXM.
N_PROP = 16384 * 128  # One blender_512 step's proposal samples.
N_NERF = 16384 * 32  # Its NerfMLP samples.
KERNEL_TOL = 2e-2
BLENDER_512 = os.path.join(tp.REPO, 'configs', 'blender_512.gin')
LLFF_512 = os.path.join(tp.REPO, 'configs', 'llff_512.gin')
NARROW = ('PropMLP.net_width = 32', 'NerfMLP.net_width = 64',
          'NerfMLP.bottleneck_width = 32', 'NerfMLP.net_width_viewdirs = 32',
          'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 8')


def test_k3_plans_672_features_in_two_parts():
  plan = plans.density_mlp_bwd_plan(F512, 256, 4, 21, N_PROP, SMS)
  assert (plan.parts, plan.kx, plan.kpad) == (2, 384, 768)
  # Two 64 KB operand tiles, a 4 x 16 KB ring, 12 KB of mask bits, 16 KB
  # of column sums, g, barriers, alignment: 360.gin's layout.
  assert plan.smem == 226880 <= plans.SMEM_LIMIT
  assert (plan.dw0.rows, plan.dw0.width) == (768, 256)
  assert plan.w0_rows(F512) == [(0, 0, 336), (336, 384, 336)]
  assert plan.tiles == N_PROP // plans.TILE and plan.grid == SMS
  # One part would need a [64][704] feature tile per warpgroup.
  assert plans.bwd_smem(256, 4, 704, 21) == 276032 > plans.SMEM_LIMIT
  with pytest.raises(ValueError, match='shared memory'):
    plans.density_mlp_bwd_plan(F512, 256, 4, 21, N_PROP, SMS, parts=1)
  # 360.gin keeps its one-part layout.
  k3 = plans.density_mlp_bwd_plan(504, 256, 4, 21, 4096 * 64, SMS)
  assert (k3.parts, k3.kx, k3.kpad, k3.smem) == (1, 512, 512, 226880)
  # Narrower trunks fit either layout: the chip check holds the two
  # against each other bitwise at width 128.
  for parts in (1, 2):
    p = plans.density_mlp_bwd_plan(F512, 128, 4, 21, 300, SMS, parts=parts)
    assert p.parts == parts and p.smem <= plans.SMEM_LIMIT
  with pytest.raises(ValueError, match='shared memory'):
    plans.density_mlp_bwd_plan(2000, 256, 4, 21, 100, SMS)


def test_forward_and_dw_plans_at_the_512_shapes():
  k1 = plans.density_mlp_fwd_plan(F512, 256, 21, N_PROP, SMS // 2)
  assert (k1.kpad, k1.stages) == (704, 2) and k1.smem <= plans.SMEM_LIMIT
  k2 = plans.featurize_dense_fwd_plan(F512, 512, 21, N_NERF, SMS // 2)
  assert (k2.width, k2.col_slabs, k2.stages, k2.staged) == (256, 2, 2, False)
  k4 = plans.featurize_dense_dw_plan(F512, 512, 21, N_NERF, SMS)
  assert k4.kpad == 704 and k4.smem <= plans.SMEM_LIMIT
  assert k4.gemm.grid[0] * k4.gemm.grid[1] * k4.gemm.grid[2] <= SMS


def test_two_part_layout_is_the_one_part_product():
  rng = np.random.RandomState(0)
  width, n = 64, 50
  plan = plans.density_mlp_bwd_plan(F512, width, 4, 21, n, SMS, parts=2)
  w0 = torch.tensor(rng.randn(F512, width).astype(np.float32))
  ws = [w0] + [torch.zeros(width, width) for _ in range(3)]
  bs = [torch.zeros(width) for _ in range(4)]
  w0_parts, _, _ = dm._trunk_operands(ws, bs, plan.kpad,
                                      plan.w0_rows(F512))
  feats = torch.tensor(rng.randn(n, F512).astype(np.float32)).to(
      torch.bfloat16)
  # The feats scratch as the kernel stores it: part p in columns p * kx ..
  parts = torch.zeros((n, plan.kpad), dtype=torch.bfloat16)
  for f0, r0, count in plan.w0_rows(F512):
    parts[:, r0:r0 + count] = feats[:, f0:f0 + count]
  want = feats.double() @ w0.to(torch.bfloat16).double()
  got = parts.double() @ w0_parts.double()
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
  da = torch.tensor(rng.randn(n, width))
  dw_parts = parts.double().T @ da
  rows = torch.cat([dw_parts[r0:r0 + c] for _, r0, c in plan.w0_rows(F512)])
  np.testing.assert_allclose(rows.numpy(), (feats.double().T @ da).numpy(),
                             rtol=0, atol=1e-12)


@pytest.mark.parametrize('use_contract', [False, True])
def test_k3_plain_at_672_features_matches_the_pallas_bwd_kernel(
    use_contract):
  n, width = 600, 32
  means, covs = tp.gaussians(n, seed=3, far_frac=0.1 if use_contract else 0)
  rng = np.random.RandomState(3)
  ws, bs, c_in = [], [], F512
  for _ in range(3):
    ws.append((rng.randn(c_in, width) * np.sqrt(2 / c_in)).astype(np.float32))
    bs.append((rng.randn(width) * 0.1).astype(np.float32))
    c_in = width
  wd = (rng.randn(width, 1) / np.sqrt(width)).astype(np.float32)
  bd, g = np.float32(0.1), rng.randn(n).astype(np.float32)

  def jax_fn(ws_, bs_, wd_, bd_):
    return jdm.density_mlp(jnp.asarray(means), jnp.asarray(covs), ws_, bs_,
                           wd_, bd_, BASIS, max_deg=16,
                           use_contract=use_contract, interpret=True)
  _, vjp = jax.vjp(jax_fn, [jnp.asarray(w) for w in ws],
                   [jnp.asarray(b) for b in bs], jnp.asarray(wd),
                   jnp.asarray(bd))
  want = vjp(jnp.asarray(g))
  leaves = [torch.tensor(x, requires_grad=True)
            for x in (*ws, *bs, wd, np.asarray(bd))]
  dm.reset_counts()
  out = dm.density_mlp(torch.tensor(means), torch.tensor(covs), leaves[:3],
                       leaves[3:6], leaves[6], leaves[7], BASIS, max_deg=16,
                       use_contract=use_contract)
  out.backward(torch.as_tensor(g))
  assert dm.bwd_counts == {'launches': 0, 'plain_calls': 1}
  names = ['dW0', 'dW1', 'dW2', 'db0', 'db1', 'db2', 'dwd', 'dbd']
  for name, leaf, w in zip(names, leaves,
                           [*want[0], *want[1], want[2], want[3]]):
    w = np.asarray(w)
    assert leaf.grad.shape == w.shape, name
    err = np.abs(leaf.grad.numpy() - w).max()
    assert err <= KERNEL_TOL * np.abs(w).max(), (name, err)
  assert ws[0].shape == (F512, width)
  assert fd.plain_features(torch.tensor(means), torch.tensor(covs), BASIS, 0,
                           16, use_contract).shape == (n, F512)


def _srgb_u8(img):
  return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_blender(root, views=3, size=(12, 16), seed=0):
  """A Blender-layout scene: transforms_{train,val,test}.json, RGBA PNGs
  over a transparent background, the same views as linear _R/_G/_B/_A.tiff
  channels and a _disp.tiff, by the port's own writers."""
  rng = np.random.RandomState(seed)
  h, w = size
  for split in ('train', 'val', 'test'):
    frames = []
    os.makedirs(os.path.join(root, split), exist_ok=True)
    for i in range(views):
      name = f'{split}/r_{i}'
      rgba = rng.rand(h, w, 4).astype(np.float32)
      rgba[..., 3] = np.where(rng.rand(h, w) < 0.3, 0.0, rgba[..., 3])
      prefix = os.path.join(root, name)
      Image.fromarray(_srgb_u8(rgba), 'RGBA').save(prefix + '.png')
      for c, ch in enumerate('RGBA'):
        io_lib.save_img_f32(rgba[..., c] ** 2.2 if ch != 'A' else
                            rgba[..., c], f'{prefix}_{ch}.tiff')
      io_lib.save_img_f32(0.1 + rng.rand(h, w).astype(np.float32),
                          prefix + '_disp.tiff')
      theta = 0.9 * i + (0.4 if split != 'train' else 0.0)
      pose = np.eye(4)
      pose[:3, 3] = [4 * np.cos(theta), 4 * np.sin(theta), 1.0]
      frames.append({'file_path': './' + name,
                     'transform_matrix': pose.tolist()})
    with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
      json.dump({'camera_angle_x': 0.69, 'frames': frames}, f)


@pytest.mark.parametrize('use_tiffs', [False, True])
def test_blender_loader_tiffs_and_disparities_match_jax(tmp_path, use_tiffs):
  write_blender(str(tmp_path))
  bindings = (f"Config.data_dir = '{tmp_path}'",
              f'Config.use_tiffs = {use_tiffs}',
              'Config.compute_disp_metrics = True', 'Config.batch_size = 64')
  jax_config, torch_config = tp.configs(bindings, files=(BLENDER_512,))
  for split in ('train', 'test'):
    got = datasets.load_dataset(split, str(tmp_path), torch_config)
    want = jdatasets.load_dataset(split, str(tmp_path), jax_config)
    for key in ('images', 'disp_images', 'camtoworlds', 'pixtocams'):
      g, w = getattr(got, key), np.asarray(getattr(want, key))
      assert g.dtype == w.dtype, key
      np.testing.assert_array_equal(g, w, err_msg=key)
    assert got.disp_images.shape == (3, 12, 16)
    got.close()


@pytest.mark.parametrize('progressive', [False, True])
def test_llff_capture_with_a_jpeg_level_matches_jax(tmp_path, progressive):
  n = 8
  capture.write_capture(str(tmp_path), capture.forward_poses(n),
                        model_id=1, params=capture.OPENCV[:4],
                        originals='png', width=64, height=48)
  level = tmp_path / 'images_2'
  for name in sorted(os.listdir(level)):
    png = level / name
    img = np.asarray(Image.open(png))
    Image.fromarray(img).save(png.with_suffix('.jpg'), 'JPEG', quality=90,
                              progressive=progressive)
    png.unlink()
  bounds = np.stack([np.linspace(0.9, 1.3, n), np.linspace(6, 9, n)], -1)
  np.save(tmp_path / 'poses_bounds.npy',
          np.concatenate([np.zeros((n, 15)), bounds], -1))
  got = capture.assert_loaders_match('train', str(tmp_path),
                                     ('Config.factor = 2',),
                                     files=(LLFF_512,))
  assert got.images.shape == (7, 24, 32, 3)
  jpeg_first = np.asarray(Image.open(level / 'IMG_0000.jpg')) / 255.0
  assert jpeg_first.shape == (24, 32, 3)


def test_blender_512_step_matches_jax(tmp_path):
  write_blender(str(tmp_path), views=2, size=(16, 16), seed=1)
  jax_config, torch_config = tp.configs(
      NARROW + tp.FUSED_BINDINGS + (
          f"Config.data_dir = '{tmp_path}'", 'Config.batch_size = 64',
          'Config.randomized = False'), files=(BLENDER_512,))
  assert torch_config.batching == 'single_image'
  params = tp.jax_params(jax_config, seed=7)
  assert params['PropMLP_0']['Dense_0']['kernel'].shape == (F512, 32)
  assert params['NerfMLP_0']['Dense_0']['kernel'].shape == (F512, 64)
  with datasets.load_dataset('train', torch_config.data_dir, torch_config,
                             seed=3) as dataset:
    batch = train_lib.batch_to_device(next(dataset), 'cpu')
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients

  def run(state, b):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), state, b, 0.5, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats, captured['grad']

  run = jax.jit(run)
  want = [jax.device_get(run(jstate, slice_tests._jax_batch(b)))
          for b in (batch, train_lib.nudge_origins(batch))]
  model, _, _, _, _ = train_lib.setup_model(torch_config, 0, 'cpu')
  bridge.load_jax_params(model, params)
  dm.reset_counts()
  _, losses, _, grads = train_lib.loss_and_grads(model, torch_config, batch,
                                                 0.5)
  assert dm.counts['plain_calls'] == 1 and dm.bwd_counts['plain_calls'] == 1
  want_data = float(want[0][0]['losses']['data'])
  assert abs(float(losses['data']) - want_data) <= 1e-3 * abs(want_data)
  gaps = train_lib.leaf_gaps({k: v.numpy() for k, v in grads.items()},
                             bridge.flatten(want[0][1]),
                             bridge.flatten(want[1][1]))
  assert len(gaps) == len(grads)
  for name, (gap, sens, bound) in gaps.items():
    assert gap <= bound, (f'{name}: relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')
