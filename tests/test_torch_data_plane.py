"""The port's train data paths: the dataset's producer thread, its test
split, the copy to the device one step ahead, and the device-resident
sampler, against synchronous draws and the host caster.

Tolerances: the device sampler casts rays in float32 torch where the host
casts them in float64 numpy and rounds to float32, so rays agree within
1e-6 (absolute and relative); rgb is gathered from the same float32 images,
bitwise.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import device_sampler  # noqa: E402

RAY_FIELDS = ('origins', 'directions', 'viewdirs', 'radii', 'imageplane',
              'lossmult', 'near', 'far', 'cam_idx')


def _config(*bindings):
  return tp.configs(("Config.dataset_loader = 'dummy_unbounded'",
                     'Config.batch_size = 64') + bindings)


@pytest.mark.parametrize('patch_size', [1, 2])
def test_producer_thread_draws_as_a_synchronous_loop(patch_size):
  _, config = _config(f'Config.patch_size = {patch_size}')
  with datasets.load_dataset('train', None, config, seed=11) as dataset:
    got = [next(dataset) for _ in range(6)]
    thread = dataset._thread
  thread.join(timeout=10)
  assert not thread.is_alive()
  sync = datasets.load_dataset('train', None, config, seed=11)
  for batch in got:
    want = sync._next_train()
    np.testing.assert_array_equal(batch.rgb, want.rgb)
    for key in RAY_FIELDS:
      np.testing.assert_array_equal(getattr(batch.rays, key),
                                    getattr(want.rays, key), err_msg=key)
  with pytest.raises(StopIteration):
    next(dataset)


def test_test_split_yields_whole_views_in_turn():
  jax_config, config = _config()
  jax_test = jdatasets.load_dataset('test', None, jax_config)
  with datasets.load_dataset('test', None, config) as test:
    for cam in (0, 1, 2):
      got = next(test)
      want = jax_test.generate_ray_batch(cam)
      np.testing.assert_array_equal(got.rgb, test.images[cam])
      np.testing.assert_array_equal(got.rgb, want.rgb)
      assert got.rays.origins.shape == (64, 64, 3)
      for key in RAY_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(got.rays, key)),
            np.asarray(getattr(want.rays, key)), rtol=1e-6, atol=1e-7,
            err_msg=key)


def test_producer_errors_reach_the_consumer():
  _, config = _config()
  dataset = datasets.load_dataset('train', None, config)
  dataset._next_train = lambda: 1 / 0
  with pytest.raises(ZeroDivisionError):
    next(dataset)
  dataset._thread.join(timeout=10)
  assert not dataset._thread.is_alive()


def test_prefetcher_takes_the_batches_in_order():
  _, config = _config()
  with datasets.load_dataset('train', None, config, seed=3) as dataset:
    prefetcher = train_lib.Prefetcher(dataset, 'cpu')
    firsts = [prefetcher.take()]  # Nothing staged: it stages one first.
    for _ in range(2):
      prefetcher.stage()
      firsts.append(prefetcher.take())
  sync = datasets.load_dataset('train', None, config, seed=3)
  for batch in firsts:
    host = sync._next_train()
    host = train_lib.batch_to_device(host, 'cpu')
    assert torch.equal(batch.rgb, host.rgb)
    assert torch.equal(batch.rays.origins, host.rays.origins)


@pytest.mark.parametrize('bindings', [
    (),
    ('Config.patch_size = 4', 'Config.num_border_pixels_to_mask = 3'),
    ("Config.batching = 'single_image'",)])
def test_device_sampler_matches_the_host_caster(bindings):
  _, config = _config(*bindings)
  dataset = datasets.load_dataset('train', None, config)
  plane = device_sampler.DeviceDataPlane(dataset, config, 'cpu')
  generator = torch.Generator().manual_seed(0)
  for _ in range(3):
    pix_x, pix_y, cam_idx = plane.draw(generator)
    ps = max(config.patch_size, 1)
    border = config.num_border_pixels_to_mask
    assert pix_x.shape == pix_y.shape == (64 // ps**2, ps, ps)
    assert int(pix_x.min()) >= border and int(pix_y.min()) >= border
    assert int(pix_x.max()) <= 63 - border
    assert int(pix_y.max()) <= 63 - border
    np.testing.assert_array_equal(pix_x[:, :, 1:] - pix_x[:, :, :-1], 1)
    np.testing.assert_array_equal(pix_y[:, 1:] - pix_y[:, :-1], 1)
    if config.batching == 'single_image':
      assert len(set(cam_idx.flatten().tolist())) == 1
    got = plane.make_batch(pix_x, pix_y, cam_idx)
    want = train_lib.batch_to_device(dataset._make_ray_batch(
        pix_x.numpy(), pix_y.numpy(), cam_idx.numpy()), 'cpu')
    assert torch.equal(got.rgb, want.rgb)
    for key in RAY_FIELDS:
      g, w = getattr(got.rays, key), getattr(want.rays, key)
      assert g.shape == w.shape and g.dtype == w.dtype, key
      tp.assert_close(g.numpy(), w.numpy(), atol=1e-6, rtol=1e-6, what=key)


def test_a_device_sampler_step_lowers_the_loss():
  _, config = _config('Config.randomized = False', 'Config.lr_delay_steps = 0',
                      *tp.SMALL_BINDINGS)
  dataset = datasets.load_dataset('train', None, config)
  plane = device_sampler.DeviceDataPlane(dataset, config, 'cpu')
  model, state, _, train_step, _ = train_lib.setup_model(config, train.SEED,
                                                         'cpu')
  step = device_sampler.create_device_train_step(train_step, plane)
  generator = torch.Generator().manual_seed(1)
  drawn = generator.get_state()
  state, stats = step(generator, state, 0.5, True)
  assert state.step == 1 and np.isfinite(float(stats['loss']))
  # The same batch again, after the update.
  batch = plane.sample_batch(torch.Generator().set_state(drawn))
  after = train_lib.loss_and_grads(model, config, batch, 0.5)[0]
  assert float(after) < float(stats['loss'])


def test_data_probe_times_each_path_on_the_card_only():
  from multinerf_tpu_torch import data_probe
  assert set(data_probe.PATHS) == {'sync', 'thread_start', 'thread_staged',
                                   'nothread_staged', 'device_plane'}
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='needs CUDA'):
      data_probe.main(['--steps=6', '--rounds=1'])
