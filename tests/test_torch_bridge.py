"""The parameter bridge: every leaf of the JAX model's tree lands bitwise in
the port under the same name and shape, and comes back unchanged."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402


def _models(bindings=(), shapes_only=False):
  """The JAX 'params' tree and the port's Model of configs/360.gin."""
  jax_config, torch_config = tp.configs(bindings)
  params = tp.jax_params(jax_config, shapes_only=shapes_only)
  model = nerf.construct_model(torch_config, torch.Generator().manual_seed(0),
                               'cpu')
  return params, model


def test_full_width_tree_has_the_flax_names_and_shapes():
  params, model = _models(shapes_only=True)
  want = {k: tuple(v.shape) for k, v in bridge.flatten(params).items()}
  got = {k: tuple(v.shape)
         for k, v in bridge.named_parameters(model).items()}
  assert got == want
  # The 360 config at full width, as the JAX package names it.
  assert got['PropMLP_0/Dense_0/kernel'] == (504, 256)
  assert got['PropMLP_0/Dense_4/kernel'] == (256, 1)
  assert got['NerfMLP_0/Dense_5/kernel'] == (1528, 1024)
  assert got['NerfMLP_0/Dense_8/kernel'] == (1024, 1)
  assert got['NerfMLP_0/Dense_9/kernel'] == (1024, 256)
  assert got['NerfMLP_0/Dense_10/kernel'] == (283, 128)
  assert got['NerfMLP_0/Dense_11/kernel'] == (128, 3)
  assert len(got) == 2 * (5 + 12)


def test_every_leaf_lands_bitwise_and_round_trips():
  params, model = _models(tp.SMALL_BINDINGS)
  bridge.load_jax_params(model, params)
  flat = bridge.flatten(params)
  named = bridge.named_parameters(model)
  for name, want in flat.items():
    got, want = named[name].detach().numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
  back = bridge.flatten(bridge.jax_params(model))
  assert sorted(back) == sorted(flat)
  for name, want in flat.items():
    np.testing.assert_array_equal(back[name], want, err_msg=name)


def test_checkpoint_restore_latest_contract(tmp_path):
  params, model = _models(tp.SMALL_BINDINGS)
  state = checkpoints.TrainState(step=0,
                                 params=bridge.named_parameters(model))
  mngr = checkpoints.CheckpointManager(str(tmp_path), keep=2)
  # No checkpoint: the state comes back unchanged.
  assert mngr.latest_step() is None
  assert mngr.restore_latest(state) is state
  flat = {k: torch.tensor(np.asarray(v))
          for k, v in bridge.flatten(params).items()}
  for step in (3, 11, 7):
    mngr.save(step, checkpoints.TrainState(step=step, params=flat))
  assert mngr.latest_step() == 11
  assert sorted(os.listdir(tmp_path)) == ['checkpoint_11.pt',
                                          'checkpoint_7.pt']
  restored = mngr.restore_latest(state)
  assert restored.step == 11
  bridge.load_flat(model, restored.params)
  for name, want in bridge.flatten(params).items():
    np.testing.assert_array_equal(
        bridge.named_parameters(model)[name].detach().numpy(), want,
        err_msg=name)
