"""What the benchmark takes from the program (``multinerf_tpu_torch``): its
configuration from the gin files and bindings a configuration file names,
its model, train step and renderer, its data plane, and its kernels'
launch counters.  Nothing here imports the JAX package.
"""

from __future__ import annotations

import argparse

import torch

# The hand-written kernels' launch counters: (module, attribute, name).
COUNTERS = (('density_mlp', 'counts', 'K1'), ('featurize_dense', 'counts',
                                                'K2'),
            ('density_mlp', 'bwd_counts', 'K3'),
            ('featurize_dense', 'bwd_counts', 'K4'),
            ('int8_trunk', 'counts', 'K5'), ('int8_trunk', 'bwd_counts', 'K6'))


def load_config(config_file, bindings=()):
  """The program's Config from a configuration file's gin files and
  bindings, then `bindings` (the cell's own)."""
  from multinerf_tpu_torch import configs
  args = argparse.Namespace(
      gin_configs=list(config_file['gin_configs']),
      gin_bindings=list(config_file['gin_bindings']) + list(bindings))
  return configs.load_config(args)


def setup_device(kind):
  """The program's device set-up (TF32 off, the process group when
  launched by torch.distributed.run)."""
  from multinerf_tpu_torch import configs
  return configs.setup_device(kind)


def named_parameters(model):
  from multinerf_tpu_torch import bridge
  return bridge.named_parameters(model)


def load_weights(model, weights):
  """Copy the benchmark's weights {flax name: tensor} into the program's
  model, whose leaves must be exactly these."""
  params = named_parameters(model)
  if set(params) != set(weights):
    raise ValueError('the model has other leaves than the reference: '
                     f'{sorted(set(params) ^ set(weights))}')
  with torch.no_grad():
    for name, p in params.items():
      if tuple(p.shape) != tuple(weights[name].shape):
        raise ValueError(f'{name}: {tuple(p.shape)} vs '
                         f'{tuple(weights[name].shape)}')
      p.copy_(weights[name])


def check_model(model, model_cfg):
  """The program's model configured as the reference's description says:
  every field the description gives, compared with the program's."""
  mismatches = []
  for field in ('num_levels', 'num_prop_samples', 'num_nerf_samples',
                'anneal_slope', 'single_jitter', 'dilation_multiplier',
                'dilation_bias', 'single_mlp', 'resample_padding',
                'opaque_background'):
    if getattr(model.cfg, field) != model_cfg[field]:
      mismatches.append(field)
  if tuple(model.cfg.bg_intensity_range) != (1.0, 1.0):
    mismatches.append('bg_intensity_range')
  raydist = model.cfg.raydist_fn
  if (None if raydist is None else raydist.__name__) != model_cfg.get(
      'raydist_fn'):
    mismatches.append('raydist_fn')
  mlps = [(model.NerfMLP_0, model_cfg['nerf_mlp'])]
  if not model_cfg['single_mlp']:
    mlps.append((model.PropMLP_0, model_cfg['prop_mlp']))
  for mlp, want in mlps:
    for field, value in want.items():
      if field == 'fused_numerics':
        got = mlp.fused  # The featurize -> Dense kernels take this MLP.
      else:
        got = getattr(mlp.cfg, 'warp_fn' if field == 'warp' else field)
      if field == 'warp':
        got = None if got is None else got.__name__
      if got != value:
        mismatches.append(f'{field}: {got!r} != {value!r}')
  if mismatches:
    raise ValueError(f'program and reference differ: {mismatches}')


def launch_counts():
  """{kernel: [launches, plain calls]} since the last reset."""
  import importlib
  out = {}
  for module, attr, name in COUNTERS:
    mod = importlib.import_module(f'multinerf_tpu_torch.ops.kernels.{module}')
    c = getattr(mod, attr)
    out[name] = [c['launches'], c['plain_calls']]
  return out


def reset_counts():
  import importlib
  for module in ('density_mlp', 'featurize_dense', 'int8_trunk'):
    importlib.import_module(
        f'multinerf_tpu_torch.ops.kernels.{module}').reset_counts()
