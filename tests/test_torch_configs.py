"""The port's gin parser and Config against the JAX package's: every
configs/*.gin file parses to the same bindings, and the Config and MLP/Model
field sets and defaults agree."""

import dataclasses
import glob
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import configs as jax_configs  # noqa: E402
from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu.models import mlp as jax_mlp  # noqa: E402
from multinerf_tpu.models import nerf as jax_nerf  # noqa: E402
from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import ginlite  # noqa: E402
from multinerf_tpu_torch.models import mlp  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

GIN_FILES = sorted(glob.glob(os.path.join(tp.REPO, 'configs', '*.gin')))


def _comparable(value):
  """Callables compare by name: @jnp.reciprocal is torch.reciprocal here."""
  return getattr(value, '__name__', value) if callable(value) else value


@pytest.mark.parametrize('path', GIN_FILES,
                         ids=[os.path.basename(p) for p in GIN_FILES])
def test_every_gin_file_parses_to_the_same_bindings(path):
  tp.configs(files=(path,))
  for target in ('Config', 'Model', 'NerfMLP', 'PropMLP'):
    want = {k: _comparable(v)
            for k, v in jax_gin.get_bindings(target).items()}
    got = {k: _comparable(v) for k, v in ginlite.get_bindings(target).items()}
    assert got == want, target
  assert ginlite.unknown_bindings() == jax_gin.unknown_bindings()


@pytest.mark.parametrize('ours,theirs', [
    (configs.Config, jax_configs.Config),
    (mlp.MLPConfig, jax_mlp.MLP),
    (nerf.ModelConfig, jax_nerf.Model),
], ids=['Config', 'MLP', 'Model'])
def test_field_sets_and_defaults_match(ours, theirs):
  skip = {'parent', 'name'}  # flax.linen.Module's own fields.

  def defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
      if f.name in skip:
        continue
      if f.default is not dataclasses.MISSING:
        out[f.name] = _comparable(f.default)
      else:
        out[f.name] = f.default_factory()
    return out

  assert defaults(ours) == defaults(theirs)
