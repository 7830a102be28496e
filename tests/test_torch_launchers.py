"""The launchers scripts/{train,eval,render}_*.sh against the port's entry
points: each launcher's ``python -m {train,eval,render}`` arguments
(``--gin_configs``, ``--gin_bindings``, ``--logtostderr``), as bash expands
them with DATA_DIR and SCENE set, go through the matching entry point's
parser (``multinerf_tpu_torch.{train,eval,render}.parse_flags``) and
``configs.load_config``.  The Config must be the launcher's gin file with
the launcher's Config bindings on top.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import eval as eval_lib  # noqa: E402
from multinerf_tpu_torch import render  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402

ENTRY_POINTS = {'train': train, 'eval': eval_lib, 'render': render}
GINS = {'360': '360.gin', 'blender': 'blender_256.gin',
        'llff': 'llff_256.gin', 'raw': 'llff_raw.gin',
        'shinyblender': 'blender_refnerf.gin'}
LAUNCHERS = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(
        tp.REPO, 'scripts', '*.sh'))
    if os.path.basename(p).split('_')[0] in ENTRY_POINTS)


def _launcher_argv(name):
  """The arguments the launcher passes to ``python``, from bash itself:
  the script is sourced with ``python`` defined as a shell function that
  prints them."""
  code = 'python() { printf "%s\\0" "$@"; }; source "$1"'
  proc = subprocess.run(
      ['bash', '-c', code, 'bash', os.path.join('scripts', name)],
      cwd=tp.REPO, env=dict(os.environ, DATA_DIR='/data', SCENE='garden'),
      capture_output=True, check=True, timeout=30)
  return [a.decode() for a in proc.stdout.split(b'\0')[:-1]]


def test_there_are_thirteen_launchers():
  assert len(LAUNCHERS) == 13, LAUNCHERS


@pytest.mark.parametrize('name', LAUNCHERS)
def test_launcher_line_parses_through_the_port(name):
  kind, experiment = name[:-len('.sh')].split('_', 1)
  argv = _launcher_argv(name)
  assert argv[:2] == ['-m', kind]
  args = ENTRY_POINTS[kind].parse_flags(argv[2:])
  assert args.logtostderr and args.device == 'cuda'
  assert args.gin_configs == [f'configs/{GINS[experiment]}']
  config = configs.load_config(args)
  # The gin file alone, then the launcher's Config bindings.
  gin_only = configs.load_config(ENTRY_POINTS[kind].parse_flags(
      [f'--gin_configs=configs/{GINS[experiment]}']))
  ckpt = f'results/{experiment}/garden'
  want = dict(data_dir='/data/garden', checkpoint_dir=ckpt)
  if kind == 'render':
    want.update(render_dir=f'{ckpt}/render/', render_path=True,
                render_path_frames=480, render_video_fps=60)
  assert config == dataclasses.replace(gin_only, **want)
  assert config.dataset_loader == gin_only.dataset_loader
