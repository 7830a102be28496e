"""The stability run (``multinerf_tpu_torch.stability_run``, the port of
scripts/stability_run.sh) on the CPU.

* its train and eval bindings are the script's, read from its source;
* the orchestration, with a stand-in trainer and eval
  (tests/helpers/torch_stability_child.py): the kill comes by PID once the
  checkpoint and the log line are there (SIGTERM, or SIGKILL for a child
  that ignores it), phase 2 runs the identical argv and resumes after the
  checkpoint although a stray ``.tmp`` lies beside it, and a child that
  exits before the kill fails the run;
* the port's CheckpointManager does not take a ``.tmp`` for a checkpoint;
* the log parser reads the train driver's own console line.

Every wait has a time limit of a few seconds.
"""

import argparse
import json
import os
import re
import signal
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu_torch import stability_run  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402

CHILD = os.path.join(os.path.dirname(__file__), 'helpers',
                     'torch_stability_child.py')
LIMITS = dict(timeout_s=20, poll_s=0.02, term_timeout_s=1.0)


def _script_bindings():
  """(train bindings, eval bindings) of scripts/stability_run.sh, "$CKPT"
  as '{ckpt}'."""
  with open(os.path.join(tp.REPO, 'scripts', 'stability_run.sh')) as f:
    text = f.read()
  train_part, eval_part = text.split('# Final full-test-set eval')
  train_part = train_part[train_part.index('run_train() {'):]
  train_part = train_part[:train_part.index('\n}')]
  found = lambda part: [b.replace('$CKPT', '{ckpt}') for b in re.findall(
      r'--gin_bindings="([^"]*)"', part)]
  return found(train_part), found(eval_part)


def test_bindings_are_the_scripts():
  train_bindings, eval_bindings = _script_bindings()
  assert len(train_bindings) == 15 and len(eval_bindings) == 8
  assert stability_run.TRAIN_BINDINGS == train_bindings
  assert stability_run.EVAL_BINDINGS == eval_bindings


def _child(ckpt, *flags):
  return [sys.executable, CHILD, str(ckpt), *flags]


@pytest.mark.parametrize('ignore_term', [False, True])
def test_kill_resume_and_eval(tmp_path, ignore_term):
  flags = ['--max_steps', '40', '--every', '10', '--wait_at', '14']
  if ignore_term:
    flags.append('--ignore_term')
  child = _child(tmp_path, *flags)
  phases = stability_run.run_phases(child, child + ['--eval'], str(tmp_path),
                                    kill_at=10, kill_past=14, **LIMITS)
  out = stability_run.summarize(phases, str(tmp_path), 40, 4096, 'cpu')
  assert out['ok'], out['failures']
  # Killed by its PID, by SIGKILL when it ignores SIGTERM, while waiting at
  # step 14: after checkpoint_10.pt and the line of step 14.
  one = phases['phase1']
  assert one['killed']
  assert one['returncode'] == -(signal.SIGKILL if ignore_term
                                else signal.SIGTERM)
  assert [s for s, _, _ in one['logged']] == list(range(1, 15))
  # Phase 2 ran the identical argv and resumed after checkpoint_10.pt, the
  # cut-short checkpoint_15.pt.tmp beside it.
  with open(tmp_path / 'argv.log') as f:
    argvs = [json.loads(line) for line in f]
  assert argvs == [child[1:], child[1:]]
  assert (tmp_path / 'checkpoint_15.pt.tmp').exists()
  assert out['phase2']['init_step'] == 11
  assert out['phase2']['last_logged_step'] == 40
  assert out['losses'] == {'first_logged': [1, 1.0],
                           'last_before_kill': [14, round(1 / 14, 5)],
                           'first_after_resume': [11, round(1 / 11, 5)],
                           'last': [40, 0.025]}
  assert out['final_checkpoint'] == 'checkpoint_40.pt'
  assert out['metrics'] == {'psnr': {'mean': 30.0, 'frames': 2},
                            'ssim': {'mean': pytest.approx(0.96),
                                     'frames': 2}}
  assert out['phase1']['rays_per_sec'] == 4096


def test_child_exiting_before_the_kill_fails_the_run(tmp_path, monkeypatch,
                                                     capsys):
  # The stand-in ends at step 12 and never logs step 14: it exits on its
  # own, phase 2 starts past the end, and main exits 1.  main's own
  # commands are recorded in place of being run.
  child = _child(tmp_path, '--max_steps', '12', '--every', '4')
  seen = {}
  run_phases = stability_run.run_phases

  def stand_in(train_argv, eval_argv, ckpt_dir, kill_at, kill_past):
    seen.update(train=train_argv, eval=eval_argv)
    return run_phases(child, child + ['--eval'], ckpt_dir, kill_at,
                      kill_past, **LIMITS)

  monkeypatch.setattr(stability_run, 'run_phases', stand_in)
  with pytest.raises(SystemExit) as exited:
    stability_run.main([str(tmp_path), '--gin_bindings=Config.max_steps=12',
                        '--kill_at=8', '--kill_past=14'], device='cpu')
  assert exited.value.code == 1
  with open(tmp_path / 'stability_run.json') as f:
    out = json.load(f)
  assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
  assert not out['ok'] and not out['phase1']['killed']
  assert out['failures'] == ['phase 1 exited on its own (rc 0) before the '
                             'kill', 'phase 2 started at step 13, not 9']
  assert out['final_checkpoint'] == 'checkpoint_12.pt'
  gin = f'--gin_configs={os.path.join(tp.REPO, "configs", "360.gin")}'
  for name, bindings in (('train', stability_run.TRAIN_BINDINGS),
                         ('eval', stability_run.EVAL_BINDINGS)):
    assert seen[name] == [
        sys.executable, '-m', f'multinerf_tpu_torch.{name}', gin] + [
            f'--gin_bindings={b.format(ckpt=tmp_path)}' for b in bindings] + [
                '--gin_bindings=Config.max_steps=12', '--device=cpu']


def test_stray_tmp_is_not_a_checkpoint(tmp_path):
  manager = ckpt_lib.CheckpointManager(str(tmp_path))
  saved = torch.arange(3.0)
  manager.save(10, ckpt_lib.TrainState(step=10, params={'w': saved}))
  (tmp_path / 'checkpoint_15.pt.tmp').write_bytes(b'cut short')
  assert manager.latest_step() == 10
  restored = manager.restore_latest(ckpt_lib.TrainState(
      step=0, params={'w': torch.zeros(3)}))
  assert restored.step == 10 and torch.equal(restored.params['w'], saved)


def test_log_lines_are_the_train_drivers(tmp_path):
  config = argparse.Namespace(max_steps=25000)
  line = train._console_line(
      12000, config, {'loss': 0.0123456, 'psnr': 29.5,
                      'losses/data': 0.01, 'losses/interlevel': 2e-5},
      1.5e-4, 69123.4)
  (tmp_path / 'log').write_text('Starting at step 10001.\nEval 5000: x\n' +
                                line + '\n')
  assert stability_run.read_log(tmp_path / 'log') == (
      10001, [(12000, 0.01235, 69123)])
