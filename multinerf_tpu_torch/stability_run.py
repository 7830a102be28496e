"""The long-horizon stability run with a kill and a resume (port of
scripts/stability_run.sh).

One 25,000-step 360.gin training run of ``python -m
multinerf_tpu_torch.train`` with the script's bindings: ``dummy_unbounded``,
the device plane in windows of 50 with the culling protocol (warmup,
refresh, the capacity ladder's gate) inside them, the bf16 trunk, in-train
renders every 5,000 steps.  Phase 1 runs it in a child process and kills
that child (by its PID: SIGTERM, then SIGKILL if it has not exited within
TERM_TIMEOUT_S) once ``checkpoint_<kill_at>.pt`` exists and its log shows
a step of at least `kill_past`; phase 2 runs the identical command, which
must resume at ``kill_at + 1``; then ``python -m multinerf_tpu_torch.eval``
scores the last checkpoint with the script's eval bindings.  A checkpoint
is written through a ``.tmp`` file and ``os.replace``, so a kill during a
save leaves the checkpoints before it whole, and the stray ``.tmp`` is
not a checkpoint to the resume.

Usage (on the card):

    python -m multinerf_tpu_torch.stability_run CKPT_DIR \\
        [--gin_bindings=...] [--kill_at=10000] [--kill_past=12000]

Extra ``--gin_bindings`` go after the script's own, in the train and the
eval commands (a short run for a smoke test).  The logs
(``train_phase1.log``, ``train_phase2.log``, ``eval_final.log``) and
``stability_run.json`` are written to CKPT_DIR; the JSON is also printed
as the last line.  It exits non-zero when phase 1 exited before the kill,
phase 2 started anywhere but ``kill_at + 1``, the last checkpoint is
missing or eval wrote no metric.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/stability_run.sh:26-42 and :64-73, '{ckpt}' for "$CKPT".
TRAIN_BINDINGS = [
    "Config.dataset_loader='dummy_unbounded'",
    "Config.data_dir=''",
    "Config.checkpoint_dir='{ckpt}'",
    'Config.max_steps=25000',
    'Config.batch_size=4096',
    'Config.print_every=500',
    'Config.checkpoint_every=5000',
    'Config.train_render_every=5000',
    'Config.device_data_plane=True',
    'Config.steps_per_jit_call=50',
    'Config.occupancy_culling=True',
    'Config.occupancy_capacity_ladder=(0.33,0.5,0.67)',
    'Config.occupancy_warmup_steps=1000',
    "NerfMLP.trunk_dtype='bfloat16'",
    "PropMLP.trunk_dtype='bfloat16'",
]
EVAL_BINDINGS = [
    "Config.dataset_loader='dummy_unbounded'",
    "Config.data_dir=''",
    "Config.checkpoint_dir='{ckpt}'",
    'Config.max_steps=25000',
    'Config.batch_size=4096',
    'Config.eval_only_once=True',
    "NerfMLP.trunk_dtype='bfloat16'",
    "PropMLP.trunk_dtype='bfloat16'",
]
KILL_AT = 10000
KILL_PAST = 12000
POLL_S = 1.0  # How often phase 1's checkpoint and log are looked at.
TERM_TIMEOUT_S = 60.0  # From SIGTERM to SIGKILL.
# train.main's console line (train.py:411) and its start line.
STEP_LINE = re.compile(r'^\s*(\d+)/(\d+): loss=([-\d.e+]+),.*, (\d+) r/s$')
START_LINE = re.compile(r'^Starting at step (\d+)\.$')
NOTES = [
    'Phase 2 resumes at kill_at + 1, so its windows start there.',
    'After the resume the gate has no rung until its first grid refresh '
    "(JAX's train.py:159 starts from cull_cap None as well).",
]


def read_log(path):
  """(the step the run started at or None, [(step, loss, rays/s)] of its
  console lines)."""
  start, lines = None, []
  with open(path, errors='replace') as f:
    for line in f:
      line = line.rstrip('\n')
      m = START_LINE.match(line)
      if m:
        start = int(m.group(1))
      m = STEP_LINE.match(line)
      if m:
        lines.append((int(m.group(1)), float(m.group(3)), int(m.group(4))))
  return start, lines


def _stop(proc, term_timeout_s):
  """SIGTERM `proc`, then SIGKILL it if it has not exited in time."""
  proc.terminate()
  try:
    proc.wait(timeout=term_timeout_s)
  except subprocess.TimeoutExpired:
    proc.kill()
    proc.wait(timeout=term_timeout_s)


def _start(argv, log_path):
  with open(log_path, 'w') as log:
    return subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


def run_phases(train_argv, eval_argv, ckpt_dir, kill_at, kill_past,
               timeout_s=None, poll_s=POLL_S, term_timeout_s=TERM_TIMEOUT_S):
  """Phase 1 (`train_argv`, killed by PID once ``checkpoint_<kill_at>.pt``
  exists and its log shows a step >= `kill_past`), phase 2 (the same
  argv) and eval (`eval_argv`), each logged to `ckpt_dir`.  Every wait is
  bounded by `timeout_s` (None: none); a child still running at it is
  stopped and the run fails.  Returns {'phase1': ..., 'phase2': ...,
  'eval_rc': ..., 'failures': [reasons]}."""
  failures = []
  logs = {k: os.path.join(ckpt_dir, f'{k}.log')
          for k in ('train_phase1', 'train_phase2', 'eval_final')}
  ckpt = os.path.join(ckpt_dir, f'checkpoint_{kill_at}.pt')
  deadline = None if timeout_s is None else time.monotonic() + timeout_s

  t0 = time.monotonic()
  proc = _start(train_argv, logs['train_phase1'])
  killed = False
  while proc.poll() is None:
    if deadline is not None and time.monotonic() > deadline:
      _stop(proc, term_timeout_s)
      failures.append(f'phase 1 reached no kill point in {timeout_s} s')
      break
    if os.path.exists(ckpt):
      _, lines = read_log(logs['train_phase1'])
      if lines and max(s for s, _, _ in lines) >= kill_past:
        _stop(proc, term_timeout_s)
        killed = True
        break
    time.sleep(poll_s)
  phase1 = {'seconds': time.monotonic() - t0, 'killed': killed,
            'returncode': proc.returncode}
  if not killed and not failures:
    failures.append(f'phase 1 exited on its own (rc {proc.returncode}) '
                    'before the kill')

  t0 = time.monotonic()
  proc = _start(train_argv, logs['train_phase2'])
  try:
    proc.wait(timeout=None if deadline is None else
              max(deadline - time.monotonic(), 0))
  except subprocess.TimeoutExpired:
    _stop(proc, term_timeout_s)
    failures.append(f'phase 2 did not end in {timeout_s} s')
  phase2 = {'seconds': time.monotonic() - t0, 'returncode': proc.returncode}
  if proc.returncode:
    failures.append(f'phase 2 exited with rc {proc.returncode}')

  proc = _start(eval_argv, logs['eval_final'])
  try:
    eval_rc = proc.wait(timeout=None if deadline is None else
                        max(deadline - time.monotonic(), 0))
  except subprocess.TimeoutExpired:
    _stop(proc, term_timeout_s)
    eval_rc = proc.returncode
    failures.append(f'eval did not end in {timeout_s} s')

  for name, phase in (('phase1', phase1), ('phase2', phase2)):
    phase['init_step'], lines = read_log(logs[f'train_{name}'])
    phase['logged'] = [list(x) for x in lines]
  if phase2['init_step'] != kill_at + 1:
    failures.append(f'phase 2 started at step {phase2["init_step"]}, not '
                    f'{kill_at + 1}')
  return {'phase1': phase1, 'phase2': phase2, 'eval_rc': eval_rc,
          'failures': failures}


def summarize(phases, ckpt_dir, final_step, batch_size, device_line):
  """The run's JSON record from `run_phases`' result and the files in
  `ckpt_dir`; its 'failures' grow by a missing last checkpoint or
  metric."""
  failures = list(phases['failures'])
  out = {'device': device_line, 'notes': NOTES}
  for name in ('phase1', 'phase2'):
    phase = phases[name]
    logged = phase['logged']
    steps = [s for s, _, _ in logged]
    out[name] = {
        'init_step': phase['init_step'],
        'last_logged_step': max(steps) if steps else None,
        'seconds': phase['seconds'], 'returncode': phase['returncode'],
        # Each console line's rate: the steps since the line before it.
        'rays_per_sec': float(np.median([r for _, _, r in logged]))
                        if logged else None,
        'rays_per_sec_logged': [[s, r] for s, _, r in logged],
    }
    if name == 'phase1':
      out[name]['killed'] = phase['killed']
  one, two = phases['phase1']['logged'], phases['phase2']['logged']
  out['losses'] = {
      # [step, mean loss of the steps since the line before] of the console.
      'first_logged': one[0][:2] if one else None,
      'last_before_kill': one[-1][:2] if one else None,
      'first_after_resume': two[0][:2] if two else None,
      'last': two[-1][:2] if two else None,
  }
  # The last checkpoint's file name in `ckpt_dir`, None when it is missing.
  last_ckpt = f'checkpoint_{final_step}.pt'
  out['final_checkpoint'] = (
      last_ckpt if os.path.exists(os.path.join(ckpt_dir, last_ckpt)) else None)
  if out['final_checkpoint'] is None:
    failures.append(f'no {last_ckpt}')
  out['eval_rc'] = phases['eval_rc']
  out['metrics'] = {}
  for name in ('psnr', 'ssim'):
    path = os.path.join(ckpt_dir, 'test_preds',
                        f'metric_{name}_{final_step}.txt')
    if not os.path.exists(path):
      failures.append(f'eval wrote no metric_{name}_{final_step}.txt')
      continue
    with open(path) as f:
      values = [float(v) for v in f.read().split()]
    out['metrics'][name] = {'mean': float(np.mean(values)),
                            'frames': len(values)}
  out['batch_size'] = batch_size
  out['failures'] = failures
  out['ok'] = not failures
  return out


def main(argv=None, device='cuda'):
  """Run the three phases; returns the JSON record (also written to
  CKPT_DIR/stability_run.json and printed)."""
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('checkpoint_dir')
  p.add_argument('--gin_bindings', action='append', default=[],
                 help='Bindings after the script\'s own, in the train and '
                 'eval commands.')
  p.add_argument('--kill_at', type=int, default=KILL_AT)
  p.add_argument('--kill_past', type=int, default=KILL_PAST)
  args = p.parse_args(argv)
  ckpt_dir = os.path.abspath(args.checkpoint_dir)
  os.makedirs(ckpt_dir, exist_ok=True)

  def command(module, bindings):
    bindings = [b.format(ckpt=ckpt_dir) for b in bindings]
    bindings += args.gin_bindings
    return ([sys.executable, '-m', f'multinerf_tpu_torch.{module}',
             f'--gin_configs={harness.CONFIG_360}'] +
            [f'--gin_bindings={b}' for b in bindings] + [f'--device={device}'])

  train_argv = command('train', TRAIN_BINDINGS)
  config = configs.load_config(configs.parse_entry_flags('', train_argv[3:]))
  phases = run_phases(train_argv, command('eval', EVAL_BINDINGS), ckpt_dir,
                      args.kill_at, args.kill_past)
  out = summarize(phases, ckpt_dir, config.max_steps, config.batch_size,
                  harness.device_name(device))
  out.update(kill_at=args.kill_at, kill_past=args.kill_past,
             extra_bindings=args.gin_bindings)
  with open(os.path.join(ckpt_dir, 'stability_run.json'), 'w') as f:
    json.dump(out, f, indent=1)
  print(json.dumps(out))
  if not out['ok']:
    sys.exit(1)
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
