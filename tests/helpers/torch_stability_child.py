"""A stand-in for the train and eval entry points in the stability run's
tests (tests/test_torch_stability_run.py): plain Python, so each start
takes a fraction of a second.

As the trainer it appends its argv to ``argv.log`` in the checkpoint
directory, starts after the newest ``checkpoint_<N>.pt`` there (the
``checkpoint_*.pt`` names the port's CheckpointManager lists; a ``.tmp``
is not one), prints the train driver's start line and console lines, and
writes ``checkpoint_<N>.pt`` every ``--every`` steps.  A run that started
at step 1 writes a stray ``checkpoint_<N>.pt.tmp`` once it passes
``--wait_at`` (a save cut short) and then waits up to ``--wait_s`` seconds
to be killed, optionally ignoring SIGTERM.  As eval (``--eval``) it writes
the metric files of ``--max_steps`` under test_preds/.
"""

import argparse
import glob
import json
import os
import re
import signal
import sys
import time


def main():
  p = argparse.ArgumentParser()
  p.add_argument('ckpt_dir')
  p.add_argument('--max_steps', type=int, default=40)
  p.add_argument('--every', type=int, default=10)
  p.add_argument('--wait_at', type=int, default=14)
  p.add_argument('--wait_s', type=float, default=10.0)
  p.add_argument('--ignore_term', action='store_true')
  p.add_argument('--eval', action='store_true')
  args = p.parse_args()
  if args.eval:
    out = os.path.join(args.ckpt_dir, 'test_preds')
    os.makedirs(out, exist_ok=True)
    for name, value in (('psnr', '30.5 29.5'), ('ssim', '0.95 0.97')):
      with open(os.path.join(out, f'metric_{name}_{args.max_steps}.txt'),
                'w') as f:
        f.write(value)
    return
  if args.ignore_term:
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
  with open(os.path.join(args.ckpt_dir, 'argv.log'), 'a') as f:
    f.write(json.dumps(sys.argv) + '\n')
  steps = [int(m.group(1)) for m in (
      re.fullmatch(r'checkpoint_(\d+)\.pt', os.path.basename(path))
      for path in glob.glob(os.path.join(args.ckpt_dir, 'checkpoint_*.pt')))
           if m]
  init_step = max(steps, default=0) + 1
  print(f'Starting at step {init_step}.', flush=True)
  for step in range(init_step, args.max_steps + 1):
    time.sleep(0.005)
    print(f'{step:3d}/{args.max_steps}: loss={1 / step:0.5f}, psnr=10.000, '
          'lr=1.00e-03 | data=0.10000, 4096 r/s', flush=True)
    if step % args.every == 0:
      with open(os.path.join(args.ckpt_dir, f'checkpoint_{step}.pt'),
                'w') as f:
        f.write(str(step))
    if init_step == 1 and step == args.wait_at:
      with open(os.path.join(args.ckpt_dir,
                             f'checkpoint_{step + 1}.pt.tmp'), 'w') as f:
        f.write('cut short')
      time.sleep(args.wait_s)


if __name__ == '__main__':
  main()
