"""The reference's first training steps, and what the benchmark compares.

``run_steps`` follows the program's first steps from the same weights, the
same batches (worked out again from the data seed, ``scene``) and the same
jitter seed: each step's loss, the first step's clipped gradient (what
Adam receives) and the change of every leaf after the last step.
``gaps`` reduces two such readings to the three numbers that decide
``correct`` for a train cell.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as model_lib
from benchmark.reference import ops


def run_steps(model_cfg, train_cfg, weights, batches, jitter_seed, device,
              train_fracs, fault=None):
  """Readings {'losses', 'grad_norms', 'delta_norms'} of len(batches)
  reference steps.  `weights` {name: tensor} is not modified; `batches`
  [(rays {name: array}, rgb array)].  `fault` plants one of the faults the
  comparison must catch: 'half_batch' (the loss a mean over the first half
  of each batch) or 'unchanged' (every step returns the state it got)."""
  params = {k: v.detach().to(device).clone().requires_grad_(True)
            for k, v in weights.items()}
  start = {k: v.detach().clone() for k, v in params.items()}
  optimizer = torch.optim.Adam(
      list(params.values()), lr=1.0,
      betas=(train_cfg['adam_beta1'], train_cfg['adam_beta2']),
      eps=train_cfg['adam_eps'])
  generator = torch.Generator(device).manual_seed(jitter_seed)
  model = model_lib.Model(model_cfg, params)
  losses, grad_norms = [], None
  for step, (rays, rgb) in enumerate(batches):
    rays = {k: torch.as_tensor(v, device=device) for k, v in rays.items()}
    rgb = torch.as_tensor(rgb, device=device)
    rows = None
    if fault == 'half_batch':
      rows = slice(0, rgb.shape[0] // 2)
    loss, grads = model_lib.gradients(model, params, rays, rgb,
                                      train_fracs[step], generator, train_cfg,
                                      rows)
    grads = model_lib.clip_by_module(grads, train_cfg['grad_max_norm'])
    losses.append(float(loss))
    if step == 0:
      grad_norms = {k: float(torch.linalg.vector_norm(g.double()))
                    for k, g in grads.items()}
    if fault == 'unchanged':
      continue
    for k, p in params.items():
      p.grad = grads[k]
    for group in optimizer.param_groups:
      group['lr'] = ops.learning_rate_decay(
          step, train_cfg['lr_init'], train_cfg['lr_final'],
          train_cfg['max_steps'], train_cfg['lr_delay_steps'],
          train_cfg['lr_delay_mult'])
    optimizer.step()
    del grads
  delta_norms = {k: float(torch.linalg.vector_norm(
      (params[k].detach() - start[k]).double())) for k in params}
  return {'losses': losses, 'grad_norms': grad_norms,
          'delta_norms': delta_norms}


def _worst_leaf(got, want, keep):
  """The widest gap of a leaf's norm, against the larger of the
  reference's norm of that leaf and of the median leaf."""
  median = float(np.median([want[k] for k in keep]))
  return max(abs(got[k] - want[k]) / max(want[k], median) for k in keep)


def gaps(got, want, min_share=1e-3):
  """{'loss_gap', 'grad_gap', 'update_gap'} of readings `got` against the
  reference's `want`.  Leaves whose reference gradient is under
  `min_share` of the median leaf's move by round-off alone under Adam and
  are left out of both leaf gaps (none is left out by name)."""
  median = float(np.median(list(want['grad_norms'].values())))
  keep = [k for k, v in want['grad_norms'].items() if v >= min_share * median]
  loss_gap = max(abs(a - b) / abs(b)
                 for a, b in zip(got['losses'], want['losses']))
  return {'loss_gap': loss_gap,
          'grad_gap': _worst_leaf(got['grad_norms'], want['grad_norms'], keep),
          'update_gap': _worst_leaf(got['delta_norms'], want['delta_norms'],
                                    keep),
          'leaves_left_out': len(want['grad_norms']) - len(keep)}
