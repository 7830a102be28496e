"""Generator of train traffic: the program's train step as its train entry
point drives it, for a fixed window.

Set-up builds one model, train step, Adam state and data plane (the
dataset's producer thread and ``train_lib.Prefetcher``, one batch ahead),
loads the benchmark's weights, and runs the first steps through the same
call and feed as the window; the first ``record_steps`` of them are
recorded for the reference (each step's loss, the first step's gradient as
Adam holds it, the change of every leaf after the last).  The window then
runs steps until ``seconds`` have passed, each synchronised and its loss
read, as ``train.py`` does.  A traced run profiles ``trace_units`` more
steps after the window.  Once the window has closed, the peak memory is
read and the program freed, the reference runs the recorded steps again
from the seed, and the gaps decide ``correct``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.lib import flops
from benchmark.lib import harness
from benchmark.lib import program
from benchmark.lib import trace
from benchmark.reference import model as ref_model
from benchmark.reference import scene as ref_scene
from benchmark.reference import train as ref_train


def train_fracs(config, steps):
  """train.py's train_frac of steps 1..`steps`."""
  return [float(np.clip((s - 1) / (config.max_steps - 1), 0, 1))
          for s in range(1, steps + 1)]


class Loop:
  """The program's model, step and feed, stepped as train.py steps them."""

  def __init__(self, cell, seeds, device, bindings=()):
    from multinerf_tpu_torch import train_lib
    from multinerf_tpu_torch.data import datasets
    traffic = cell.traffic
    self.config = config = program.load_config(
        cell.config, list(traffic['gin_bindings']) + list(bindings))
    self.device = device
    self.dataset = datasets.load_dataset('train', config.data_dir, config,
                                         seed=seeds['data'])
    harness.log('config and dataset')
    self.model, self.state, _, self.train_step, _ = train_lib.setup_model(
        config, seeds['weights'], device, self.dataset)
    harness.log('model, Adam and train step')
    if not bindings:
      program.check_model(self.model, cell.config['model'])
    self.weights = ref_model.make_weights(
        cell.config['model'],
        torch.Generator(device).manual_seed(seeds['weights']), device)
    program.load_weights(self.model, self.weights)
    self.generator = torch.Generator(device).manual_seed(seeds['jitter'])
    self.prefetcher = train_lib.Prefetcher(self.dataset, device)
    self.step = 0
    harness.log('weights and feed')

  def sync(self):
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)

  def run_step(self):
    """One step: (seconds, loss)."""
    self.step += 1
    step, config = self.step, self.config
    train_frac = float(np.clip((step - 1) / (config.max_steps - 1), 0, 1))
    will_print = step == 1 or step % config.print_every == 0
    t0 = time.perf_counter()
    with trace.span('take'):
      batch = self.prefetcher.take()
    with trace.span('step'):
      self.state, stats = self.train_step(self.generator, self.state, batch,
                                          train_frac, will_print)
    with trace.span('stage'):
      self.prefetcher.stage()
    with trace.span('sync'):
      self.sync()
    with trace.span('loss'):
      loss = float(stats['loss'])
    return time.perf_counter() - t0, loss

  def record(self, steps):
    """Run the first `steps` steps; the readings the reference follows."""
    params = program.named_parameters(self.model)
    start = {k: p.detach().clone() for k, p in params.items()}
    losses = []
    grad_norms = None
    for _ in range(steps):
      _, loss = self.run_step()
      losses.append(loss)
      if grad_norms is None:
        # Adam's first moment after one update is (1 - beta1) g; a leaf
        # that Adam never updated has none.
        moments = self.state.optimizer.state
        grad_norms = {
            k: (float(torch.linalg.vector_norm(
                moments[p]['exp_avg'].double())) / (1 - self.config.adam_beta1)
                if 'exp_avg' in moments.get(p, {}) else 0.0)
            for k, p in params.items()}
    delta_norms = {k: float(torch.linalg.vector_norm(
        (p.detach() - start[k]).double())) for k, p in params.items()}
    return {'losses': losses, 'grad_norms': grad_norms,
            'delta_norms': delta_norms}

  def close(self):
    self.dataset.close()
    del self.model, self.state, self.train_step, self.prefetcher
    del self.weights


def reference_readings(cell, seeds, device, steps, config, fault=None):
  """The reference's readings of the first `steps` steps of a run."""
  traffic, model_cfg = cell.traffic, cell.config['model']
  scene = ref_scene.Scene(cell.config['scene'], 'train').shade_images()
  batches = ref_scene.train_batches(
      scene, seeds['data'], traffic['batch_size'], traffic['batching'],
      config.near, config.far, steps)
  weights = ref_model.make_weights(
      model_cfg, torch.Generator(device).manual_seed(seeds['weights']),
      device)
  return ref_train.run_steps(model_cfg, cell.config['train'], weights,
                             batches, seeds['jitter'], device,
                             train_fracs(config, steps), fault)


def run(cell, seeds, device, seconds, traced, t_start):
  traffic = cell.traffic
  loop = Loop(cell, seeds, device)
  record_steps = traffic['record_steps']
  recorded = loop.record(record_steps)
  harness.log(f'{record_steps} recorded steps')
  for _ in range(traffic['warmup_steps']):
    loop.run_step()
  harness.log('warm-up steps')
  setup_s = time.perf_counter() - t_start

  program.reset_counts()
  step_s, losses = [], []
  gc_was_enabled = gc.isenabled()
  gc.disable()  # As train.py does in its loop.
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    s, loss = loop.run_step()
    step_s.append(s)
    losses.append(loss)
  window_s = time.perf_counter() - t0
  if gc_was_enabled:
    gc.enable()
  counts = program.launch_counts()

  summary = None
  if traced:
    kernels = trace.KernelBounds()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
      activities.append(torch.profiler.ProfilerActivity.CUDA)
    with kernels.active(), torch.profiler.profile(
        activities=activities) as prof:
      t1 = time.perf_counter()
      for _ in range(traffic['trace_units']):
        loop.run_step()
      traced_s = time.perf_counter() - t1
    summary = trace.reduce_profile(prof, traced_s, traffic['trace_units'])
    summary.update(
        kind='train', bounds_s=dict(kernels.bounds),
        unit_s=float(np.mean(step_s)),
        model_flops=flops.model_flops(
            ref_model.param_shapes(cell.config['model']),
            cell.config['model'], traffic['batch_size'] * cell.chips, True))

  memory_peak = (torch.cuda.max_memory_allocated(device)
                 if device.type == 'cuda' else 0)
  config = loop.config
  loop.close()
  del loop
  gc.collect()
  if device.type == 'cuda':
    torch.cuda.empty_cache()

  harness.log(f'window of {len(step_s)} steps closed')
  want = reference_readings(cell, seeds, device, record_steps, config)
  harness.log('reference')
  numbers = ref_train.gaps(recorded, want)
  numbers['nonfinite_losses'] = float(sum(not math.isfinite(x)
                                          for x in losses))
  rays = traffic['batch_size'] * cell.chips * len(step_s)
  return {
      'setup_s': setup_s,
      'metrics': {'train_rays_per_s': rays / window_s,
                  'train_step_ms_p90': 1e3 * float(np.percentile(step_s, 90))},
      'attempted': len(step_s), 'failed': 0,
      'numbers': numbers, 'memory_peak': memory_peak, 'summary': summary,
      'counts': counts,
      'units': len(step_s)}
