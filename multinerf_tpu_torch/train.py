"""Train entry point of the port.

    python -m multinerf_tpu_torch.train --gin_configs=configs/360.gin \
        --gin_bindings="Config.checkpoint_dir='...'" [--device=cuda]

A port of train.py:127-438: the same seeds (weights from 20200823, ray draws
from 20201473), ``config.gin`` written beside the checkpoints, a resume from
the latest checkpoint (parameters and Adam state) at ``step + 1``, printed as
"Starting at step N.", the save
at step 1, every ``checkpoint_every`` steps and at ``max_steps``, host
batches made by the dataset's producer thread and copied to the device one
step ahead, during the step before (or, with ``Config.device_data_plane``,
drawn and cast on the device), the tree statistics on the first step and
every ``print_every``-th, and at each console line (train.py:411-415) the
TensorBoard summaries under the JAX names: ``train_avg_*`` / ``train_max_*``
scalars and ``train_*`` histograms of every statistic, ``train_num_params``,
``train_learning_rate``, ``train_steps_per_sec``, ``train_rays_per_sec``,
``train_avg_psnr_timed`` and ``train_avg_psnr_timed_approx``, and with
RawNeRF's learned exposure scaling the ``exposure/scaling_i_j`` offsets
(its exposure metadata go to text summaries at step 0).  RobustNeRF's loss
threshold is fed from each step to the next on the device.  Every
``train_render_every`` steps a test view is rendered (train.py:53-125) and
logged: ``test_rays_per_sec``, ``train_metrics/*``, ``test_true_color``
(and ``test_true_normals`` with ``Config.compute_normal_metrics``) and
``test_output_*``; with ``Config.rawnerf_mode`` also the tonemap ladder
(``color_raw``, ``color_auto``, ``color/{p}``, ``test_true_auto``,
``test_true_color/{p}``).  ``Config.early_exit_steps`` (0 included) stops the run
after that many steps, as train.py:235-238.  ``Config.profile_step`` traces
``profile_num_steps`` steps with torch.profiler into
``checkpoint_dir/profile``, the port's spans (``utils/trace.py``: the
loop's ``loop/*``, the data plane's ``data/*``, the step's ``train/*``)
among the kernels.  With ``Config.occupancy_culling`` the host path
runs one step per capacity rung and ``train_lib.CullingGate``: unculled
until ``occupancy_warmup_steps``, then the rung the gate engaged at the
last grid refresh (train.py:156-179, 260-289).  On the device plane
(``Config.device_data_plane``) ``steps_per_jit_call`` > 1 runs windows of
that many steps (``device_sampler.create_scan_train_step``), the culling
protocol inside them; every cadence is then a multiple of the window, the
cadence checks use the window's last step, and the losses, the stats and
the synchronisation are read once per window (train.py:181-196, 290-351).
Culling on the device plane needs such windows, as in JAX.  Rates are taken
over the steps since the last line (JAX divides by ``print_every`` also
when fewer steps ran).  Each step is synchronised with the device, so the
step times it reports are device-complete.  ``--device`` defaults to
``cuda`` and the run fails when CUDA is not available: there is no CPU
fallback.

On N GPUs, one process each (``parallel/mesh.py``):

    python -m torch.distributed.run --nproc_per_node=N --max-restarts=0 \
        -m multinerf_tpu_torch.train --gin_configs=...

Each rank draws ``batch_size / N`` rays a step, from the numpy seed
``DATA_SEED + rank`` (or, on the device plane, the step generator) and
jitters them from a step generator seeded ``SEED + rank``, so rank 0 keeps
a single process's streams; the step is the global-batch step
(``train_lib``).  Rank 0 alone writes ``config.gin``, checkpoints, events
and the profile, and prints; every rank renders the in-train test views,
whose rows they share.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np
import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.data import device_sampler
from multinerf_tpu_torch.models import nerf as models
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.parallel import tensor
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib
from multinerf_tpu_torch.utils import summary
from multinerf_tpu_torch.utils import trace
from multinerf_tpu_torch.utils import visualize as vis

# train.py:118-120: the key of the weights and the numpy seed of the rays.
SEED = 20200823
DATA_SEED = 20201473
TIME_PRECISION = 1000  # Integer times are in milliseconds.
TREE_STAT_PREFIXES = ('weight_l2s/', 'grad_norms/', 'grad_maxes/',
                      'opt_update_norms/', 'opt_update_maxes/')


def _console_line(step, config, avg_stats, lr, rays_per_sec):
  """train.py:403-415: the averages since the last line."""
  precision = int(np.ceil(np.log10(config.max_steps))) + 1
  str_losses = {  # Each "losses/x" as "x[:4]".
      k[7:11]: (f'{v:0.5f}' if 1e-4 <= v < 10 else f'{v:0.1e}')
      for k, v in avg_stats.items() if k.startswith('losses/')}
  return (f'{step:{precision}d}' + f'/{config.max_steps:d}: ' +
          f'loss={avg_stats["loss"]:0.5f}, ' +
          f'psnr={avg_stats["psnr"]:6.3f}, ' + f'lr={lr:0.2e} | ' +
          ', '.join([f'{k}={s}' for k, s in str_losses.items()]) +
          f', {rays_per_sec:0.0f} r/s')


def transpose_stats(stats_buffer, step, print_every, scan_steps=1):
  """The stats of the steps since the last line, key -> [n] or [n, k]
  numpy (train.py:320-355).  The tree statistics exist on the steps that
  computed them: those at step 1 and every `print_every`-th, or, when no
  row is such a step (a resumed run's first step), row 0, the first step of
  the run, which always computes them (ADVICE.md:3).  With `scan_steps` >
  1 the buffer holds windows of stats stacked [scan_steps, ...], whose
  first rows also computed them."""
  if scan_steps > 1:
    windows = [{k: v.cpu().numpy() for k, v in w.items()}
               for w in stats_buffer]
    stats_buffer = [{k: v[i] for k, v in w.items()}
                    for w in windows for i in range(scan_steps)]
  n_rows = len(stats_buffer)
  buf_steps = np.arange(step - n_rows + 1, step + 1)
  stats_mask = (buf_steps % print_every == 0) | (buf_steps == 1)
  if scan_steps > 1:
    stats_mask[0::scan_steps] = True
  if not stats_mask.any():
    stats_mask[0] = True
  stacked = {}
  for k in stats_buffer[int(np.flatnonzero(stats_mask)[0])]:
    rows = stats_buffer
    if k.startswith(TREE_STAT_PREFIXES):
      rows = [s for s, m in zip(stats_buffer, stats_mask) if m]
    stacked[k] = (np.stack([s[k] for s in rows]) if scan_steps > 1 else
                  torch.stack([s[k] for s in rows]).cpu().numpy())
  return stacked


def split_stats(stacked, n_rows):
  """Vector-valued stats become one stat per element (train.py:357-365)."""
  out = {}
  for k, v in stacked.items():
    if v.ndim not in [1, 2] and v.shape[0] != n_rows:
      raise ValueError('statistics must be of size [n], or [n, k].')
    if v.ndim == 1:
      out[k] = v
    elif v.ndim == 2:
      for i, vi in enumerate(tuple(v.T)):
        out[f'{k}/{i}'] = vi
  return out


def in_train_test_render(step, renderer, train_frac, test_dataset, config,
                         summary_writer, metric_harness, postprocess_fn,
                         cam_idx):
  """Render test view `cam_idx` mid-training and log its speed, metrics and
  visualizations (train.py:53-125).  Every rank renders; rank 0 logs.
  Returns the rays per second."""
  t0 = time.time()
  rendering = renderer(train_frac, cam_idx)
  test_case = next(test_dataset)  # The same camera: the views come in turn.
  dt = time.time() - t0
  n_rays = int(np.prod(test_case.rays.directions.shape[:-1]))
  if not mesh.is_main():
    return n_rays / dt
  summary_writer.scalar('test_rays_per_sec', n_rays / dt, step)
  print(f'Eval {step}: {dt:0.3f}s., {n_rays / dt:0.0f} rays/sec')

  t0 = time.time()
  metric = metric_harness(postprocess_fn(rendering['rgb']),
                          postprocess_fn(test_case.rgb))
  print(f'Metrics computed in {time.time() - t0:0.3f}s')
  for name, val in metric.items():
    if not np.isnan(val):
      print(f'{name} = {val:.4f}')
      summary_writer.scalar('train_metrics/' + name, val, step)

  if config.vis_decimate > 1:
    rendering = vis.decimate(rendering, config.vis_decimate)
    test_case = vis.decimate(test_case, config.vis_decimate)
  t0 = time.time()
  suite = vis.visualize_suite(rendering, test_case.rays)
  print(f'Visualized in {time.time() - t0:0.3f}s')
  # The ground truth beside the suite, and RawNeRF's tonemap ladder.
  truths = {'test_true_color': test_case.rgb}
  if config.compute_normal_metrics:
    truths['test_true_normals'] = test_case.normals / 2 + 0.5
  if config.rawnerf_mode:
    suite['color_raw'] = rendering['rgb']
    suite['color_auto'] = postprocess_fn(rendering['rgb'], None)
    truths['test_true_auto'] = postprocess_fn(test_case.rgb, None)
    for p, level in test_dataset.metadata['exposure_levels'].items():
      suite[f'color/{p}'] = postprocess_fn(rendering['rgb'], level)
      truths[f'test_true_color/{p}'] = postprocess_fn(test_case.rgb, level)
  for tag, img in truths.items():
    summary_writer.image(tag, img, step)
  for name, img in suite.items():
    summary_writer.image('test_output_' + name, img, step)
  return n_rays / dt


def window_steps(config):
  """The steps of one call: steps_per_jit_call on the device plane, else 1;
  with JAX's checks of what it needs (train.py:167-172, 185-191)."""
  if not config.device_data_plane:
    return 1
  scan_steps = max(1, config.steps_per_jit_call)
  if config.occupancy_culling and scan_steps == 1:
    raise ValueError(
        'occupancy_culling with device_data_plane requires '
        'steps_per_jit_call > 1 (culling runs inside the scan).')
  if scan_steps > 1:
    for name in ['print_every', 'checkpoint_every', 'train_render_every',
                 'gc_every']:
      val = getattr(config, name)
      if val > 0 and val % scan_steps:
        raise ValueError(
            f'{name}={val} must be a multiple of steps_per_jit_call='
            f'{scan_steps}')
  return scan_steps


def _profile(device, log_dir):
  activities = [torch.profiler.ProfilerActivity.CPU]
  if device.type == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  prof = torch.profiler.profile(
      activities=activities,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
  prof.start()
  return prof


def parse_flags(argv=None):
  """This entry point's command line: ``configs.parse_entry_flags``."""
  return configs.parse_entry_flags('Train a model.', argv)


def main(argv=None):
  """Train to Config.max_steps (or early_exit_steps), resuming from the
  latest checkpoint.  Returns {'init_step', 'losses', 'data_losses',
  'step_seconds' (per step; a window's time split evenly over its steps),
  'stats' (the last step's, as floats or lists), 'checkpoint' (the latest
  file), 'test_rays_per_sec' (per in-train render), 'keep_fracs' and
  'rungs' (with culling: {step: keep fraction} at each grid refresh and
  {step: capacity} at each culled step)}."""
  args = parse_flags(argv)
  device = configs.setup_device(args.device)
  # Seeds by data rank: the ranks of a model group draw the same rays,
  # jitter and noise.
  rank = mesh.data_rank()

  config = configs.load_config(args, save_config=True)
  scan_steps = window_steps(config)
  # Each rank draws its own rays (train.py:119-120).
  dataset = datasets.load_dataset('train', config.data_dir, config,
                                  seed=DATA_SEED + rank)
  test_dataset = datasets.load_dataset('test', config.data_dir, config)
  postprocess_fn, _ = image_ops.make_postprocess_fns(config, test_dataset)
  model, state, render_eval_fn, train_step, lr_fn = train_lib.setup_model(
      config, SEED, device, dataset)
  # One step per capacity rung, picked by the gate (train.py:156-179).
  train_steps = {None: train_step}
  gate = None
  if config.occupancy_culling:
    gate = train_lib.CullingGate(model, config)
    for cap in gate.ladder:
      train_steps[cap] = train_lib.create_train_step(
          model, config, device, cull=cap, dataset=dataset)
  renderer = models.choose_renderer(render_eval_fn, config, test_dataset,
                                    device)
  num_params = tensor.whole_numel(state.params)
  if mesh.is_main():
    print(f'Number of parameters being optimized: {num_params}')
  if (dataset.size > model.cfg.num_glo_embeddings and
      model.cfg.num_glo_features > 0):
    raise ValueError(f'Number of glo embeddings '
                     f'{model.cfg.num_glo_embeddings} must be at least equal '
                     f'to number of train images {dataset.size}')
  metric_harness = image_ops.MetricHarness()

  ckpt = ckpt_lib.CheckpointManager(config.checkpoint_dir, keep=100)
  state = ckpt.restore_latest(state)
  init_step = state.step + 1
  if mesh.is_main():
    print(f'Starting at step {init_step}.', flush=True)
  summary_writer = summary.writer_for_rank(config.checkpoint_dir)
  if config.rawnerf_mode:
    for name, data in zip(['train', 'test'], [dataset, test_dataset]):
      for k in ['exposure_idx', 'exposure_values', 'unique_shutters']:
        summary_writer.text(f'{name}_{k}', str(data.metadata[k]), 0)
  exposure_table = state.params.get('exposure_scaling_offsets/embedding')
  # Independent jitter (and device-plane draws) per rank (train.py:230).
  generator = torch.Generator(device=device).manual_seed(SEED + rank)
  # RobustNeRF's threshold: each step's inlier quantile, fed back to the
  # next step as a device tensor (train.py:296-297).
  loss_threshold = 1.0

  if config.device_data_plane:
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
    if scan_steps > 1:
      window = device_sampler.create_scan_train_step(
          train_steps, plane, config, scan_steps, gate)
    else:
      device_step = device_sampler.create_device_train_step(train_step, plane)
  else:
    prefetcher = train_lib.Prefetcher(dataset, device)

  num_steps = (config.early_exit_steps
               if config.early_exit_steps is not None else config.max_steps)
  out = {'init_step': init_step, 'losses': [], 'data_losses': [],
         'step_seconds': [], 'test_rays_per_sec': []}
  total_time = 0
  total_steps = 0
  reset_stats = True
  test_render_count = 0
  profiler = None
  stats = {}
  gc_was_enabled = gc.isenabled()
  gc.disable()  # Avoid GC jitter in the hot loop.
  try:
    for step0 in range(init_step, num_steps + 1, scan_steps):
      # The window [step0, step] runs in one call; the cadences read its
      # last step.
      step = step0 + scan_steps - 1
      if reset_stats:
        stats_buffer = []
        train_start_time = time.time()
        reset_stats = False

      if (config.profile_step > 0 and mesh.is_main() and
          step0 <= config.profile_step <= step):
        profiler = _profile(device, os.path.join(config.checkpoint_dir,
                                                 'profile'))
      if (profiler is not None and step0 <= config.profile_step +
          config.profile_num_steps <= step):
        profiler.stop()
        profiler = None

      learning_rate = float(lr_fn(step))
      train_frac = float(np.clip((step - 1) / (config.max_steps - 1), 0, 1))
      # train.py:265: the tree statistics on the first step of the run and
      # on the steps that print.
      will_print = step0 == init_step or step % config.print_every == 0

      # The step's time includes taking its batch (a host batch whose copy
      # was issued during the last step, or the device plane's draw) and
      # staging the next one while this step runs on the device.
      t0 = time.perf_counter()
      if scan_steps > 1:
        state, stats, loss_threshold = window(generator, state, step0,
                                              loss_threshold)
      elif config.device_data_plane:
        state, stats = device_step(generator, state, train_frac, will_print,
                                   loss_threshold)
      else:
        state, stats = train_steps[gate.cull(step) if gate else None](
            generator, state, prefetcher.take(), train_frac, will_print,
            loss_threshold)
        if step < num_steps:
          prefetcher.stage()
        if gate is not None:
          gate.after_step(step, stats)
      if config.enable_robustnerf_loss and scan_steps == 1:
        loss_threshold = stats['loss_threshold']
      if device.type == 'cuda':
        with trace.span('loop/sync'):
          torch.cuda.synchronize(device)
      seconds = time.perf_counter() - t0
      out['step_seconds'] += [seconds / scan_steps] * scan_steps
      with trace.span('loop/loss'):
        if scan_steps > 1:
          out['losses'] += stats['loss'].tolist()
          out['data_losses'] += stats['losses/data'].tolist()
        else:
          out['losses'].append(float(stats['loss']))
          out['data_losses'].append(float(stats['losses/data']))

      if step % config.gc_every == 0:
        gc.collect()

      stats_buffer.append(stats)
      if will_print:
        with trace.span('loop/summaries'):
          elapsed_time = time.time() - train_start_time
          steps_per_sec = len(stats_buffer) * scan_steps / elapsed_time
          rays_per_sec = config.batch_size * steps_per_sec  # All ranks'.
          # Robust total-time accumulation, resilient to preemption.
          total_time += int(round(TIME_PRECISION * elapsed_time))
          total_steps += len(stats_buffer) * scan_steps
          approx_total_time = int(round(step * total_time / total_steps))

          stats_split = split_stats(
              transpose_stats(stats_buffer, step, config.print_every,
                              scan_steps), len(stats_buffer) * scan_steps)
          for k, v in stats_split.items():
            summary_writer.histogram('train_' + k, v, step)
          avg_stats = {k: float(np.mean(v)) for k, v in stats_split.items()}
          max_stats = {k: float(np.max(v)) for k, v in stats_split.items()}
          for k, v in avg_stats.items():
            summary_writer.scalar(f'train_avg_{k}', v, step)
          for k, v in max_stats.items():
            summary_writer.scalar(f'train_max_{k}', v, step)
          summary_writer.scalar('train_num_params', num_params, step)
          summary_writer.scalar('train_learning_rate', learning_rate, step)
          summary_writer.scalar('train_steps_per_sec', steps_per_sec, step)
          summary_writer.scalar('train_rays_per_sec', rays_per_sec, step)
          summary_writer.scalar('train_avg_psnr_timed', avg_stats['psnr'],
                                total_time // TIME_PRECISION)
          summary_writer.scalar('train_avg_psnr_timed_approx',
                                avg_stats['psnr'],
                                approx_total_time // TIME_PRECISION)
          if dataset.metadata is not None and exposure_table is not None:
            # The learned scaling offsets of each shutter bucket.
            scalings = exposure_table.detach().cpu().numpy()
            num_shutter_speeds = dataset.metadata['unique_shutters'].shape[0]
            for i_s in range(num_shutter_speeds):
              for j_s, value in enumerate(scalings[i_s]):
                summary_writer.scalar(f'exposure/scaling_{i_s}_{j_s}', value,
                                      step)
          if mesh.is_main():
            print(_console_line(step, config, avg_stats, learning_rate,
                                rays_per_sec), flush=True)
        reset_stats = True

      if step == 1 or step % config.checkpoint_every == 0:
        with trace.span('loop/checkpoint'):
          ckpt.save(step, state)

      if (config.train_render_every > 0 and
          step % config.train_render_every == 0):
        with trace.span('loop/test_render'):
          out['test_rays_per_sec'].append(in_train_test_render(
              step, renderer, train_frac, test_dataset, config,
              summary_writer, metric_harness, postprocess_fn,
              test_render_count % test_dataset.size))
        test_render_count += 1

    if config.max_steps % config.checkpoint_every != 0:
      ckpt.save(config.max_steps, state)
  finally:
    if profiler is not None:
      profiler.stop()
    if gc_was_enabled:
      gc.enable()
    summary_writer.close()
    dataset.close()
    test_dataset.close()

  out['stats'] = {k: (v[-1] if scan_steps > 1 else v).tolist()
                  for k, v in stats.items()}
  if gate is not None:
    out['keep_fracs'], out['rungs'] = gate.keep_fracs, gate.rungs
  latest = ckpt.latest_step()
  out['checkpoint'] = None if latest is None else ckpt.path(latest)
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
  mesh.shutdown()
