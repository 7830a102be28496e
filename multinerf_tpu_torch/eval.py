"""Eval entry point of the port: score the test views of the latest checkpoint.

    python -m multinerf_tpu_torch.eval --gin_configs=configs/360.gin \
        --gin_bindings="Config.checkpoint_dir='...'" [--device=cuda]

A port of eval.py: restore the latest checkpoint, render each test view by
camera index through ``models.nerf.DeviceImageRenderer`` (a pano camera's
host rays through ``ImageRenderer``), color-correct it
against the ground truth, score it (psnr, ssim and, with
``Config.lpips_weights_path``, lpips on the card; and their ``_cc``
variants, and with ``Config.compute_disp_metrics`` /
``compute_normal_metrics`` the disparity MSEs and the normal MAEs of
eval.py:76-90), write its images and the per-metric files under the JAX
names (``color_XXX.png``, ``color_cc_XXX.png``,
``distance_{mean,median}_XXX.tiff``, ``normals_XXX.png``, ``acc_XXX.tiff``,
``metric_{name}_{step}.txt``, ``metric_cc_...``), and with
``Config.eval_only_once=False`` poll for new checkpoints, logging
TensorBoard summaries and showcase images under ``checkpoint_dir/eval``.
Frames are rendered and scored one after the other (the JAX driver overlaps
the two).  ``--device`` defaults to ``cuda`` and the run fails when CUDA is
not available: there is no CPU fallback.  Under ``torch.distributed.run``
every rank renders its rows of each view, and rank 0 scores them and writes
the files and summaries (eval.py:244, 262).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.models import nerf as models
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.ops import ref_utils
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib
from multinerf_tpu_torch.utils import io as io_lib
from multinerf_tpu_torch.utils import summary
from multinerf_tpu_torch.utils import visualize as vis

# The JAX eval's key (eval.py:277): the weights of a run with no checkpoint.
SEED = 20200823


def prepare_frame(rendering, batch, cc_fn):
  """Host prep shared by scoring and saving: f64 rgb + color correction."""
  rendering['rgb'] = np.asarray(rendering['rgb'], np.float64)
  gt = np.asarray(batch.rgb, np.float64) if batch.rgb is not None else None
  if gt is not None:
    t0 = time.time()
    rendering['rgb_cc'] = cc_fn(rendering['rgb'], gt)
    print(f'Color corrected in {time.time() - t0:0.3f}s')
  return gt


def score_frame(rendering, batch, gt, config, metric_harness,
                postprocess_fn):
  """Quality metrics of one frame: (raw dict, color-corrected dict)."""

  def to_metric_space(img, quantize):
    img = postprocess_fn(img)
    if quantize and config.eval_quantize_metrics:
      # Written-to-disk images must reproduce the metrics exactly.
      # Ground truth is never written, so it is never quantized.
      img = np.round(img * 255) / 255
    c = config.eval_crop_borders
    return img[c:-c, c:-c] if c > 0 else img

  gt_m = to_metric_space(gt, quantize=False)
  metric = metric_harness(
      to_metric_space(rendering['rgb'], quantize=True), gt_m)
  metric_cc = metric_harness(
      to_metric_space(rendering['rgb_cc'], quantize=True), gt_m)

  if config.compute_disp_metrics:
    for key in ('distance_mean', 'distance_median'):
      if key in rendering:
        disp = 1 / (1 + rendering[key])
        tag = key.split('_')[1]
        metric[f'disparity_{tag}_mse'] = float(
            np.mean((disp - batch.disps)**2))

  if config.compute_normal_metrics:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    mae_weights = f32(rendering['acc']) * f32(batch.alphas)
    gt_normals = ref_utils.l2_normalize(f32(batch.normals))
    for key, val in rendering.items():
      if key.startswith('normals') and val is not None:
        metric[key + '_mae'] = float(ref_utils.compute_weighted_mae(
            mae_weights, ref_utils.l2_normalize(f32(val)), gt_normals))

  for name, value in metric.items():
    print(f'{name:30s} = {value:.4f}')
  return metric, metric_cc


def save_frame_outputs(rendering, idx, out_dir, postprocess_fn):
  """Prediction images of one frame, under the JAX file names."""
  tag = f'{idx:03d}'
  io_lib.save_img_u8(postprocess_fn(rendering['rgb']),
                     os.path.join(out_dir, f'color_{tag}.png'))
  if 'rgb_cc' in rendering:
    io_lib.save_img_u8(postprocess_fn(rendering['rgb_cc']),
                       os.path.join(out_dir, f'color_cc_{tag}.png'))
  for key in ('distance_mean', 'distance_median'):
    io_lib.save_img_f32(rendering[key],
                        os.path.join(out_dir, f'{key}_{tag}.tiff'))
  if 'normals' in rendering:
    io_lib.save_img_u8(rendering['normals'] / 2 + 0.5,
                       os.path.join(out_dir, f'normals_{tag}.png'))
  io_lib.save_img_f32(rendering['acc'],
                      os.path.join(out_dir, f'acc_{tag}.tiff'))


def pick_showcases(config, num_eval, step):
  """The frame indices shown in TensorBoard: a permutation from seed 0
  (``deterministic_showcase``) or from the step.  The port's permutation
  is torch's, not JAX's: which frames are shown differs."""
  if config.eval_only_once:
    return np.array([], int)
  seed = 0 if config.deterministic_showcase else step
  perm = torch.randperm(num_eval,
                        generator=torch.Generator().manual_seed(seed))
  return np.sort(perm[:config.num_showcase_images].numpy())


def render_frames(renderer, dataset, step, config, num_eval):
  """Yield (idx, batch, host rendering, render seconds) of the first
  `num_eval` test views; the others' batches are drawn and skipped, so the
  dataset's cameras stay in step for the next checkpoint."""
  train_frac = float(step) / config.max_steps
  for idx in range(dataset.size):
    if idx >= num_eval:
      next(dataset)
      print(f'Skipping image {idx + 1}/{dataset.size}')
      continue
    print(f'Evaluating image {idx + 1}/{dataset.size}')
    t0 = time.time()
    rendering = renderer(train_frac, idx)
    batch = next(dataset)
    yield idx, batch, rendering, time.time() - t0


def log_tb_summaries(summary_writer, step, config, frame_metrics,
                     showcases, render_times, postprocess_fn):
  """Aggregate scalars/histograms and showcase image suites (eval.py:
  176-205)."""
  summary_writer.scalar('eval_median_render_time',
                        np.median(render_times), step)
  for group, per_frame in frame_metrics.items():
    for name in (per_frame[0] if per_frame else ()):
      scores = [m[name] for m in per_frame]
      summary_writer.scalar(f'{group}/{name}', np.mean(scores), step)
      summary_writer.histogram(f'{group}/perimage_{name}', scores, step)

  for i, rendering, batch in showcases:
    if config.vis_decimate > 1:
      rendering = vis.decimate(rendering, config.vis_decimate)
      batch = vis.decimate(batch, config.vis_decimate)
    suite = vis.visualize_suite(rendering, batch.rays)
    for name, img in suite.items():
      if name == 'color':
        img = postprocess_fn(img)
      summary_writer.image(f'output_{name}_{i}', img, step)
    if not config.render_path:
      target = postprocess_fn(batch.rgb)
      summary_writer.image(f'true_color_{i}', target, step)
      pred = postprocess_fn(suite['color'])
      summary_writer.image(f'true_residual_{i}',
                           np.clip(pred - target + 0.5, 0, 1), step)
      if config.compute_normal_metrics:
        summary_writer.image(f'true_normals_{i}', batch.normals / 2 + 0.5,
                             step)


def write_metric_files(out_dir, step, config, frame_metrics, render_times,
                       showcases):
  """Per-metric txt exports, one value per frame (eval.py:208-229)."""

  def dump(name, values):
    with open(os.path.join(out_dir, name), 'w') as f:
      f.write(' '.join(str(v) for v in values))

  dump(f'render_times_{step}.txt', render_times)
  prefix = {'eval_metrics': 'metric_', 'eval_metrics_cc': 'metric_cc_'}
  for group, per_frame in frame_metrics.items():
    for name in (per_frame[0] if per_frame else ()):
      dump(f'{prefix[group]}{name}_{step}.txt',
           [m[name] for m in per_frame])
  if config.eval_save_ray_data:
    np.set_printoptions(threshold=sys.maxsize)
    for i, rendering, _ in showcases:
      bundles = {k: v for k, v in rendering.items() if 'ray_' in k}
      with open(os.path.join(out_dir, f'ray_data_{step}_{i}.txt'),
                'w') as f:
        f.write(repr(bundles))


def evaluate_checkpoint(step, renderer, dataset, config, out_dir,
                        summary_writer, postprocess_fn, cc_fn,
                        metric_harness):
  """Render and score the test views of one checkpoint.  Returns
  {'eval_metrics': [per frame], 'eval_metrics_cc': [...], 'render_times'}
  (empty lists but on rank 0, which alone scores and writes)."""
  num_eval = min(dataset.size, config.eval_dataset_limit)
  showcase_indices = pick_showcases(config, num_eval, step)

  metrics, metrics_cc, showcases, render_times = [], [], [], []
  for idx, batch, rendering, render_s in render_frames(
      renderer, dataset, step, config, num_eval):
    if not mesh.is_main():
      continue
    render_times.append(render_s)
    print(f'Rendered in {render_s:0.3f}s')
    gt = prepare_frame(rendering, batch, cc_fn)
    if idx in showcase_indices:
      order = idx if config.deterministic_showcase else len(showcases)
      showcases.append((order, rendering, batch))
    if not config.render_path:
      metric, metric_cc = score_frame(rendering, batch, gt, config,
                                      metric_harness, postprocess_fn)
      metrics.append(metric)
      metrics_cc.append(metric_cc)
    if (config.eval_save_output and config.eval_render_interval > 0 and
        idx % config.eval_render_interval == 0):
      save_frame_outputs(rendering, idx, out_dir, postprocess_fn)

  frame_metrics = {'eval_metrics': metrics, 'eval_metrics_cc': metrics_cc}
  if summary_writer is not None:
    log_tb_summaries(summary_writer, step, config, frame_metrics,
                     showcases, render_times, postprocess_fn)
  if config.eval_save_output and not config.render_path and mesh.is_main():
    write_metric_files(out_dir, step, config, frame_metrics, render_times,
                       showcases)
  return dict(frame_metrics, render_times=render_times)


def parse_flags(argv=None):
  """This entry point's command line: ``configs.parse_entry_flags``."""
  return configs.parse_entry_flags('Evaluate a model.', argv)


def main(argv=None):
  """Evaluate the latest checkpoint (and, with eval_only_once=False, each
  newer one until early_exit_steps or max_steps).  Returns {step:
  evaluate_checkpoint's result} and 'out_dir'."""
  args = parse_flags(argv)
  device = configs.setup_device(args.device)

  config = configs.load_config(args)
  dataset = datasets.load_dataset('test', config.data_dir, config)
  _, state, render_eval_fn, _, _ = train_lib.setup_model(config, SEED, device)
  state = ckpt_lib.TrainState(step=0, params=state.params)
  renderer = models.choose_renderer(render_eval_fn, config, dataset, device)
  postprocess_fn, cc_fn = image_ops.make_postprocess_fns(config, dataset)
  metric_harness = image_ops.MetricHarness(config.lpips_weights_path, device)

  out_dir = os.path.join(
      config.checkpoint_dir,
      'path_renders' if config.render_path else 'test_preds')
  ckpt = ckpt_lib.CheckpointManager(config.checkpoint_dir, keep=100)
  summary_writer = None
  if not config.eval_only_once and mesh.is_main():
    summary_writer = summary.SummaryWriter(
        os.path.join(config.checkpoint_dir, 'eval'))

  out = {'out_dir': out_dir}
  last_step = 0
  try:
    while True:
      state = ckpt.restore_latest(state)
      step = state.step
      if step <= last_step:
        print(f'Checkpoint step {step} <= last step {last_step}, sleeping.')
        time.sleep(10)
        continue
      print(f'Evaluating checkpoint at step {step}.')
      if config.eval_save_output and mesh.is_main():
        os.makedirs(out_dir, exist_ok=True)
      out[step] = evaluate_checkpoint(step, renderer, dataset, config,
                                      out_dir, summary_writer, postprocess_fn,
                                      cc_fn, metric_harness)
      if config.eval_only_once:
        break
      stop_at = (config.early_exit_steps
                 if config.early_exit_steps is not None else config.max_steps)
      if step >= stop_at:
        break
      last_step = step
  finally:
    dataset.close()
    if summary_writer is not None:
      summary_writer.close()
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
  mesh.shutdown()
