"""Generator of render traffic: whole frames through the renderer the program's
render and eval entry points choose (``choose_renderer``), one after
another, each ending in its copy to the host.

Set-up builds the model and renderer from the configuration and the
traffic's frame (size, focal, chunk), loads the benchmark's weights and
renders one chunk of the frame's shape.  The window renders whole frames
of the test cameras, in an order drawn from the seed, until ``seconds``
have passed.  A traced run profiles ``trace_units`` more frames.  Once the
window has closed the program is freed and the reference renders a sample
of each frame's pixels, drawn from the seed, from its own cameras and
weights; the widest and the mean gap of the colors decide ``correct``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.lib import flops
from benchmark.lib import harness
from benchmark.lib import program
from benchmark.lib import trace
from benchmark.reference import model as ref_model
from benchmark.reference import scene as ref_scene

TRAIN_FRAC = 1.0  # As the render entry point renders.


def bindings(traffic):
  frame = traffic['frame']
  return list(traffic['gin_bindings']) + [
      'Config.render_path = True',
      f'Config.render_resolution = ({frame["width"]}, {frame["height"]})',
      f'Config.render_focal = {frame["focal"]!r}',
      f'Config.render_chunk_size = {frame["chunk"]}']


class Frames:
  """The program's renderer over the test cameras."""

  def __init__(self, cell, seeds, device, extra=()):
    from multinerf_tpu_torch import train_lib
    from multinerf_tpu_torch.data import datasets
    from multinerf_tpu_torch.models import nerf
    self.config = config = program.load_config(
        cell.config, bindings(cell.traffic) + list(extra))
    self.device = device
    self.dataset = datasets.load_dataset('test', config.data_dir, config)
    harness.log('config and dataset')
    model, _, render_fn, _, _ = train_lib.setup_model(config, seeds['weights'],
                                                      device)
    harness.log('model')
    if not extra:
      program.check_model(model, cell.config['model'])
    program.load_weights(model, ref_model.make_weights(
        cell.config['model'],
        torch.Generator(device).manual_seed(seeds['weights']), device))
    self.model = model
    self.render_fn = render_fn
    self.renderer = nerf.choose_renderer(render_fn, config, self.dataset,
                                         device)
    if not isinstance(self.renderer, nerf.DeviceImageRenderer):
      raise TypeError('the render cell drives the DeviceImageRenderer.')
    n = self.dataset.size
    rng = np.random.RandomState(seeds['sample'])
    self.order = [int(i) for i in np.concatenate(
        [rng.permutation(n) for _ in range(64)])]

  def warm_up(self):
    """One chunk of the frame's shape through the frame's render call."""
    chunk = self.config.render_chunk_size
    rays = self.renderer._cast_chunk(0, chunk, self.order[0])  # pylint: disable=protected-access
    self.render_fn(TRAIN_FRAC, rays)
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)

  def frame(self, i):
    """Frame i of the order: (camera, seconds, rgb [H, W, 3] on the host)."""
    cam = self.order[i % len(self.order)]
    t0 = time.perf_counter()
    with trace.span('frame'):
      out = self.renderer(TRAIN_FRAC, cam)
    return cam, time.perf_counter() - t0, out['rgb']

  def close(self):
    self.dataset.close()
    del self.model, self.render_fn, self.renderer


def reference_gaps(cell, seeds, device, frames, config):
  """The colors of a sample of each frame's pixels against the reference's:
  the widest gap, the mean gap and the bias (the mean signed difference,
  whose rounding noise cancels while a lower precision's drift stays).
  `frames` [(camera, rgb [H, W, 3])]."""
  traffic, model_cfg = cell.traffic, cell.config['model']
  frame = traffic['frame']
  scene = ref_scene.Scene(cell.config['scene'], 'test').render_at(
      frame['width'], frame['height'], frame['focal'])
  weights = ref_model.make_weights(
      model_cfg, torch.Generator(device).manual_seed(seeds['weights']),
      device)
  model = ref_model.Model(model_cfg, weights)
  rng = np.random.RandomState(seeds['sample'] ^ 0x5EED)
  per_frame = traffic['check_pixels']
  block = traffic['reference_block']
  widest, total, signed, count = 0.0, 0.0, 0.0, 0
  with torch.no_grad():
    for cam, rgb in frames:
      px = rng.randint(0, frame['width'], per_frame)
      py = rng.randint(0, frame['height'], per_frame)
      rays = scene.rays(px, py, cam, config.near, config.far)
      got = torch.as_tensor(np.asarray(rgb)[py, px], device=device)
      for s in range(0, per_frame, block):
        part = {k: torch.as_tensor(v[s:s + block], device=device)
                for k, v in rays.items()}
        want = model(part, TRAIN_FRAC, None)[0][-1]
        diff = (got[s:s + block] - want).double()
        widest = max(widest, float(diff.abs().max()))
        total += float(diff.abs().sum())
        signed += float(diff.sum())
        count += diff.numel()
  return {'rgb_max_gap': widest, 'rgb_mean_gap': total / count,
          'rgb_bias': abs(signed) / count}


def run(cell, seeds, device, seconds, traced, t_start):
  traffic = cell.traffic
  frames = Frames(cell, seeds, device)
  harness.log('weights and renderer')
  frames.warm_up()
  harness.log('warm-up chunk')
  setup_s = time.perf_counter() - t_start

  program.reset_counts()
  kept, frame_s = [], []
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    cam, s, rgb = frames.frame(len(kept))
    kept.append((cam, rgb))
    frame_s.append(s)
  window_s = time.perf_counter() - t0
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
      for i in range(traffic['trace_units']):
        frames.frame(len(kept) + i)
      traced_s = time.perf_counter() - t1
    summary = trace.reduce_profile(prof, traced_s, traffic['trace_units'])
    frame = traffic['frame']
    rays = frame['width'] * frame['height']
    summary.update(
        kind='render', bounds_s=dict(kernels.bounds), unit_s=float(np.mean(frame_s)),
        chunks=-(-rays // frame['chunk']),
        model_flops=flops.model_flops(
            ref_model.param_shapes(cell.config['model']),
            cell.config['model'], rays, False))

  memory_peak = (torch.cuda.max_memory_allocated(device)
                 if device.type == 'cuda' else 0)
  config = frames.config
  frames.close()
  del frames
  gc.collect()
  if device.type == 'cuda':
    torch.cuda.empty_cache()

  harness.log(f'window of {len(kept)} frames closed')
  numbers = reference_gaps(cell, seeds, device, kept, config)
  harness.log('reference')
  frame = traffic['frame']
  rays = frame['width'] * frame['height'] * len(kept)
  return {
      'setup_s': setup_s,
      'metrics': {'render_rays_per_s': rays / window_s},
      'attempted': len(kept), 'failed': 0, 'numbers': numbers,
      'memory_peak': memory_peak, 'summary': summary, 'counts': counts,
      'units': len(kept)}
