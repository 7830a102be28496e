"""Render entry point of the port: render test views or a camera path.

    python -m multinerf_tpu_torch.render --gin_configs=configs/360.gin \
        --gin_bindings="Config.checkpoint_dir='...'" [--device=cuda]

A port of render.py:50-252 with the same flags, frame striping over jobs
(``Config.render_job_id`` / ``render_num_jobs``), resume by skipping
finished frames, latest-checkpoint restore and output file names.  Frames
are rendered by the device-casting renderer, or from host-cast rays for a
pano camera (``Config.render_camtype = 'pano'``, render.py:222-227).  When
every frame is on disk,
the job assembles one video per channel as render.py:105-147 does (frames
read back, depth through one normalization fit on frame 0 and the turbo
colormap), written as MJPEG AVIs (``utils/video.py``: the card's machine
has no h264 encoder).  ``--device`` defaults to ``cuda`` and the run fails
when CUDA is not available: there is no silent CPU fallback.  Under
``torch.distributed.run`` every rank renders its rows of each frame, and
rank 0 writes the frames and assembles the videos (render.py:189, 250).
"""

from __future__ import annotations

import concurrent.futures
import glob
import os
import sys
import time

import numpy as np

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.models import nerf as models
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib
from multinerf_tpu_torch.utils import io as io_lib
from multinerf_tpu_torch.utils import video as video_lib
from multinerf_tpu_torch.utils import visualize as vis

# The JAX render script's key (render.py:218): the same seed initializes the
# weights when no checkpoint exists.
SEED = 20200823

# Channels written per frame, each a video: tag -> (file extension,
# u8-encoded?).
VIDEO_TAGS = {
    'color': ('png', True),
    'normals': ('png', True),
    'acc': ('tiff', False),
    'distance_mean': ('tiff', False),
    'distance_median': ('tiff', False),
}


class FrameStore:
  """On-disk frames of one render job: naming, async writes, existence,
  reading frames back for the videos."""

  def __init__(self, out_dir, num_frames, use_async=True):
    self.out_dir = out_dir
    self._digits = max(3, len(str(num_frames - 1)))
    self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=4)
                  if use_async else None)
    self._writes = []
    if mesh.is_main():
      os.makedirs(out_dir, exist_ok=True)

  def frame_name(self, tag, idx):
    return os.path.join(self.out_dir,
                        f'{tag}_{idx:0{self._digits}d}.{VIDEO_TAGS[tag][0]}')

  def has_frame(self, idx):
    return os.path.exists(self.frame_name('color', idx))

  def count_frames(self, tag='acc'):
    return len(glob.glob(os.path.join(self.out_dir,
                                      f'{tag}_*.{VIDEO_TAGS[tag][0]}')))

  def _write(self, fn, *args):
    if self._pool is not None:
      self._writes.append(self._pool.submit(fn, *args))
    else:
      fn(*args)

  def put(self, rendering, idx):
    """Queue one frame's channel images for writing."""
    self._write(io_lib.save_img_u8, rendering['rgb'],
                self.frame_name('color', idx))
    if 'normals' in rendering:
      self._write(io_lib.save_img_u8, rendering['normals'] / 2 + 0.5,
                  self.frame_name('normals', idx))
    for tag in ('distance_mean', 'distance_median', 'acc'):
      self._write(io_lib.save_img_f32, rendering[tag],
                  self.frame_name(tag, idx))

  def flush(self):
    """Finish pending writes; re-raise any worker exception."""
    if self._pool is not None:
      self._pool.shutdown(wait=True)
      for w in self._writes:
        w.result()

  def get(self, tag, idx):
    return io_lib.load_img(self.frame_name(tag, idx))


def video_name_prefix(config, out_name):
  """'{scene}_{experiment}_{out_name}' from the checkpoint path's tail."""
  parts = [p for p in config.checkpoint_dir.split('/') if p]
  if len(parts) >= 2:
    experiment, scene = parts[-2], parts[-1]
  else:
    experiment, scene = 'exp', parts[-1]
  return f'{scene}_{experiment}_{out_name}'


def assemble_videos(config, store, base_dir, out_name, num_frames):
  """Encode each rendered channel's frame sequence into a video; returns
  the paths written."""
  prefix = video_name_prefix(config, out_name)
  os.makedirs(base_dir, exist_ok=True)

  # Depth channels share one display normalization, fit on frame 0.
  first_depth = store.get('distance_mean', 0)
  shape = first_depth.shape[:2]
  p = config.render_dist_percentile
  span = np.percentile(first_depth.flatten(), [p, 100 - p])
  d_lo, d_hi = [config.render_dist_curve_fn(x) for x in span]
  print(f'Video shape is {shape}')

  def decode(tag, idx):
    """Read one stored frame back as float RGB in [0, 1]."""
    img = store.get(tag, idx)
    if VIDEO_TAGS[tag][1]:  # u8-encoded channels.
      return img / 255.0
    if tag.startswith('distance'):
      curved = np.asarray(config.render_dist_curve_fn(img))
      unit = np.clip((curved - min(d_lo, d_hi)) / abs(d_hi - d_lo), 0, 1)
      return np.asarray(vis.turbo(unit))[..., :3]
    return img

  written = []
  for tag in VIDEO_TAGS:
    if not os.path.exists(store.frame_name(tag, 0)):
      print(f'Images missing for tag {tag}')
      continue
    video_file = os.path.join(base_dir, f'{prefix}_{tag}.mp4')
    print(f'Making video {video_file}...')
    with video_lib.VideoWriter(video_file, fps=config.render_video_fps,
                               shape=shape,
                               crf=config.render_video_crf) as writer:
      for idx in range(num_frames):
        if not os.path.exists(store.frame_name(tag, idx)):
          raise ValueError(
              f'Image file {store.frame_name(tag, idx)} does not exist.')
        frame = np.clip(np.nan_to_num(decode(tag, idx)), 0, 1)
        writer.add_image((frame * 255).astype(np.uint8))
    written.append(writer.path)
  return written


def plan_frames(config, store, num_frames):
  """This job's frame indices: stripe across jobs, skip finished work.

  A frame is skipped only when its successor in the stripe also exists:
  the last written frame may be partial, so it is always re-rendered.
  """
  stride = config.render_num_jobs
  for idx in range(config.render_job_id, num_frames, stride):
    if store.has_frame(idx) and store.has_frame(idx + stride):
      print(f'Image {idx}/{num_frames} already exists, skipping')
      continue
    yield idx


def render_job(config, dataset, renderer, store, postprocess_fn):
  """Render this job's frames (on every rank; rank 0 writes them).  Returns
  {'frames', 'seconds', 'renderings'}: frame indices, seconds per frame
  (render + fetch) and the host renderings."""
  out = {'frames': [], 'seconds': [], 'renderings': {}}
  # Planned before any frame is written, so that every rank plans the same.
  for idx in list(plan_frames(config, store, dataset.size)):
    print(f'Evaluating image {idx + 1}/{dataset.size}')
    t0 = time.perf_counter()
    rendering = renderer(1.0, idx)
    seconds = time.perf_counter() - t0
    print(f'Rendered in {seconds:0.3f}s')
    rendering['rgb'] = postprocess_fn(rendering['rgb'])
    if mesh.is_main():
      store.put(rendering, idx)
    out['frames'].append(idx)
    out['seconds'].append(seconds)
    out['renderings'][idx] = rendering
  store.flush()
  return out


def parse_flags(argv=None):
  """This entry point's command line: ``configs.parse_entry_flags``."""
  return configs.parse_entry_flags('Render frames of a model.', argv)


def main(argv=None):
  """Run one render job; returns render_job's summary plus 'out_dir' and
  'videos' (the paths written, none until every frame is on disk)."""
  args = parse_flags(argv)
  device = configs.setup_device(args.device)

  config = configs.load_config(args)
  dataset = datasets.load_dataset('test', config.data_dir, config)
  _, state, render_eval_fn, _, _ = train_lib.setup_model(config, SEED,
                                                         device)
  renderer = models.choose_renderer(render_eval_fn, config, dataset, device)
  postprocess_fn, _ = image_ops.make_postprocess_fns(config, dataset)

  ckpt = ckpt_lib.CheckpointManager(config.checkpoint_dir, keep=100)
  # The model's own parameters, restored in place; no optimizer state.
  state = ckpt.restore_latest(ckpt_lib.TrainState(step=0,
                                                  params=state.params))
  print(f'Rendering checkpoint at step {state.step}.')

  out_name = 'path_renders' if config.render_path else 'test_preds'
  out_name = f'{out_name}_step_{state.step}'
  base_dir = config.render_dir
  if base_dir is None:
    base_dir = os.path.join(config.checkpoint_dir, 'render')
  store = FrameStore(os.path.join(base_dir, out_name), dataset.size,
                     use_async=config.render_save_async)
  summary = render_job(config, dataset, renderer, store, postprocess_fn)
  summary['videos'] = []
  # Whichever job finishes the set assembles the videos, on rank 0.
  if mesh.is_main() and store.count_frames() == dataset.size:
    print(f'All files found, creating videos (job {config.render_job_id}).')
    summary['videos'] = assemble_videos(config, store, base_dir, out_name,
                                        dataset.size)
  summary['out_dir'] = store.out_dir
  return summary


if __name__ == '__main__':
  main(sys.argv[1:])
  mesh.shutdown()
