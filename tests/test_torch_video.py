"""The port's MJPEG AVI writer (multinerf_tpu_torch/utils/video.py): the
container as the JAX package's tests/test_video.py checks it (RIFF sizes,
hdrl / movi / idx1, frame count and size, index offsets onto each chunk),
frames decoded by Pillow and by the port's decoder, the bytes against the
JAX writer's (the same container around Pillow's quality-90 JPEGs, which
the port's encoder reproduces), ``VideoWriter``'s .mp4 -> .avi, and the
render entry point's ``assemble_videos`` on stored frames."""

import io
import os
import struct
import types

import numpy as np
import pytest
from PIL import Image

from multinerf_tpu.utils import video as jax_video
from multinerf_tpu_torch import render
from multinerf_tpu_torch.utils import io as io_lib
from multinerf_tpu_torch.utils import jpeg
from multinerf_tpu_torch.utils import video as video_lib


def _frames(n=5, h=24, w=32):
  base = np.linspace(0, 200, h)[:, None, None] + np.linspace(
      0, 55, w)[None, :, None]
  return [np.clip(base + 10 * i, 0, 255).astype(np.uint8) * np.ones(
      3, np.uint8) for i in range(n)]


def _write(writer_cls, path, frames, fps=4):
  writer = writer_cls(path, fps=fps)
  for f in frames:
    writer.add_image(f)
  writer.close()
  with open(path, 'rb') as f:
    return f.read()


def _read_chunks(data, start, end):
  pos = start
  while pos < end:
    fourcc = data[pos:pos + 4]
    (size,) = struct.unpack('<I', data[pos + 4:pos + 8])
    yield fourcc, pos + 8, size
    pos += 8 + size + (size % 2)


def test_container_structure_and_index(tmp_path):
  frames = _frames()
  data = _write(video_lib.MjpegAviWriter, str(tmp_path / 'clip.avi'), frames)
  assert data[:4] == b'RIFF' and data[8:12] == b'AVI '
  (riff_size,) = struct.unpack('<I', data[4:8])
  assert 8 + riff_size == len(data)
  lists = {}
  for fourcc, start, size in _read_chunks(data, 12, len(data)):
    lists[data[start:start + 4] if fourcc == b'LIST' else fourcc] = (start,
                                                                    size)
  assert set(lists) >= {b'hdrl', b'movi', b'idx1'}
  hdrl_start, _ = lists[b'hdrl']
  avih = struct.unpack('<14I', data[hdrl_start + 12:hdrl_start + 68])
  assert avih[4] == len(frames) and (avih[8], avih[9]) == (32, 24)
  assert avih[3] & 0x10
  movi_start, movi_size = lists[b'movi']
  chunks = list(_read_chunks(data, movi_start + 4, movi_start + movi_size))
  assert [c[0] for c in chunks] == [b'00dc'] * len(frames)
  idx_start, idx_size = lists[b'idx1']
  assert idx_size == 16 * len(frames)
  for i, (_, payload_start, payload_size) in enumerate(chunks):
    tag, flags, offset, size = struct.unpack(
        '<4s3I', data[idx_start + 16 * i:idx_start + 16 * (i + 1)])
    assert tag == b'00dc' and flags & 0x10
    assert movi_start + offset + 8 == payload_start
    assert size == payload_size


def test_frames_decode_back(tmp_path):
  frames = _frames(3)
  path = str(tmp_path / 'clip.avi')
  _write(video_lib.MjpegAviWriter, path, frames)
  stored = video_lib.read_avi_frames(path)[b'00dc']
  assert len(stored) == 3
  for data, want in zip(stored, frames):
    theirs = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), theirs)
    assert theirs.shape == want.shape
    assert np.abs(theirs.astype(float) - want).mean() < 3


@pytest.mark.parametrize('grey', [False, True])
def test_bytes_match_the_jax_writer(tmp_path, grey):
  frames = _frames(4, 32, 48)
  if grey:
    frames = [f[..., 0] for f in frames]
  ours = _write(video_lib.MjpegAviWriter, str(tmp_path / 'a.avi'), frames)
  theirs = _write(jax_video.MjpegAviWriter, str(tmp_path / 'b.avi'), frames)
  assert ours == theirs


def test_videowriter_writes_avi(tmp_path, capsys):
  path = str(tmp_path / 'out.mp4')
  with video_lib.VideoWriter(path, fps=2, shape=(8, 8)) as w:
    for _ in range(2):
      w.add_image(np.zeros((8, 8, 3), np.uint8))
  assert w.path == str(tmp_path / 'out.avi')
  assert open(w.path, 'rb').read(4) == b'RIFF' and not os.path.exists(path)
  assert 'writing MJPEG' in capsys.readouterr().out


def test_rejects_bad_frames(tmp_path):
  writer = video_lib.MjpegAviWriter(str(tmp_path / 'x.avi'), fps=2)
  with pytest.raises(ValueError):
    writer.add_image(np.zeros((4, 4, 3), np.float32))
  writer.add_image(np.zeros((4, 4, 3), np.uint8))
  with pytest.raises(ValueError):
    writer.add_image(np.zeros((8, 4, 3), np.uint8))


def test_assemble_videos(tmp_path):
  rng = np.random.RandomState(0)
  n, h, w = 3, 16, 24
  store = render.FrameStore(str(tmp_path / 'frames'), n, use_async=False)
  renderings = []
  for i in range(n):
    rendering = {'rgb': rng.rand(h, w, 3).astype(np.float32),
                 'acc': rng.rand(h, w).astype(np.float32),
                 'distance_mean': 1 + 5 * rng.rand(h, w).astype(np.float32),
                 'distance_median': 1 + 5 * rng.rand(h, w).astype(np.float32)}
    store.put(rendering, i)
    renderings.append(rendering)
  np.testing.assert_array_equal(store.get('acc', 1), renderings[1]['acc'])
  np.testing.assert_array_equal(store.get('color', 2),
                                io_lib.to_u8(renderings[2]['rgb']))
  config = types.SimpleNamespace(
      checkpoint_dir='/x/exp/scene', render_dist_percentile=0.5,
      render_dist_curve_fn=np.log, render_video_fps=60, render_video_crf=18)
  assert render.video_name_prefix(config, 'path') == 'scene_exp_path'
  written = render.assemble_videos(config, store, str(tmp_path / 'v'),
                                   'path', n)
  tags = ['color', 'acc', 'distance_mean', 'distance_median']
  assert written == [str(tmp_path / 'v' / f'scene_exp_path_{t}.avi')
                     for t in tags]
  for path in written:
    stored = video_lib.read_avi_frames(path)[b'00dc']
    assert len(stored) == n
    assert jpeg.decode_jpeg(stored[0]).shape == (h, w, 3)
