"""Video files of rendered frames: MJPEG in an AVI container.

A port of the MJPEG branch of ``multinerf_tpu/utils/video.py``: the
machines the port runs on have neither mediapy nor imageio (nor ffmpeg),
so ``VideoWriter`` always writes ``MjpegAviWriter``'s AVI, renaming a
requested ``.mp4`` to ``.avi`` with the JAX package's printed line.  Each
frame is a baseline JPEG from ``utils/jpeg.encode_jpeg`` at quality 90,
what Pillow's ``save(..., 'JPEG', quality=90)`` writes for the JAX writer.
"""

from __future__ import annotations

import struct

import numpy as np

from multinerf_tpu_torch.utils import jpeg


class MjpegAviWriter:
  """MJPEG AVI encoder: a RIFF file with an ``hdrl`` LIST (the main and
  stream headers), a ``movi`` LIST of one ``00dc`` chunk per JPEG frame and
  an ``idx1`` index.  Frames are kept as JPEG bytes and the container is
  written at close(), when every size is known."""

  def __init__(self, path: str, fps: int, quality: int = 90):
    self._path = path
    self._fps = int(fps)
    self._quality = quality
    self._jpegs = []
    self._shape = None

  def add_image(self, frame: np.ndarray):
    """Append one u8 RGB (or grayscale) frame."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
      raise ValueError(f'MJPEG frames must be uint8, got {frame.dtype}')
    if self._shape is None:
      self._shape = frame.shape[:2]
    elif frame.shape[:2] != self._shape:
      raise ValueError(f'Frame shape {frame.shape[:2]} != {self._shape}')
    if frame.ndim == 2:  # Pillow's convert('RGB') of a grey frame.
      frame = np.repeat(frame[..., None], 3, -1)
    self._jpegs.append(jpeg.encode_jpeg(frame, self._quality))

  @staticmethod
  def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    padded = payload + (b'\0' if len(payload) % 2 else b'')
    return fourcc + struct.pack('<I', len(payload)) + padded

  @classmethod
  def _list(cls, kind: bytes, payload: bytes) -> bytes:
    return cls._chunk(b'LIST', kind + payload)

  def close(self):
    if not self._jpegs:
      return
    h, w = self._shape
    n = len(self._jpegs)
    max_bytes = max(map(len, self._jpegs))
    # Main AVI header: frame cadence, count, dimensions, HASINDEX flag.
    avih = self._chunk(b'avih', struct.pack(
        '<14I', 1_000_000 // self._fps, max_bytes * self._fps, 0, 0x10,
        n, 0, 1, max_bytes, w, h, 0, 0, 0, 0))
    # One video stream: MJPG handler at fps = rate / scale.
    strh = self._chunk(b'strh', struct.pack(
        '<4s4s10I4H', b'vids', b'MJPG', 0, 0, 0, 1, self._fps, 0, n,
        max_bytes, 0xFFFFFFFF, 0, 0, 0, int(w), int(h)))
    # BITMAPINFOHEADER with biCompression = 'MJPG'.
    strf = self._chunk(b'strf', struct.pack(
        '<I2i2H4s5I', 40, w, h, 1, 24, b'MJPG', w * h * 3, 0, 0, 0, 0))
    hdrl = self._list(b'hdrl', avih + self._list(b'strl', strh + strf))
    # Frame chunks and the idx1 index (offsets from the 'movi' tag).
    frames, index, offset = [], [], 4
    for data in self._jpegs:
      chunk = self._chunk(b'00dc', data)
      frames.append(chunk)
      index.append(struct.pack('<4s3I', b'00dc', 0x10, offset, len(data)))
      offset += len(chunk)
    movi = self._list(b'movi', b''.join(frames))
    idx1 = self._chunk(b'idx1', b''.join(index))
    with open(self._path, 'wb') as f:
      f.write(self._chunk(b'RIFF', b'AVI ' + hdrl + movi + idx1))


class VideoWriter:
  """The JAX package's writer without its mediapy and imageio branches:
  the MJPEG AVI beside the requested path (``.mp4`` -> ``.avi``).  `shape`
  and `crf` are taken for the same call and unused."""

  def __init__(self, path: str, fps: int, shape=None, crf: int = 18):
    del shape, crf
    avi_path = path.rsplit('.', 1)[0] + '.avi'
    print(f'No mp4 encoder available (mediapy/imageio+ffmpeg missing); '
          f'writing MJPEG {avi_path} instead.')
    self.path = avi_path
    self._impl = MjpegAviWriter(avi_path, fps=fps)

  def add_image(self, frame: np.ndarray):
    self._impl.add_image(frame)

  def close(self):
    self._impl.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def read_avi_frames(path: str):
  """{chunk id: [payload bytes]} of an AVI's ``movi`` list, in order (the
  frames a writer above stored), for checks that read a video back."""
  with open(path, 'rb') as f:
    data = f.read()
  if data[:4] != b'RIFF' or data[8:12] != b'AVI ':
    raise ValueError(f'{path} is not an AVI file.')
  frames = {}

  def walk(pos, end):
    while pos + 8 <= end:
      fourcc = data[pos:pos + 4]
      size, = struct.unpack('<I', data[pos + 4:pos + 8])
      body = pos + 8
      if fourcc == b'LIST':
        walk(body + 4, body + size)
      elif fourcc.endswith((b'dc', b'db')):
        frames.setdefault(fourcc, []).append(data[body:body + size])
      pos = body + size + size % 2

  walk(12, len(data))
  return frames
