"""Image files written with the standard library alone.

``save_img_u8`` (8-bit PNG) and ``save_img_f32`` (32-bit float TIFF) take
the same arguments and write the same formats as ``multinerf_tpu.utils.io``
(which uses Pillow, not installed beside the GPU).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(kind: bytes, data: bytes) -> bytes:
  return (struct.pack('>I', len(data)) + kind + data +
          struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))


def encode_png(img_u8: np.ndarray) -> bytes:
  """The PNG file of an [H, W] (gray) or [H, W, 3] (RGB) uint8 array."""
  img = np.ascontiguousarray(img_u8, np.uint8)
  if img.ndim == 2:
    color_type = 0
  elif img.ndim == 3 and img.shape[-1] == 3:
    color_type = 2
  else:
    raise ValueError(f'cannot write an image of shape {img.shape} as PNG.')
  height, width = img.shape[:2]
  rows = img.reshape(height, -1)
  # Filter type 0 (None) before every row.
  raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
  header = struct.pack('>IIBBBBB', width, height, 8, color_type, 0, 0, 0)
  return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', header) +
          _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6)) +
          _png_chunk(b'IEND', b''))


def write_png(pth: str, img_u8: np.ndarray) -> None:
  """Write an [H, W] (gray) or [H, W, 3] (RGB) uint8 array as a PNG."""
  with open(pth, 'wb') as f:
    f.write(encode_png(img_u8))


def write_tiff_f32(pth: str, img: np.ndarray) -> None:
  """Write an [H, W] array as an uncompressed little-endian float32 TIFF
  (one strip, one sample per pixel, SampleFormat = IEEE float)."""
  data = np.ascontiguousarray(img, '<f4')
  if data.ndim != 2:
    raise ValueError(f'cannot write an image of shape {data.shape} as TIFF.')
  height, width = data.shape
  pixels = data.tobytes()
  entries = [  # (tag, type, count, value); type 3 = SHORT, 4 = LONG.
      (256, 4, 1, width),            # ImageWidth
      (257, 4, 1, height),           # ImageLength
      (258, 3, 1, 32),               # BitsPerSample
      (259, 3, 1, 1),                # Compression: none
      (262, 3, 1, 1),                # PhotometricInterpretation: BlackIsZero
      (273, 4, 1, 8),                # StripOffsets: pixels follow the header
      (277, 3, 1, 1),                # SamplesPerPixel
      (278, 4, 1, height),           # RowsPerStrip
      (279, 4, 1, len(pixels)),      # StripByteCounts
      (339, 3, 1, 3),                # SampleFormat: IEEE float
  ]
  ifd = struct.pack('<H', len(entries))
  for tag, kind, count, value in entries:
    fmt = '<HHIHH' if kind == 3 else '<HHII'
    ifd += struct.pack(fmt, tag, kind, count, value, *(
        (0,) if kind == 3 else ()))
  ifd += struct.pack('<I', 0)  # No next IFD.
  with open(pth, 'wb') as f:
    f.write(b'II*\x00' + struct.pack('<I', 8 + len(pixels)) + pixels + ifd)


def to_u8(img):
  """An image in [0, 1] as uint8, NaNs as 0 (the JAX writer's rule)."""
  return (np.clip(np.nan_to_num(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def save_img_u8(img, pth):
  """Save an RGB image in [0, 1] as an 8-bit PNG."""
  write_png(pth, to_u8(img))


def save_img_f32(depthmap, pth):
  """Save a float map (e.g. depth) as a 32-bit TIFF."""
  write_tiff_f32(pth, np.nan_to_num(depthmap).astype(np.float32))
