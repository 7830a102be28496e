"""Image files read and written with the standard library and numpy alone.

``save_img_u8`` (8-bit PNG) and ``save_img_f32`` (32-bit float TIFF) take
the same arguments and write the same formats as ``multinerf_tpu.utils.io``
(which uses Pillow, not installed beside the GPU).  ``load_img`` reads into
the array Pillow gives: 8-bit PNGs (grey, grey + alpha, RGB, RGBA; every
filter type; not interlaced), JPEGs (``utils/jpeg.py``) and striped TIFFs
(uncompressed, LZW or Deflate; 8, 16 or 32-bit samples, 1-4 per pixel,
either byte order).  ``load_exif`` reads the Exif tags of a JPEG by name, as
the JAX package's Pillow call names them.
"""

from __future__ import annotations

import fractions
import struct
import zlib

import numpy as np

from multinerf_tpu_torch.utils import jpeg

_JPEG_SOI = b'\xff\xd8'  # A JPEG file's first marker.
_TIFF_HEADERS = (b'II*\x00', b'MM\x00*')


def _png_chunk(kind: bytes, data: bytes) -> bytes:
  return (struct.pack('>I', len(data)) + kind + data +
          struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))


def encode_png(img_u8: np.ndarray) -> bytes:
  """The PNG file of an [H, W] (gray) or [H, W, C] (gray + alpha, RGB,
  RGBA) uint8 array."""
  img = np.ascontiguousarray(img_u8, np.uint8)
  if img.ndim == 2:
    color_type = 0
  elif img.ndim == 3 and img.shape[-1] in (2, 3, 4):
    color_type = {2: 4, 3: 2, 4: 6}[img.shape[-1]]
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


_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # Color type -> samples per pixel.


def _paeth(a, b, c):
  p = a + b - c
  pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
  if pa <= pb and pa <= pc:
    return a
  return b if pb <= pc else c


def _unfilter_row(kind, row, prior, bpp):
  """One scanline's bytes (uint8 [stride]) with its filter undone, given
  the reconstructed row above (zeros for the first)."""
  if kind == 0:  # None
    return row
  if kind == 1:  # Sub: a running sum per sample, modulo 256.
    sums = np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0)
    return (sums % 256).astype(np.uint8).reshape(-1)
  if kind == 2:  # Up
    return (row.astype(np.int64) + prior).astype(np.uint8)
  if kind not in (3, 4):
    raise ValueError(f'bad PNG filter type {kind}')
  out = bytearray(row.tobytes())
  up = prior.tobytes()
  for i in range(len(out)):
    left = out[i - bpp] if i >= bpp else 0
    if kind == 3:  # Average
      pred = (left + up[i]) >> 1
    else:  # Paeth
      pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
    out[i] = (out[i] + pred) & 0xff
  return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
  """The uint8 array of an 8-bit, non-interlaced PNG file: [H, W] grey, or
  [H, W, C] for grey + alpha (2), RGB (3) and RGBA (4)."""
  if data[:8] != _PNG_SIGNATURE:
    raise ValueError('not a PNG file.')
  pos, idat, header = 8, [], None
  while pos < len(data):
    length, = struct.unpack('>I', data[pos:pos + 4])
    kind = data[pos + 4:pos + 8]
    body = data[pos + 8:pos + 8 + length]
    pos += 12 + length
    if kind == b'IHDR':
      header = struct.unpack('>IIBBBBB', body)
    elif kind == b'IDAT':
      idat.append(body)
    elif kind == b'IEND':
      break
  width, height, depth, color_type, _, _, interlace = header
  if depth != 8 or color_type not in _PNG_CHANNELS or interlace:
    raise ValueError(f'unsupported PNG: bit depth {depth}, color type '
                     f'{color_type}, interlace {interlace}')
  channels = _PNG_CHANNELS[color_type]
  stride = width * channels
  raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8).reshape(
      height, stride + 1)
  rows = []
  prior = np.zeros(stride, np.uint8)
  for y in range(height):
    prior = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, channels)
    rows.append(prior)
  img = np.stack(rows).reshape(height, width, channels)
  return img[..., 0] if channels == 1 else img


def read_image(pth: str) -> np.ndarray:
  """The array of a PNG, JPEG or TIFF file, as ``np.asarray(Image.open())``
  gives it."""
  with open(pth, 'rb') as f:
    data = f.read()
  if data[:2] == _JPEG_SOI:
    return jpeg.decode_jpeg(data)
  if data[:4] in _TIFF_HEADERS:
    return decode_tiff(data)
  return decode_png(data)


def load_img(pth: str) -> np.ndarray:
  """Load an image as float32 (no scaling applied), as utils/io.py:24-27."""
  return read_image(pth).astype(np.float32)


# --- Exif. --------------------------------------------------------------------

_EXIF_IFD = 0x8769  # The Exif sub-IFD's offset, a tag of IFD0.
# The names of the Exif tags (Pillow's ExifTags.TAGS for these ids).
EXIF_TAGS = {
    0x010F: 'Make', 0x0110: 'Model', 0x0112: 'Orientation',
    0x011A: 'XResolution', 0x011B: 'YResolution', 0x0128: 'ResolutionUnit',
    0x0131: 'Software', 0x0132: 'DateTime', 0x013B: 'Artist',
    0x0213: 'YCbCrPositioning', 0x8298: 'Copyright', _EXIF_IFD: 'ExifOffset',
    0x829A: 'ExposureTime', 0x829D: 'FNumber', 0x8822: 'ExposureProgram',
    0x8827: 'ISOSpeedRatings', 0x8830: 'SensitivityType',
    0x9000: 'ExifVersion', 0x9003: 'DateTimeOriginal',
    0x9004: 'DateTimeDigitized', 0x9201: 'ShutterSpeedValue',
    0x9202: 'ApertureValue', 0x9203: 'BrightnessValue',
    0x9204: 'ExposureBiasValue', 0x9205: 'MaxApertureValue',
    0x9207: 'MeteringMode', 0x9208: 'LightSource', 0x9209: 'Flash',
    0x920A: 'FocalLength', 0xA001: 'ColorSpace', 0xA002: 'ExifImageWidth',
    0xA003: 'ExifImageHeight', 0xA402: 'ExposureMode',
    0xA403: 'WhiteBalance', 0xA405: 'FocalLengthIn35mmFilm',
    0xA406: 'SceneCaptureType', 0xA434: 'LensModel',
}
# TIFF field type -> (struct code, bytes per value).
_TIFF_TYPES = {1: ('B', 1), 2: ('s', 1), 3: ('H', 2), 4: ('I', 4),
               5: ('II', 8), 6: ('b', 1), 7: ('s', 1), 8: ('h', 2),
               9: ('i', 4), 10: ('ii', 8), 11: ('f', 4), 12: ('d', 8)}


def _rational(num, den):
  """A TIFF (S)RATIONAL: exact, usable through float(); NaN over 0."""
  return fractions.Fraction(num, den) if den else float('nan')


def _tiff_value(tiff, order, kind, count, field):
  """One IFD entry's value: a scalar for one value, else a tuple; text as
  str, UNDEFINED as bytes."""
  code, size = _TIFF_TYPES[kind]
  nbytes = size * count
  if nbytes > 4:
    offset, = struct.unpack(order + 'I', field)
    raw = tiff[offset:offset + nbytes]
  else:
    raw = field[:nbytes]
  if kind == 2:
    return raw.split(b'\x00', 1)[0].decode('latin-1')
  if kind == 7:
    return bytes(raw)
  if kind in (5, 10):
    pairs = struct.unpack(order + code * count, raw)
    values = tuple(_rational(n, d) for n, d in zip(pairs[::2], pairs[1::2]))
  else:
    values = struct.unpack(f'{order}{count}{code}', raw)
  return values[0] if count == 1 else values


def _read_ifd(tiff, order, offset):
  """The {tag id: value} of the IFD at `offset` of a TIFF block."""
  count, = struct.unpack(order + 'H', tiff[offset:offset + 2])
  out = {}
  for i in range(count):
    entry = tiff[offset + 2 + 12 * i:offset + 14 + 12 * i]
    tag, kind, n = struct.unpack(order + 'HHI', entry[:8])
    if kind in _TIFF_TYPES:
      out[tag] = _tiff_value(tiff, order, kind, n, entry[8:12])
  return out


def parse_tiff_exif(tiff: bytes):
  """{tag id: value} of a TIFF block's IFD0 and its Exif sub-IFD, in either
  byte order."""
  order = {b'II': '<', b'MM': '>'}.get(tiff[:2])
  if order is None:
    raise ValueError('not a TIFF header.')
  ifd0, = struct.unpack(order + 'I', tiff[4:8])
  tags = _read_ifd(tiff, order, ifd0)
  if _EXIF_IFD in tags:
    tags.update(_read_ifd(tiff, order, tags[_EXIF_IFD]))
  return tags


def _jpeg_exif_block(data: bytes):
  """The TIFF block of a JPEG's APP1 Exif segment, or None."""
  pos = 2
  while pos + 4 <= len(data):
    if data[pos] != 0xFF:
      return None
    marker = data[pos + 1]
    if marker == 0xFF:  # Fill byte.
      pos += 1
      continue
    if marker in (0xD9, 0xDA):  # EOI, or the scan: no header follows.
      return None
    length, = struct.unpack('>H', data[pos + 2:pos + 4])
    body = data[pos + 4:pos + 2 + length]
    if marker == 0xE1 and body[:6] == b'Exif\x00\x00':
      return body[6:]
    pos += 2 + length
  return None


def load_exif(pth: str):
  """The named Exif tags of a JPEG (utils/io.py:31-37 of the JAX package,
  without Pillow): IFD0 and the Exif sub-IFD of its APP1 segment.
  Rationals are exact (``float()`` gives their value), SHORTs and LONGs
  ints.  {} for any other file (a PNG), or a JPEG without Exif."""
  with open(pth, 'rb') as f:
    data = f.read()
  tiff = _jpeg_exif_block(data) if data[:2] == _JPEG_SOI else None
  if tiff is None:
    return {}
  tags = parse_tiff_exif(tiff)
  return {EXIF_TAGS[tag]: value for tag, value in tags.items()
          if tag in EXIF_TAGS}


# --- TIFF images. -------------------------------------------------------------

# (SampleFormat, BitsPerSample) -> numpy type: unsigned, signed, IEEE float.
_TIFF_DTYPES = {(1, 8): 'u1', (1, 16): 'u2', (2, 16): 'i2', (1, 32): 'u4',
                (2, 32): 'i4', (3, 32): 'f4'}


def lzw_decode(data: bytes) -> bytes:
  """TIFF's LZW (compression 5): MSB-first codes of 9 to 12 bits, 256 to
  clear, 257 to end, the code width growing one code early."""
  win = jpeg.bit_windows(data)
  end = 8 * len(data)
  out = bytearray()
  table = [bytes([i]) for i in range(256)] + [b'', b'']
  width, p, prev = 9, 0, None
  while p + width <= end:
    code = (win[p >> 3] >> (32 - (p & 7) - width)) & ((1 << width) - 1)
    p += width
    if code == 257:
      break
    if code == 256:
      del table[258:]
      width, prev = 9, None
      continue
    if prev is None:
      entry = table[code]
    else:
      entry = table[code] if code < len(table) else prev + prev[:1]
      table.append(prev + entry[:1])
    out += entry
    prev = entry
    n = len(table) + 1
    width = 9 if n < 512 else 10 if n < 1024 else 11 if n < 2048 else 12
  return bytes(out)


def decode_tiff(data: bytes) -> np.ndarray:
  """The array of IFD0 of a striped TIFF: [H, W] for one sample a pixel,
  else [H, W, C]; compression none, LZW or Deflate, with or without the
  horizontal predictor; chunky samples of one type (``_TIFF_DTYPES``)."""
  order = {b'II': '<', b'MM': '>'}.get(data[:2])
  if order is None or data[:4] not in _TIFF_HEADERS:
    raise ValueError('not a TIFF file.')
  ifd0, = struct.unpack(order + 'I', data[4:8])
  tags = _read_ifd(data, order, ifd0)
  as_tuple = lambda v: v if isinstance(v, tuple) else (v,)
  width, height = tags[256], tags[257]
  channels = tags.get(277, 1)
  bits = set(as_tuple(tags.get(258, 1)))
  fmts = set(as_tuple(tags.get(339, 1)))
  key = (fmts.pop(), bits.pop()) if len(bits) == len(fmts) == 1 else None
  if key not in _TIFF_DTYPES:
    raise NotImplementedError(f'TIFF samples of {tags.get(258)} bits, '
                              f'format {tags.get(339, 1)}.')
  compression = tags.get(259, 1)
  predictor = tags.get(317, 1)
  if tags.get(284, 1) != 1 or 322 in tags:
    raise NotImplementedError('planar or tiled TIFF: only chunky strips.')
  if tags.get(262, 1) not in (1, 2):
    raise NotImplementedError(
        f'TIFF photometric interpretation {tags.get(262)}: only grey and '
        'RGB(A).')
  if compression not in (1, 5, 8, 32946) or predictor not in (1, 2):
    raise NotImplementedError(f'TIFF compression {compression}, predictor '
                              f'{predictor}: none, LZW and Deflate, with '
                              'or without the horizontal predictor.')
  strips = []
  for offset, count in zip(as_tuple(tags[273]), as_tuple(tags[279])):
    raw = data[offset:offset + count]
    if compression == 5:
      raw = lzw_decode(raw)
    elif compression in (8, 32946):
      raw = zlib.decompress(raw)
    strips.append(raw)
  dtype = np.dtype(order + _TIFF_DTYPES[key])
  count = height * width * channels
  img = np.frombuffer(b''.join(strips), dtype, count).reshape(
      height, width, channels)
  if predictor == 2:  # Horizontal differencing, per sample, wrapping.
    img = np.cumsum(img, axis=1, dtype=dtype)
  img = img.astype(dtype.newbyteorder('='))
  return img[..., 0] if channels == 1 else img


def write_png(pth: str, img_u8: np.ndarray) -> None:
  """Write an [H, W] or [H, W, C] uint8 array as a PNG (``encode_png``)."""
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
