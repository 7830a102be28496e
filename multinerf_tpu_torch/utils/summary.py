"""TensorBoard event files without the ``tensorboard`` package.

``SummaryWriter`` stands in for ``flax.metrics.tensorboard.SummaryWriter``
(``scalar``, ``image``, ``histogram``, ``text``): it writes
``events.out.tfevents.*`` files that TensorBoard reads.  A file is a
sequence of TFRecords (a little-endian uint64 length, its masked CRC32C,
the bytes, their masked CRC32C), each an ``Event`` protobuf encoded here by
hand: the first holds the file version, every later one a ``Summary`` of
one value.  Scalars are ``simple_value``s, images PNGs (``utils/io.py``'s
encoder), histograms ``HistogramProto``s of 30 equal buckets, and text a
string tensor tagged for the text plugin.  ``read_events`` reads such files
back, checking every CRC.  Across ranks only rank 0 writes
(``writer_for_rank``).

CRC32C is the Castagnoli polynomial (not ``zlib.crc32``'s).  Long records
(images) are cut into equal blocks whose CRC registers advance together in
numpy, then joined with the operator that moves a register over one block.
"""

from __future__ import annotations

import functools
import glob
import os
import socket
import struct
import time

import numpy as np

from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.utils import io as io_lib

# --- CRC32C -----------------------------------------------------------------

_POLY = 0x82F63B78  # Castagnoli, bit-reflected.


def _byte_table():
  t = np.arange(256, dtype=np.uint32)
  for _ in range(8):
    t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
  return t


_TABLE = _byte_table()
_TABLE_LIST = _TABLE.tolist()
_VECTOR_MIN = 16384  # Shorter inputs take the byte loop.


def _advance(reg: int, data) -> int:
  """The CRC register after `data` (bytes), one byte at a time."""
  t = _TABLE_LIST
  for b in data:
    reg = t[(reg ^ b) & 0xff] ^ (reg >> 8)
  return reg


@functools.lru_cache(maxsize=None)
def _skip_tables(length: int):
  """Four 256-entry tables whose XOR over a register's bytes is the
  register after `length` zero bytes: the register's own share of a
  block's CRC (the map is linear over GF(2))."""
  cols = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
  for _ in range(length):
    cols = _TABLE[cols & 0xff] ^ (cols >> 8)
  values = np.arange(256)
  tables = []
  for byte in range(4):
    out = np.zeros(256, np.uint32)
    for bit in range(8):
      out ^= np.where((values >> bit) & 1, cols[8 * byte + bit], 0).astype(
          np.uint32)
    tables.append(out.tolist())
  return tables


def crc32c(data: bytes) -> int:
  """CRC-32C (Castagnoli) of `data`, as in RFC 3720."""
  data = memoryview(data).cast('B')
  n = len(data)
  reg = 0xFFFFFFFF
  done = 0
  if n >= _VECTOR_MIN:
    # Blocks of a power-of-two length near sqrt(n), all advanced at once.
    block = 1 << max(8, (int(np.sqrt(n)) - 1).bit_length())
    count = n // block
    lanes = np.ascontiguousarray(np.frombuffer(
        data, np.uint8, count * block).reshape(count, block).T)
    regs = np.zeros(count, np.uint32)
    for column in lanes:
      regs = _TABLE[(regs ^ column) & 0xff] ^ (regs >> 8)
    t0, t1, t2, t3 = _skip_tables(block)
    for r in regs.tolist():
      reg = (t0[reg & 0xff] ^ t1[(reg >> 8) & 0xff] ^
             t2[(reg >> 16) & 0xff] ^ t3[reg >> 24] ^ r)
    done = count * block
  return _advance(reg, data[done:]) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
  """The TFRecord checksum: CRC32C rotated right by 15, plus a constant."""
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- Protobuf wire format -----------------------------------------------------


def _varint(value: int) -> bytes:
  out = bytearray()
  while True:
    low = value & 0x7f
    value >>= 7
    if value:
      out.append(low | 0x80)
    else:
      out.append(low)
      return bytes(out)


def _key(field: int, wire: int) -> bytes:
  return _varint(field << 3 | wire)


def _int_field(field: int, value: int) -> bytes:
  return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _double_field(field: int, value: float) -> bytes:
  return _key(field, 1) + struct.pack('<d', value)


def _float_field(field: int, value: float) -> bytes:
  return _key(field, 5) + struct.pack('<f', value)


def _bytes_field(field: int, value: bytes) -> bytes:
  return _key(field, 2) + _varint(len(value)) + value


def _packed_doubles(field: int, values) -> bytes:
  return _bytes_field(field, np.asarray(values, '<f8').tobytes())


def _parse(buf: bytes):
  """[(field, wire type, value)] of one message; value is an int (varint),
  bytes (length-delimited) or the raw 8 / 4 bytes of a fixed field."""
  out, pos = [], 0
  while pos < len(buf):
    key, pos = _read_varint(buf, pos)
    field, wire = key >> 3, key & 7
    if wire == 0:
      value, pos = _read_varint(buf, pos)
    elif wire == 1:
      value, pos = buf[pos:pos + 8], pos + 8
    elif wire == 2:
      size, pos = _read_varint(buf, pos)
      value, pos = buf[pos:pos + size], pos + size
    elif wire == 5:
      value, pos = buf[pos:pos + 4], pos + 4
    else:
      raise ValueError(f'unsupported protobuf wire type {wire}')
    out.append((field, wire, value))
  return out


def _read_varint(buf: bytes, pos: int):
  shift = value = 0
  while True:
    b = buf[pos]
    pos += 1
    value |= (b & 0x7f) << shift
    shift += 7
    if not b & 0x80:
      return value, pos


# --- Writer -------------------------------------------------------------------

_DT_STRING = 7  # tensorflow.DataType


def _image_u8(image) -> np.ndarray:
  """[H, W], [H, W, 1] or [H, W, 3] values in [0, 1] -> uint8."""
  image = np.asarray(image)
  if image.ndim == 3 and image.shape[-1] == 1:
    image = image[..., 0]
  return image if image.dtype == np.uint8 else io_lib.to_u8(image)


class SummaryWriter:
  """Writes TensorBoard summaries into one event file under `log_dir`."""

  def __init__(self, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    self.path = os.path.join(
        log_dir, f'events.out.tfevents.{int(time.time())}.'
        f'{socket.gethostname()}.{os.getpid()}')
    self._file = open(self.path, 'wb')
    self._write_event(_bytes_field(3, b'brain.Event:2'), step=0)

  def _write_event(self, what: bytes, step: int):
    event = (_double_field(1, time.time()) + _int_field(2, int(step)) + what)
    header = struct.pack('<Q', len(event))
    self._file.write(header + struct.pack('<I', masked_crc32c(header)) +
                     event + struct.pack('<I', masked_crc32c(event)))
    self._file.flush()

  def _write_value(self, tag: str, value: bytes, step: int):
    summary_value = _bytes_field(1, tag.encode()) + value
    self._write_event(_bytes_field(5, _bytes_field(1, summary_value)), step)

  def scalar(self, tag: str, value, step: int):
    self._write_value(tag, _float_field(2, float(value)), step)

  def image(self, tag: str, image, step: int):
    """An image with values in [0, 1] (or uint8), as a PNG."""
    img = _image_u8(image)
    proto = (_int_field(1, img.shape[0]) + _int_field(2, img.shape[1]) +
             _int_field(3, 1 if img.ndim == 2 else 3) +
             _bytes_field(4, io_lib.encode_png(img)))
    self._write_value(tag, _bytes_field(4, proto), step)

  def histogram(self, tag: str, values, step: int, bins: int = 30):
    values = np.asarray(values, np.float64).reshape(-1)
    counts, edges = np.histogram(values, bins=bins)
    proto = (_double_field(1, values.min()) + _double_field(2, values.max()) +
             _double_field(3, values.size) + _double_field(4, values.sum()) +
             _double_field(5, np.sum(values**2)) +
             _packed_doubles(6, edges[1:]) + _packed_doubles(7, counts))
    self._write_value(tag, _bytes_field(5, proto), step)

  def text(self, tag: str, textdata: str, step: int):
    tensor = _int_field(1, _DT_STRING) + _bytes_field(2, b'') + _bytes_field(
        8, textdata.encode())
    metadata = _bytes_field(1, _bytes_field(1, b'text'))
    self._write_value(tag, _bytes_field(9, metadata) + _bytes_field(8, tensor),
                      step)

  def close(self):
    self._file.close()


class NullWriter:
  """A SummaryWriter's calls, writing nothing: the writer of every rank
  but rank 0."""

  def scalar(self, tag, value, step):
    del tag, value, step

  image = histogram = text = scalar

  def close(self):
    pass


def writer_for_rank(log_dir: str):
  """A SummaryWriter under `log_dir` on rank 0 (train.py:218 of the JAX
  package), a NullWriter on the other ranks."""
  return SummaryWriter(log_dir) if mesh.is_main() else NullWriter()


# --- Reader -------------------------------------------------------------------


def _records(path: str):
  """The payloads of a TFRecord file, every CRC checked."""
  with open(path, 'rb') as f:
    data = f.read()
  pos = 0
  while pos < len(data):
    header = data[pos:pos + 8]
    (size,) = struct.unpack('<Q', header)
    (header_crc,) = struct.unpack('<I', data[pos + 8:pos + 12])
    payload = data[pos + 12:pos + 12 + size]
    (payload_crc,) = struct.unpack('<I', data[pos + 12 + size:pos + 16 + size])
    if (header_crc != masked_crc32c(header) or
        payload_crc != masked_crc32c(payload)):
      raise ValueError(f'{path}: a record at byte {pos} fails its CRC32C.')
    yield payload
    pos += 16 + size


def _value(fields):
  """(tag, kind, value) of a Summary.Value."""
  tag, out = None, None
  for field, _, value in fields:
    if field == 1:
      tag = value.decode()
    elif field == 2:
      out = ('scalar', struct.unpack('<f', value)[0])
    elif field == 4:
      image = {1: 'height', 2: 'width', 3: 'colorspace', 4: 'png'}
      out = ('image', {image[f]: v for f, _, v in _parse(value)})
    elif field == 5:
      histo = {}
      for f, _, v in _parse(value):
        if f <= 5:
          histo[('min', 'max', 'num', 'sum', 'sum_squares')[f - 1]] = (
              struct.unpack('<d', v)[0])
        elif f in (6, 7):
          histo['bucket_limit' if f == 6 else 'bucket'] = np.frombuffer(
              v, '<f8')
      out = ('histogram', histo)
    elif field == 8:
      strings = [v.decode() for f, _, v in _parse(value) if f == 8]
      out = ('text', strings[0] if len(strings) == 1 else strings)
  return tag, out[0], out[1]


def read_events(log_dir: str):
  """Every summary value in the event files of `log_dir` (in file order):
  a list of {'step', 'tag', 'kind', 'value'}; kind is
  'scalar' (a float), 'image' ({'height', 'width', 'colorspace', 'png'}),
  'histogram' ({'min', 'max', 'num', 'sum', 'sum_squares',
  'bucket_limit', 'bucket'}) or 'text' (a str)."""
  out = []
  for path in sorted(glob.glob(os.path.join(log_dir, 'events.out.tfevents.*'))):
    for record in _records(path):
      fields = _parse(record)
      step = next((v for f, _, v in fields if f == 2), 0)
      for field, _, summary in fields:
        if field != 5:
          continue
        for f, _, value in _parse(summary):
          if f == 1:
            tag, kind, val = _value(_parse(value))
            out.append(dict(step=step, tag=tag, kind=kind, value=val))
  return out
