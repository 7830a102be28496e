"""The port's TIFF reader (multinerf_tpu_torch/utils/io.py:decode_tiff,
reached through load_img) against Pillow, which the JAX package reads its
TIFFs with (multinerf_tpu/utils/io.py:23-26): every file here is written
by Pillow (uint8 with 1-4 samples, uint16 in both byte orders, float32;
uncompressed, LZW and Deflate; one strip and many), and the reader must
return ``np.asarray(Image.open(f))`` bitwise; then the port's own
``write_tiff_f32`` read back, by Pillow and by the reader."""

import io

import numpy as np
import pytest
from PIL import Image

from multinerf_tpu_torch.utils import io as io_lib

COMPRESSIONS = [None, 'tiff_lzw', 'tiff_adobe_deflate']


def _pillow_tiff(img, compression, mode=None):
  buf = io.BytesIO()
  kw = {} if compression is None else {'compression': compression}
  Image.fromarray(img, mode).save(buf, 'TIFF', **kw)
  return buf.getvalue()


def _check(data, tmp_path):
  want = np.asarray(Image.open(io.BytesIO(data)))
  got = io_lib.decode_tiff(data)
  assert got.shape == want.shape
  assert got.dtype == want.dtype.newbyteorder('=')
  np.testing.assert_array_equal(got, want)
  path = tmp_path / 'x.tiff'
  path.write_bytes(data)
  np.testing.assert_array_equal(io_lib.load_img(str(path)),
                                want.astype(np.float32))


@pytest.mark.parametrize('compression', COMPRESSIONS)
@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_uint8(compression, channels, tmp_path):
  rng = np.random.RandomState(channels)
  shape = (37, 29) + ((channels,) if channels > 1 else ())
  img = rng.randint(0, 256, shape).astype(np.uint8)
  _check(_pillow_tiff(img, compression), tmp_path)


@pytest.mark.parametrize('compression', COMPRESSIONS)
@pytest.mark.parametrize('order', ['<u2', '>u2'])
def test_uint16(compression, order, tmp_path):
  img = np.random.RandomState(5).randint(0, 65536, (41, 23)).astype(order)
  data = _pillow_tiff(img, compression)
  if compression is None:  # Pillow keeps the byte order it was given.
    assert data[:2] == (b'MM' if order[0] == '>' else b'II')
  _check(data, tmp_path)


@pytest.mark.parametrize('compression', COMPRESSIONS)
def test_float32(compression, tmp_path):
  img = np.random.RandomState(6).randn(31, 45).astype(np.float32) * 1e3
  img[0, 0], img[1, 1] = np.inf, -0.0
  _check(_pillow_tiff(img, compression), tmp_path)


@pytest.mark.parametrize('compression', COMPRESSIONS)
def test_many_strips_and_repetitive_rows(compression, tmp_path):
  # Pillow cuts strips of 64 KB; repeated rows give LZW long codes and a
  # table reset.
  row = np.tile(np.arange(256, dtype=np.uint8), 3)
  img = np.tile(row, (300, 1)).reshape(300, 256, 3)
  img[::7] = np.random.RandomState(7).randint(0, 256, img[::7].shape)
  _check(_pillow_tiff(img, compression), tmp_path)


def test_horizontal_predictor():
  # Predictor 2: each sample stored as its difference to the one on its
  # left, modulo 256.  Pillow writes the tag but not the differences, so
  # the strip is rewritten with them.
  img = np.random.RandomState(8).randint(0, 256, (20, 30, 3)).astype(np.uint8)
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, 'TIFF', tiffinfo={317: 2})
  data = bytearray(buf.getvalue())
  start = Image.open(io.BytesIO(bytes(data))).tag_v2[273][0]
  diff = img.astype(np.int16)
  diff[:, 1:] -= img[:, :-1]
  data[start:start + img.size] = (diff % 256).astype(np.uint8).tobytes()
  np.testing.assert_array_equal(io_lib.decode_tiff(bytes(data)), img)


def test_write_tiff_f32_reads_back(tmp_path):
  depth = np.random.RandomState(9).rand(13, 17).astype(np.float32) * 50
  path = tmp_path / 'd.tiff'
  io_lib.save_img_f32(depth, str(path))
  np.testing.assert_array_equal(np.asarray(Image.open(str(path))), depth)
  np.testing.assert_array_equal(io_lib.load_img(str(path)), depth)


def test_lzw_decoder_on_a_known_stream():
  # "TOBEORNOTTOBEORTOBEORNOT" through libtiff's LZW, via Pillow.
  text = np.frombuffer(b'TOBEORNOTTOBEORTOBEORNOT' * 5, np.uint8)
  data = _pillow_tiff(text.reshape(5, 24), 'tiff_lzw')
  tags = Image.open(io.BytesIO(data)).tag_v2
  strip = data[tags[273][0]:tags[273][0] + tags[279][0]]
  assert io_lib.lzw_decode(strip) == text.tobytes()


def test_refusals():
  img = np.zeros((4, 4), np.uint8)
  data = bytearray(_pillow_tiff(img, None))
  with pytest.raises(ValueError, match='not a TIFF'):
    io_lib.decode_tiff(b'GIF89a')
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, 'TIFF', compression='packbits')
  with pytest.raises(NotImplementedError, match='compression 32773'):
    io_lib.decode_tiff(buf.getvalue())
  assert io_lib.decode_tiff(bytes(data)).shape == (4, 4)
