"""The port's JPEG decoder and encoder (multinerf_tpu_torch/utils/jpeg.py)
against Pillow, which the JAX package reads and writes JPEGs with
(multinerf_tpu/utils/io.py:23-26, utils/video.py:45).

The decoder is held bitwise against ``np.asarray(Image.open(f))`` on JPEGs
Pillow writes here: baseline and progressive; 4:4:4, 4:2:2, 4:2:0 and
grey; restart intervals; odd sizes down to 1 x 1; several qualities.  The
encoder's files, decoded by Pillow, are held bitwise against Pillow's own
quality-90 round trip of the same array (and its bytes against Pillow's
where the size is a whole number of MCUs: the only difference elsewhere is
the content of the padding blocks, which no decoder shows).
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from multinerf_tpu_torch.utils import io as io_lib
from multinerf_tpu_torch.utils import jpeg


def _pillow_jpeg(img, **kw):
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, 'JPEG', **kw)
  return buf.getvalue()


def _pillow_array(data):
  return np.asarray(Image.open(io.BytesIO(data)))


def _scene(h, w, seed=0, grey=False):
  """Smooth color fields plus noise: both flat and busy blocks."""
  rng = np.random.RandomState(seed)
  y, x = np.mgrid[0:h, 0:w] / 9.0
  img = np.stack([np.sin(x + 0.7 * y)**2, np.cos(0.5 * x * y)**2,
                  np.sin(1.3 * y)**2], -1) * 220 + rng.randn(h, w, 3) * 12
  img = np.clip(img, 0, 255).astype(np.uint8)
  return img[..., 1] if grey else img


SUBSAMPLING = {'4:4:4': 0, '4:2:2': 1, '4:2:0': 2}


@pytest.mark.parametrize('size', [(48, 64), (37, 53), (17, 9), (1, 1),
                                  (2, 3), (5, 130)])
@pytest.mark.parametrize('sampling', ['4:4:4', '4:2:2', '4:2:0', 'grey'])
@pytest.mark.parametrize('progressive', [False, True])
def test_decoder_matches_pillow(size, sampling, progressive):
  img = _scene(*size, grey=sampling == 'grey')
  kw = {} if sampling == 'grey' else {'subsampling': SUBSAMPLING[sampling]}
  data = _pillow_jpeg(img, quality=87, progressive=progressive, **kw)
  got = jpeg.decode_jpeg(data)
  want = _pillow_array(data)
  assert got.dtype == np.uint8 and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('quality', [5, 50, 75, 95, 100])
@pytest.mark.parametrize('progressive', [False, True])
def test_decoder_qualities(quality, progressive):
  data = _pillow_jpeg(_scene(40, 56, seed=1), quality=quality,
                      progressive=progressive)
  np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pillow_array(data))


@pytest.mark.parametrize('blocks', [1, 3, 7])
@pytest.mark.parametrize('sampling', ['4:4:4', '4:2:0', 'grey'])
def test_decoder_restart_intervals(blocks, sampling):
  img = _scene(45, 70, seed=2, grey=sampling == 'grey')
  kw = {} if sampling == 'grey' else {'subsampling': SUBSAMPLING[sampling]}
  data = _pillow_jpeg(img, quality=80, restart_marker_blocks=blocks, **kw)
  assert b'\xff\xdd' in data  # A DRI segment.
  np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pillow_array(data))


def test_decoder_skips_app_segments_and_reads_through_load_img(tmp_path):
  img = _scene(33, 41, seed=3)
  exif = Image.Exif()
  exif[0x0110] = 'port'
  data = _pillow_jpeg(img, quality=90, exif=exif.tobytes(),
                      comment=b'a comment')
  path = tmp_path / 'x.jpg'
  path.write_bytes(data)
  want = _pillow_array(data)
  np.testing.assert_array_equal(io_lib.read_image(str(path)), want)
  np.testing.assert_array_equal(io_lib.load_img(str(path)),
                                want.astype(np.float32))
  assert io_lib.load_exif(str(path))['Model'] == 'port'


def test_decoder_refuses_what_it_does_not_cover():
  data = bytearray(_pillow_jpeg(_scene(16, 16), quality=90))
  sof = data.index(b'\xff\xc0')
  arithmetic = bytes(data[:sof + 1]) + b'\xc9' + bytes(data[sof + 2:])
  with pytest.raises(NotImplementedError, match='arithmetic'):
    jpeg.decode_jpeg(arithmetic)
  twelve = bytearray(data)
  twelve[sof + 4] = 12  # The SOF's sample precision.
  with pytest.raises(NotImplementedError, match='12-bit'):
    jpeg.decode_jpeg(bytes(twelve))
  with pytest.raises(ValueError, match='not a JPEG'):
    jpeg.decode_jpeg(b'\x89PNG')


def test_decoding_twice_gives_the_same_array():
  data = _pillow_jpeg(_scene(64, 80, seed=4), quality=95)
  a, b = jpeg.decode_jpeg(data), jpeg.decode_jpeg(data)
  assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('size', [(64, 96), (37, 53), (8, 8), (1, 1),
                                  (31, 17)])
@pytest.mark.parametrize('grey', [False, True])
def test_encoder_matches_pillow_round_trip(size, grey):
  img = _scene(*size, seed=5, grey=grey)
  ours = jpeg.encode_jpeg(img, 90)
  theirs = _pillow_jpeg(img, quality=90)
  np.testing.assert_array_equal(_pillow_array(ours), _pillow_array(theirs))
  mcu = 8 if grey else 16
  if size[0] % mcu == 0 and size[1] % mcu == 0:
    assert ours == theirs


@pytest.mark.parametrize('size', [(40, 56), (13, 7)])
def test_encoder_444_matches_pillow(size):
  img = _scene(*size, seed=10)
  ours = jpeg.encode_jpeg(img, 95, subsampling='4:4:4')
  theirs = _pillow_jpeg(img, quality=95, subsampling=0)
  np.testing.assert_array_equal(_pillow_array(ours), _pillow_array(theirs))
  if size[0] % 8 == 0 and size[1] % 8 == 0:
    assert ours == theirs
  with pytest.raises(ValueError, match='subsampling'):
    jpeg.encode_jpeg(img, 95, subsampling='4:1:1')


@pytest.mark.parametrize('quality', [10, 50, 75, 95])
def test_encoder_qualities_and_our_decoder(quality):
  img = _scene(48, 64, seed=6)
  ours = jpeg.encode_jpeg(img, quality)
  assert ours == _pillow_jpeg(img, quality=quality)
  np.testing.assert_array_equal(jpeg.decode_jpeg(ours), _pillow_array(ours))


def test_encoder_exif_segment_is_read_back(tmp_path):
  tiff = (b'II*\x00' + struct.pack('<IH', 8, 1) +
          struct.pack('<HHII', 0x0112, 3, 1, 6) + struct.pack('<I', 0))
  path = tmp_path / 'e.jpg'
  path.write_bytes(jpeg.encode_jpeg(_scene(16, 24, seed=7), 95, exif=tiff))
  assert io_lib.load_exif(str(path)) == {'Orientation': 6}
  assert Image.open(str(path)).getexif()[0x0112] == 6


def test_encoder_quality_95_psnr():
  # The chip phase's bound on its JPEG captures: >= 40 dB at quality 95, on
  # a smooth image (4:2:0 keeps a quarter of the chroma samples).
  y, x = np.mgrid[0:96, 0:128] / 40.0
  img = (np.stack([np.sin(x + y), np.cos(x - 0.5 * y), np.sin(0.7 * x)], -1)
         * 100 + 128).astype(np.uint8)
  got = jpeg.decode_jpeg(jpeg.encode_jpeg(img, 95)).astype(np.float64)
  mse = np.mean((got - img)**2)
  assert 10 * np.log10(255.0**2 / mse) >= 40.0


def test_quality_tables_follow_the_ijg_rule():
  luma, chroma = jpeg.quality_tables(90)
  data = _pillow_jpeg(_scene(16, 16), quality=90)
  pos = data.index(b'\xff\xdb')
  table0 = np.frombuffer(data[pos + 5:pos + 69], np.uint8)
  np.testing.assert_array_equal(luma[jpeg.ZIGZAG], table0)
  assert chroma[0] == 3 and luma[0] == 3  # (17 * 20 + 50) // 100.


def test_integer_dcts_round_trip():
  # jfdctint, quantization by 1 and jidctint: within one level of the input.
  rng = np.random.RandomState(9)
  samples = rng.randint(0, 256, (500, 8, 8))
  coefs = jpeg.fdct_islow(samples - 128).reshape(-1, 64)
  back = jpeg.idct_islow(jpeg.quantize(coefs, np.ones(64, np.int64)).reshape(
      -1, 8, 8))
  assert np.abs(back.astype(int) - samples).max() <= 1
