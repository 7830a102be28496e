"""The port's TensorBoard event writer, read back by TensorBoard's own
EventAccumulator and by the port's reader, and its CRC32C."""

import os

import numpy as np
import pytest

from multinerf_tpu_torch.utils import io as io_lib
from multinerf_tpu_torch.utils import summary


def test_crc32c_known_vectors():
  # RFC 3720, B.4, and the common check value of CRC-32C.
  assert summary.crc32c(b'123456789') == 0xE3069283
  assert summary.crc32c(b'') == 0
  assert summary.crc32c(bytes(32)) == 0x8A9136AA
  assert summary.crc32c(b'\xff' * 32) == 0x62A8AB43
  assert summary.crc32c(bytes(range(32))) == 0x46DD794E
  assert summary.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C


@pytest.mark.parametrize('size', [1, 16383, 16384, 100003, (1 << 20) + 7])
def test_crc32c_blocks_match_the_byte_loop(size):
  data = np.random.RandomState(size % 97).bytes(size)
  want = summary._advance(0xFFFFFFFF, data) ^ 0xFFFFFFFF
  assert summary.crc32c(data) == want


def _write(log_dir):
  rng = np.random.RandomState(0)
  images = {'rgb': rng.uniform(0, 1, (20, 30, 3)),
            'gray': rng.uniform(0, 1, (17, 9)),
            'big': rng.uniform(0, 1, (300, 200, 3))}  # Blocked CRC path.
  values = rng.normal(0, 1, 1000)
  writer = summary.SummaryWriter(str(log_dir))
  writer.scalar('train_avg_loss', 0.25, 1)
  writer.scalar('train_avg_loss', 0.125, 7)
  for tag, img in images.items():
    writer.image(f'test_output_{tag}', img, 7)
  writer.histogram('train_psnrs/0', values, 7)
  writer.text('train_exposure_idx', '[0 1 2]', 0)
  writer.close()
  return images, values


def test_writer_is_read_back_by_tensorboard(tmp_path):
  event_accumulator = pytest.importorskip(
      'tensorboard.backend.event_processing.event_accumulator')
  images, values = _write(tmp_path)
  acc = event_accumulator.EventAccumulator(str(tmp_path), size_guidance={
      event_accumulator.SCALARS: 0, event_accumulator.IMAGES: 0,
      event_accumulator.HISTOGRAMS: 0, event_accumulator.TENSORS: 0})
  acc.Reload()
  assert [(e.step, e.value) for e in acc.Scalars('train_avg_loss')] == [
      (1, 0.25), (7, 0.125)]
  for tag, img in images.items():
    (event,) = acc.Images(f'test_output_{tag}')
    assert (event.step, event.height, event.width) == (7,) + img.shape[:2]
    assert event.encoded_image_string == io_lib.encode_png(io_lib.to_u8(img))
  (histo,) = acc.Histograms('train_psnrs/0')
  h = histo.histogram_value
  assert (h.num, h.min, h.max) == (1000, values.min(), values.max())
  assert sum(h.bucket) == 1000 and len(h.bucket_limit) == 30
  assert h.sum == pytest.approx(values.sum())
  (text,) = acc.Tensors('train_exposure_idx')
  assert text.tensor_proto.string_val == [b'[0 1 2]']


def test_writer_is_read_back_by_the_port_reader(tmp_path):
  images, values = _write(tmp_path)
  events = summary.read_events(str(tmp_path))
  by_tag = {}
  for e in events:
    by_tag.setdefault(e['tag'], []).append(e)
  assert [(e['step'], e['value']) for e in by_tag['train_avg_loss']] == [
      (1, 0.25), (7, 0.125)]
  assert by_tag['train_exposure_idx'][0]['value'] == '[0 1 2]'
  gray = by_tag['test_output_gray'][0]['value']
  assert (gray['height'], gray['width'], gray['colorspace']) == (17, 9, 1)
  assert gray['png'] == io_lib.encode_png(io_lib.to_u8(images['gray']))
  h = by_tag['train_psnrs/0'][0]['value']
  counts, edges = np.histogram(values, bins=30)
  np.testing.assert_array_equal(h['bucket'], counts)
  np.testing.assert_array_equal(h['bucket_limit'], edges[1:])


def test_reader_rejects_a_damaged_record(tmp_path):
  _write(tmp_path)
  (path,) = [os.path.join(tmp_path, n) for n in os.listdir(tmp_path)]
  with open(path, 'rb') as f:
    data = bytearray(f.read())
  data[-40] ^= 1  # Inside the last record's payload.
  with open(path, 'wb') as f:
    f.write(bytes(data))
  with pytest.raises(ValueError, match='CRC32C'):
    summary.read_events(str(tmp_path))
