"""RawNeRF's raw-sensor data pipeline (port of data/raw.py).

A minimal ISP (camera raw -> white balance -> color matrix -> exposure ->
sRGB gamma), the RGGB Bayer mask of the loss, a bilinear demosaicker as
shift stencils (numpy on the host, torch on the card), the exiftool-JSON
metadata distilled into exposure indices and values, the loading of a
RawNeRF scene (its HDR+ test-scene layout included), and the affine color
matching of raw-space eval.

DNGs are read from their pre-decoded ``.npy`` sidecars (same basename):
neither this package nor its environment decodes DNG, and a DNG without a
sidecar raises.
"""

from __future__ import annotations

import glob
import json
import os
import types
from typing import Any, Mapping, MutableMapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multinerf_tpu_torch.data import types as dtypes
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.ops import mathx


def postprocess_raw(raw, camtorgb, exposure: Optional[float] = None,
                    xnp: types.ModuleType = np):
  """Minimal ISP: camera-space raw [H, W, 3] -> exposed, gamma-mapped sRGB.

  Args:
    raw: [H, W, 3] demosaicked raw image.
    camtorgb: [3, 3] camera-to-linear-RGB color transform.
    exposure: value mapped to pure white (autoexposes at 97% if None).
    xnp: numpy or torch.
  """
  if raw.shape[-1] != 3:
    raise ValueError(f'raw.shape[-1] is {raw.shape[-1]}, expected 3')
  if tuple(camtorgb.shape) != (3, 3):
    raise ValueError(f'camtorgb.shape is {camtorgb.shape}, expected (3, 3)')
  if xnp is torch:
    linear_rgb = mathx.matmul_hp(raw, camtorgb.T)
    if exposure is None:
      exposure = torch.quantile(linear_rgb.flatten(), 0.97)
    exposed = torch.clamp(linear_rgb / exposure, 0, 1)
  else:
    linear_rgb = np.matmul(raw, camtorgb.T)
    if exposure is None:
      exposure = np.percentile(linear_rgb, 97)
    exposed = np.clip(linear_rgb / exposure, 0, 1)
  return image_ops.linear_to_srgb(exposed, xnp=xnp)


def pixels_to_bayer_mask(pix_x, pix_y, xnp: types.ModuleType = np):
  """Binary RGB Bayer (RGGB) mask [..., 3] of integer pixel coordinates;
  numpy or torch."""
  r = (pix_x % 2 == 0) * (pix_y % 2 == 0)  # Red at top-left.
  g = ((pix_x % 2 == 1) * (pix_y % 2 == 0) +
       (pix_x % 2 == 0) * (pix_y % 2 == 1))  # Greens on the anti-diagonal.
  b = (pix_x % 2 == 1) * (pix_y % 2 == 1)  # Blue at bottom-right.
  if xnp is torch:
    return torch.stack([r, g, b], -1).to(torch.float32)
  return np.stack([r, g, b], -1).astype(np.float32)


# Demosaic stencils, (dy, dx) -> weight, over a full-resolution plane that
# holds one channel's samples and zeros elsewhere: the tent filter for red
# and blue (their 2x2 subgrid), the 4-cross mean for green (its
# checkerboard; the center tap passes the observed greens through).
_TENT_TAPS = tuple(
    ((dy, dx), 1.0 / (1 << (abs(dy) + abs(dx))))
    for dy in (-1, 0, 1) for dx in (-1, 0, 1))
_CROSS_TAPS = (((0, 0), 1.0),
               ((-1, 0), 0.25), ((1, 0), 0.25), ((0, -1), 0.25), ((0, 1), 0.25))


def bilinear_demosaic(bayer, xnp: types.ModuleType = np):
  """Bilinearly demosaic an RGGB mosaic [H, W] (R at (0, 0), G at (0, 1)
  and (1, 0), B at (1, 1)) into [H, W, 3], with circular shifts at the
  edges; numpy or torch (on the card: all shifts and adds)."""
  if xnp is torch:
    ar = lambda n: torch.arange(n, device=bayer.device)
    roll = lambda x, s: torch.roll(x, s, dims=(0, 1))
  else:
    ar = np.arange
    roll = lambda x, s: np.roll(x, s, axis=(0, 1))
  on = xnp.ones((), dtype=bayer.dtype)
  if xnp is torch:
    on = on.to(bayer.device)
  even_row = (ar(bayer.shape[0]) % 2 == 0)[:, None] * on
  even_col = (ar(bayer.shape[1]) % 2 == 0)[None, :] * on

  def filled(phase_mask, taps):
    plane = bayer * phase_mask
    return sum(w * roll(plane, (dy, dx)) for (dy, dx), w in taps)

  return xnp.stack([
      filled(even_row * even_col, _TENT_TAPS),
      filled(even_row + even_col - 2 * even_row * even_col, _CROSS_TAPS),
      filled((1 - even_row) * (1 - even_col), _TENT_TAPS),
  ], -1)


def _read_dng(f) -> np.ndarray:
  """The mosaic of an opened DNG, from its ``.npy`` sidecar."""
  name = getattr(f, 'name', None)
  if name is not None:
    sidecar = os.path.splitext(name)[0] + '.npy'
    if os.path.exists(sidecar):
      return np.load(sidecar)
  raise ImportError(
      'rawpy is unavailable and no pre-decoded .npy sidecar was found. '
      'Either install rawpy/libraw or pre-decode DNGs with '
      "`np.save(base + '.npy', rawpy.imread(dng).raw_image)`.")


def load_raw_images(image_dir: str,
                    image_names: Optional[Sequence[str]] = None
                    ) -> Tuple[np.ndarray, Sequence[Mapping[str, Any]]]:
  """Raw mosaics [N, H, W] (float32) and their exiftool-JSON Exif dicts;
  every ``*.dng`` of `image_dir` in sorted order without `image_names`."""
  if not os.path.exists(image_dir):
    raise ValueError(f'Raw image folder {image_dir} does not exist.')

  def read_pair(image_name):
    stem = os.path.join(image_dir, os.path.splitext(image_name)[0])
    with open(stem + '.dng', 'rb') as f:
      mosaic = _read_dng(f)
    with open(stem + '.json', 'rb') as f:
      exif = json.load(f)[0]
    return mosaic, exif

  if image_names is None:
    image_names = sorted(
        os.path.basename(f)
        for f in glob.glob(os.path.join(image_dir, '*.dng')))

  pairs = [read_pair(name) for name in image_names]
  raws = np.stack([m for m, _ in pairs], axis=0).astype(np.float32)
  return raws, [e for _, e in pairs]


# Brightness percentiles shown as an exposure sweep in the training logs.
_PERCENTILE_LIST = (80, 90, 97, 99, 100)

# Exif fields for rescaling, white balance and color, and noise levels
# (DNG spec 1.4).
_EXIF_KEYS = (
    'BlackLevel',
    'WhiteLevel',
    'AsShotNeutral',
    'ColorMatrix2',
    'NoiseProfile',
)

# Reference-illuminant RGB -> XYZ (brucelindbloom.com).
_RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                     [0.2126729, 0.7151522, 0.0721750],
                     [0.0193339, 0.1191920, 0.9503041]])


def process_exif(exifs: Sequence[Mapping[str, Any]]
                 ) -> MutableMapping[str, Any]:
  """RawNeRF metadata of exiftool-JSON Exif dicts: the Exif fields as
  arrays, ``ShutterSpeed`` in seconds and ``cam2rgb``, camera space ->
  white-balanced camera space (AsShotNeutral) -> XYZ (ColorMatrix2) ->
  linear RGB."""
  meta = {}
  for key in _EXIF_KEYS:
    sample = exifs[0].get(key)
    if sample is None:
      continue
    if isinstance(sample, str):  # Space-separated numeric vectors.
      parsed = [[float(z) for z in e[key].split(' ')] for e in exifs]
    else:
      parsed = [e[key] for e in exifs]
    meta[key] = np.squeeze(np.array(parsed))
  # Shutter speed is written like "1/N".
  meta['ShutterSpeed'] = np.fromiter(
      (1.0 / float(e['ShutterSpeed'].split('/')[1]) for e in exifs), float)

  wb_gains = 1.0 / meta['AsShotNeutral'].reshape(-1, 3)
  cam_to_wbcam = np.array([np.diag(g) for g in wb_gains])
  xyz_to_wbcam = meta['ColorMatrix2'].reshape(-1, 3, 3)
  rgb_to_wbcam = xyz_to_wbcam @ _RGB2XYZ
  # Row-normalized (the simple-camera-pipeline convention).
  rgb_to_wbcam /= rgb_to_wbcam.sum(axis=-1, keepdims=True)
  meta['cam2rgb'] = np.linalg.inv(rgb_to_wbcam) @ cam_to_wbcam
  return meta


def load_raw_dataset(split: dtypes.DataSplit, data_dir: str,
                     image_names: Sequence[str], exposure_percentile: float,
                     n_downsample: int
                     ) -> Tuple[np.ndarray, MutableMapping[str, Any], bool]:
  """A RawNeRF scene's demosaicked images (float32 [N, H, W, 3]), its
  metadata (Exif fields, exposure indices and values, the exposure levels
  and ``postprocess_fn``) and whether it is an HDR+ test scene (a
  ``hdrplus_test/merged.dng`` beside ``raw/``, whose ``raw/`` holds
  ``train/`` and ``test/``)."""
  image_dir = os.path.join(data_dir, 'raw')

  testimg_file = os.path.join(data_dir, 'hdrplus_test/merged.dng')
  testscene = os.path.exists(testimg_file)
  if testscene:
    image_dir = os.path.join(image_dir, split.value)
    if split == dtypes.DataSplit.TEST:
      image_names = None  # The COLMAP names are the train split's.
    else:
      image_names = image_names[1:]  # The first is the test view's pose.

  raws, exifs = load_raw_images(image_dir, image_names)
  meta = process_exif(exifs)

  if testscene and split == dtypes.DataSplit.TEST:
    with open(testimg_file, 'rb') as imgin:
      testraw = _read_dng(imgin)
    # HDR+ output carries 2 extra fixed-precision bits.
    testraw = testraw.astype(np.float32) / 4.0
    # The long-exposure test image, rescaled by the shortest:longest ratio.
    shutter_ratio = meta['ShutterSpeed'][0] / meta['ShutterSpeed'][-1]
    raws = testraw[None]
    meta = {k: v[:1] for k, v in meta.items()}
  else:
    shutter_ratio = 1.0

  # Shutter-speed buckets, brightest (slowest) first: each image's bucket
  # index, and its exposure relative to the brightest bucket.
  shutters = meta['ShutterSpeed']
  by_brightness = np.sort(np.unique(shutters))[::-1]
  meta['unique_shutters'] = by_brightness
  meta['exposure_idx'] = np.searchsorted(
      -by_brightness, -shutters).astype(np.int32)
  meta['exposure_values'] = shutters / by_brightness[0]

  # Sensor counts -> [0, 1]: the black level off, over the dynamic range,
  # times the HDR+ shutter ratio.
  black = meta['BlackLevel'][:, None, None]
  white = meta['WhiteLevel'][:, None, None]
  images = (raws - black) / (white - black) * shutter_ratio

  # The exposure anchors of the tonemap come from the full-resolution
  # first image in linear RGB (stable across downsampling factors).
  demosaic = lambda x: bilinear_demosaic(np.asarray(x, np.float32))
  rgb0 = demosaic(images[0]) @ meta['cam2rgb'][0].T
  meta['exposure'] = np.percentile(rgb0, exposure_percentile)
  meta['exposure_levels'] = {p: np.percentile(rgb0, p)
                             for p in _PERCENTILE_LIST}

  cam2rgb0 = meta['cam2rgb'][0]
  meta['postprocess_fn'] = (
      lambda z, x=meta['exposure']: postprocess_raw(z, cam2rgb0, x))

  def processing_fn(x):
    x_demosaic = demosaic(x)
    if n_downsample > 1:
      x_demosaic = image_ops.downsample(x_demosaic, n_downsample)
    return x_demosaic

  images = np.stack([processing_fn(im) for im in images], axis=0)
  return images, meta, testscene


def best_fit_affine(x, y, axis):
  """Least-squares a, b with a * x + b ~= y (covariance / variance)."""
  mean_x = x.mean(axis=axis)
  mean_y = y.mean(axis=axis)
  cov_xy = (x * y).mean(axis=axis) - mean_x * mean_y
  var_x = (x * x).mean(axis=axis) - mean_x * mean_x
  a = cov_xy / var_x
  b = mean_y - a * mean_x
  return a, b


def match_images_affine(est, gt, axis=(0, 1)):
  """`est` mapped affinely, per channel, to best match `gt` (raw-space
  eval): fit gt -> est, robust when est is noisy, then invert it."""
  a, b = best_fit_affine(gt, est, axis=axis)
  return (est - b) / a
