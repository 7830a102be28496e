"""Learned perceptual similarity (LPIPS, Zhang et al. 2018), a port of
``multinerf_tpu/ops/lpips.py``.

The VGG16 feature taps (relu1_2 .. relu5_3), the input shift and scale of
the official implementation, unit normalization over channels and the
non-negative linear heads, on the same npz schema (all float32):

  conv{b}_{i}/kernel : [3, 3, cin, cout]  (HWIO)
  conv{b}_{i}/bias   : [cout]
  lin{k}/weight      : [c_k], k = 0..4

Images stay [..., H, W, 3] at the public functions, as in the JAX package;
the network runs NCHW through ``torch.nn.functional.conv2d`` and
``max_pool2d`` (the JAX package leaves these to XLA as well).  The
pretrained weights are not in the repository; ``random_params`` makes the
schema's random stand-ins from a numpy RandomState, as the JAX tests do.
Convolutions run with TF32 off, as every product of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

VGG16_LAYOUT = (
    ('conv1_1', 64), ('conv1_2', 64), 'pool',
    ('conv2_1', 128), ('conv2_2', 128), 'pool',
    ('conv3_1', 256), ('conv3_2', 256), ('conv3_3', 256), 'pool',
    ('conv4_1', 512), ('conv4_2', 512), ('conv4_3', 512), 'pool',
    ('conv5_1', 512), ('conv5_2', 512), ('conv5_3', 512),
)
TAPS = ('conv1_2', 'conv2_2', 'conv3_3', 'conv4_3', 'conv5_3')

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def random_params(rng: np.random.RandomState) -> Mapping[str, np.ndarray]:
  """Random-weight parameter dict with the npz schema (for tests)."""
  params = {}
  cin = 3
  for entry in VGG16_LAYOUT:
    if entry == 'pool':
      continue
    name, cout = entry
    params[f'{name}/kernel'] = (
        rng.randn(3, 3, cin, cout).astype(np.float32) / np.sqrt(9 * cin))
    params[f'{name}/bias'] = np.zeros(cout, np.float32)
    cin = cout
  widths = dict(e for e in VGG16_LAYOUT if e != 'pool')
  for k, tap in enumerate(TAPS):
    params[f'lin{k}/weight'] = rng.rand(widths[tap]).astype(np.float32)
  return params


def load_params(path: str, device='cpu') -> Mapping[str, torch.Tensor]:
  """The npz's arrays as float32 tensors on `device` (as jnp.asarray takes
  them in the JAX package: ``random_params``' kernels are float64)."""
  with np.load(path) as data:
    return {k: torch.tensor(data[k], dtype=torch.float32, device=device)
            for k in data.files}


def _vgg_taps(params, x):
  """The five tap activations of x [N, 3, H, W]."""
  feats = []
  for entry in VGG16_LAYOUT:
    if entry == 'pool':
      x = F.max_pool2d(x, 2)
      continue
    name, _ = entry
    kernel = params[f'{name}/kernel'].permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = torch.relu(F.conv2d(x, kernel, params[f'{name}/bias'], padding=1))
    if name in TAPS:
      feats.append(x)
  return feats


def _unit_normalize(f, eps=1e-10):
  return f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


def lpips(params, img0, img1) -> torch.Tensor:
  """LPIPS distance between two [..., H, W, 3] images in [0, 1] (numpy
  arrays or tensors on the parameters' device): lower is better, 0 for
  identical inputs."""
  device = params['lin0/weight'].device
  as_tensor = lambda img: torch.as_tensor(
      np.asarray(img, np.float32) if not torch.is_tensor(img) else img,
      dtype=torch.float32, device=device)
  img0, img1 = as_tensor(img0), as_tensor(img1)
  batched = img0.dim() == 4
  if not batched:
    img0, img1 = img0[None], img1[None]
  shift = torch.tensor(_SHIFT, device=device)
  scale = torch.tensor(_SCALE, device=device)

  def normalize_input(img):
    return ((2.0 * img - 1.0 - shift) / scale).permute(0, 3, 1, 2)

  flags = dict(enabled=torch.backends.cudnn.enabled,
               benchmark=torch.backends.cudnn.benchmark,
               deterministic=torch.backends.cudnn.deterministic,
               allow_tf32=False)
  with torch.no_grad(), torch.backends.cudnn.flags(**flags):
    taps0 = _vgg_taps(params, normalize_input(img0))
    taps1 = _vgg_taps(params, normalize_input(img1))
    total = 0.0
    for k, (f0, f1) in enumerate(zip(taps0, taps1)):
      d = (_unit_normalize(f0) - _unit_normalize(f1))**2
      weighted = torch.sum(d * params[f'lin{k}/weight'][:, None, None], dim=1)
      total = total + torch.mean(weighted, dim=(-2, -1))
  return total if batched else total[0]


class LPIPS:
  """LPIPS scorer bound to a loaded weight set on `device`."""

  def __init__(self, weights_path: str, device='cpu'):
    self.params = load_params(weights_path, device)

  def __call__(self, img0, img1) -> float:
    return float(lpips(self.params, img0, img1))


def try_load(weights_path: Optional[str], device='cpu') -> Optional[LPIPS]:
  """LPIPS scorer if a weight file is configured and readable, else None."""
  if not weights_path:
    return None
  try:
    return LPIPS(weights_path, device)
  except (OSError, KeyError) as e:
    print(f'LPIPS weights unavailable ({e}); skipping LPIPS metric.')
    return None
