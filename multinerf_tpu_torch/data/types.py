"""Ray and batch records (port of multinerf_tpu.data.types).

Plain dataclasses of tensors (or numpy arrays on the host).  All fields
share leading dims; the trailing dim is the record width.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


@dataclasses.dataclass
class Pixels:
  """Compact per-ray record; rays are cast from these on the device."""
  pix_x_int: Any
  pix_y_int: Any
  lossmult: Any
  near: Any
  far: Any
  cam_idx: Any
  exposure_idx: Optional[Any] = None
  exposure_values: Optional[Any] = None


@dataclasses.dataclass
class Rays:
  """Fully-cast rays with cone footprint metadata."""
  origins: Any
  directions: Any
  viewdirs: Any
  radii: Any
  imageplane: Any
  lossmult: Any
  near: Any
  far: Any
  cam_idx: Any
  exposure_idx: Optional[Any] = None
  exposure_values: Optional[Any] = None


@dataclasses.dataclass
class Batch:
  """Rays (or pixels) plus supervision targets."""
  rays: Any
  rgb: Optional[Any] = None
  disps: Optional[Any] = None
  normals: Optional[Any] = None
  alphas: Optional[Any] = None


class DataSplit(enum.Enum):
  TRAIN = 'train'
  TEST = 'test'


class BatchingMethod(enum.Enum):
  """Training rays from all images at once, or from one image per batch."""
  ALL_IMAGES = 'all_images'
  SINGLE_IMAGE = 'single_image'
