"""The port's COLMAP reader against the JAX package's: ``process_scene`` on
binary and text models of the PINHOLE, SIMPLE_RADIAL, OPENCV and
OPENCV_FISHEYE cameras, written here.  Both readers are the same numpy
arithmetic, so names, poses, pixtocam, distortion and camera type must be
equal exactly; unsupported models raise in both.
"""

import os
import struct
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import fabricate_colmap  # noqa: E402
import torch_parity  # noqa: E402,F401  (caps torch's threads)

from multinerf_tpu.data import colmap as jcolmap  # noqa: E402
from multinerf_tpu_torch.data import cameras  # noqa: E402
from multinerf_tpu_torch.data import colmap  # noqa: E402

RES_W, RES_H = 40, 30
# model name -> params (fx, fy, cx, cy, then the distortion coefficients).
CAMERAS = {
    'PINHOLE': (33.0, 31.5, 20.25, 14.75),
    'SIMPLE_RADIAL': (33.0, 20.25, 14.75, -0.031),
    'OPENCV': (33.0, 31.5, 20.25, 14.75, 0.021, -0.0043, 0.0011, -0.0007),
    'OPENCV_FISHEYE': (33.0, 31.5, 20.25, 14.75, 0.012, -0.003, 0.0005,
                       -0.0001),
}
NAMES = ('c.png', 'a.png', 'e.png', 'b.png', 'd.png')


def write_model(sparse, model, params, binary):
  """One shared camera of `model` and len(NAMES) registered images on a
  ring, in COLMAP's binary or text format."""
  os.makedirs(sparse, exist_ok=True)
  model_id = colmap._NAME_TO_ID[model]  # pylint: disable=protected-access
  poses = fabricate_colmap.ring_poses(len(NAMES))
  w2cs = []
  for pose in poses:
    c2w = np.concatenate([pose @ np.diag([1.0, -1.0, -1.0, 1.0]),
                          [[0, 0, 0, 1.0]]], axis=0)
    w2cs.append(np.linalg.inv(c2w))
  if binary:
    with open(os.path.join(sparse, 'cameras.bin'), 'wb') as f:
      f.write(struct.pack('<Q', 1))
      f.write(struct.pack('<iiQQ', 1, model_id, RES_W, RES_H))
      f.write(struct.pack(f'<{len(params)}d', *params))
    with open(os.path.join(sparse, 'images.bin'), 'wb') as f:
      f.write(struct.pack('<Q', len(NAMES)))
      for i, (name, w2c) in enumerate(zip(NAMES, w2cs)):
        f.write(struct.pack('<i', i + 1))
        f.write(struct.pack('<4d', *fabricate_colmap.rotmat_to_qvec(
            w2c[:3, :3])))
        f.write(struct.pack('<3d', *w2c[:3, 3]))
        f.write(struct.pack('<i', 1))
        f.write(name.encode() + b'\x00')
        # Two 2D observations, skipped by both readers.
        f.write(struct.pack('<Q', 2))
        f.write(struct.pack('<ddq', 1.5, 2.5, -1) * 2)
  else:
    with open(os.path.join(sparse, 'cameras.txt'), 'w') as f:
      f.write('# Camera list\n')
      f.write(f'1 {model} {RES_W} {RES_H} ' +
              ' '.join(repr(p) for p in params) + '\n')
    with open(os.path.join(sparse, 'images.txt'), 'w') as f:
      f.write('# Image list\n')
      for i, (name, w2c) in enumerate(zip(NAMES, w2cs)):
        q = fabricate_colmap.rotmat_to_qvec(w2c[:3, :3])
        t = w2c[:3, 3]
        f.write(f'{i + 1} ' + ' '.join(repr(float(v)) for v in (*q, *t)) +
                f' 1 {name}\n')
        f.write('1.5 2.5 -1\n' if i % 2 else '\n')


@pytest.mark.parametrize('binary', [True, False], ids=['bin', 'txt'])
@pytest.mark.parametrize('model', sorted(CAMERAS))
def test_process_scene_matches_jax(tmp_path, model, binary):
  sparse = str(tmp_path / 'sparse' / '0')
  write_model(sparse, model, CAMERAS[model], binary)
  got = colmap.process_scene(sparse)
  want = jcolmap.process_scene(sparse)
  names, poses, pixtocam, distortion, camtype = got
  assert names == want[0] == list(NAMES)
  np.testing.assert_array_equal(poses, want[1])
  np.testing.assert_array_equal(pixtocam, want[2])
  assert (distortion is None) == (want[3] is None) == (model == 'PINHOLE')
  if distortion is not None:
    assert distortion == want[3]
    assert all(type(distortion[k]) is type(want[3][k]) for k in distortion)
  assert camtype.value == want[4].value
  assert camtype == (cameras.ProjectionType.FISHEYE
                     if model == 'OPENCV_FISHEYE' else
                     cameras.ProjectionType.PERSPECTIVE)
  # The recovered poses are the ring the model was written from.
  np.testing.assert_allclose(poses, fabricate_colmap.ring_poses(len(NAMES)),
                             atol=1e-9)


def test_camera_properties_and_unsupported_models():
  for model_id, (name, n_params) in colmap.CAMERA_MODELS.items():
    params = np.arange(1.0, n_params + 1.0)
    cam, jcam = (lib.Camera(1, model_id, 8, 6, params)
                 for lib in (colmap, jcolmap))
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (jcam.fx, jcam.fy, jcam.cx,
                                                jcam.cy)
    assert cam.projection_type().value == jcam.projection_type().value
    if name in ('FULL_OPENCV', 'FOV', 'SIMPLE_RADIAL_FISHEYE',
                'RADIAL_FISHEYE', 'THIN_PRISM_FISHEYE'):
      for c in (cam, jcam):
        with pytest.raises(NotImplementedError, match=name):
          c.distortion()
    else:
      assert cam.distortion() == jcam.distortion()
  with pytest.raises(FileNotFoundError):
    colmap.load_model('/nonexistent/sparse/0')
