"""Geodesic polyhedron bases for feature-space lifting (host numpy).

Port of ``multinerf_tpu.ops.geopoly``; the [n, 3] basis must match it
bit for bit, because the IPE feature rows (and so the weights of a JAX
checkpoint) are ordered by it.
"""

from __future__ import annotations

import itertools

import numpy as np


def compute_sq_dist(mat0, mat1=None):
  """Squared Euclidean distance between all pairs of *columns*."""
  if mat1 is None:
    mat1 = mat0
  sq_norm0 = np.sum(mat0**2, 0)
  sq_norm1 = np.sum(mat1**2, 0)
  sq_dist = sq_norm0[:, None] + sq_norm1[None, :] - 2 * mat0.T @ mat1
  return np.maximum(0, sq_dist)  # Clamp numerical-error negatives.


def compute_tesselation_weights(v):
  """Barycentric weights subdividing a triangle by a factor of v."""
  if v < 1:
    raise ValueError(f'v {v} must be >= 1')
  int_weights = []
  for i in range(v + 1):
    for j in range(v + 1 - i):
      int_weights.append((i, j, v - (i + j)))
  return np.array(int_weights) / v


def tesselate_geodesic(base_verts, base_faces, v, eps=1e-4):
  """Subdivide each face by v, project onto the sphere, dedupe vertices."""
  if not isinstance(v, int):
    raise ValueError(f'v {v} must an integer')
  tri_weights = compute_tesselation_weights(v)

  verts = []
  for face in base_faces:
    new_verts = np.matmul(tri_weights, base_verts[face, :])
    new_verts /= np.sqrt(np.sum(new_verts**2, 1, keepdims=True))
    verts.append(new_verts)
  verts = np.concatenate(verts, 0)

  # Collapse duplicates (vertices shared between faces) onto their first
  # occurrence.
  sq_dist = compute_sq_dist(verts.T)
  assignment = np.array([np.min(np.argwhere(d <= eps)) for d in sq_dist])
  return verts[np.unique(assignment), :]


def generate_basis(base_shape, angular_tesselation, remove_symmetries=True,
                   eps=1e-4):
  """Tesselate a polyhedron into an [n, 3] direction basis.

  ``('icosahedron', 2)`` gives n = 21 directions, hence 2 * 12 * 21 = 504
  IPE features at the default 12 degrees.
  """
  if base_shape == 'icosahedron':
    a = (np.sqrt(5) + 1) / 2
    verts = np.array([(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a),
                      (0, a, 1), (0, a, -1), (0, -a, 1), (0, -a, -1),
                      (a, 1, 0), (-a, 1, 0), (a, -1, 0),
                      (-a, -1, 0)]) / np.sqrt(a + 2)
    faces = np.array([(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
                      (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
                      (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6),
                      (0, 1, 6), (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5),
                      (7, 2, 11)])
    verts = tesselate_geodesic(verts, faces, angular_tesselation)
  elif base_shape == 'octahedron':
    verts = np.array([(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0),
                      (-1, 0, 0), (1, 0, 0)])
    corners = np.array(list(itertools.product([-1, 1], repeat=3)))
    pairs = np.argwhere(compute_sq_dist(corners.T, verts.T) == 2)
    faces = np.sort(np.reshape(pairs[:, 1], [3, -1]).T, 1)
    verts = tesselate_geodesic(verts, faces, angular_tesselation)
  else:
    raise ValueError(f'base_shape {base_shape} not supported')

  if remove_symmetries:
    match = compute_sq_dist(verts.T, -verts.T) < eps
    verts = verts[np.any(np.triu(match), 1), :]

  return verts[:, ::-1]
