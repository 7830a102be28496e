"""Occupancy-grid culling of the final level (port of models/culling.py).

A coarse density grid over the contraction domain (``coord.contract`` maps
all of space into the radius-2 ball, so one fixed [-2, 2]^3 grid of R^3
cells covers every scene) is kept up to date from the training samples
themselves (an EMA-max, ``update_grid``) and refreshed every
``Config.occupancy_grid_refresh_every`` steps by probing the NerfMLP's
density at jittered cell centres (``refresh_grid``).  A culled step
evaluates the final level's MLP only on the samples whose cell clears the
keep rule, compacted batch-wide into a buffer of static capacity
(``apply_culled``): the kept samples first, in a diagonally interleaved
order over rays and depths, the spare slots refilled with samples below
the threshold, every other sample sent to a trash slot past the end.  The
culled samples read density 0 and rgb 0, so they drop out of the
compositing exactly.

The compaction is plain PyTorch: a cumsum, ``torch.where`` and index
gathers.  The capacity is a Python int fixed by the shape and the rung, and
nothing here reads a count back to the host, so a culled step runs without
a device-to-host sync.  The JAX package builds its permutation from sliced
shears when the rays divide evenly by the samples (culling.py:171-198, a
layout trick for its chip); the port gathers by the permutation itself,
which gives the same slots and inverse map.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multinerf_tpu_torch.ops import coord
from multinerf_tpu_torch.parallel import mesh


def cell_ids(means, resolution: int):
  """[..., 3] world-space points -> [...] int64 flat ids of the cells of an
  R^3 grid over [-2, 2]^3 in contracted space (culling.py:39-52)."""
  z = coord.contract(means)
  u = (z + 2.0) * (resolution / 4.0)
  ijk = torch.clamp(u.to(torch.int32), 0, resolution - 1).long()
  return (ijk[..., 0] * resolution + ijk[..., 1]) * resolution + ijk[..., 2]


def keep_mask(occ, config, t_edges=None, dirs=None):
  """[..., S] bool: which samples the culled step evaluates
  (culling.py:60-98).

  ``Config.occupancy_keep_rule`` 'density' keeps occ > occupancy_threshold;
  'alpha' keeps a sample whose interval could add more than
  ``occupancy_alpha_eps`` of alpha at the cell's density: occ * delta >
  -log1p(-eps), delta being the interval's world-space length (its t span
  times |dirs|, as rendering.compute_alpha_weights takes it).
  """
  if config.occupancy_keep_rule == 'alpha':
    t_delta = t_edges[..., 1:] - t_edges[..., :-1]
    delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
    return occ * delta > float(-np.log1p(-config.occupancy_alpha_eps))
  if config.occupancy_keep_rule != 'density':
    raise ValueError(
        f'Unknown occupancy_keep_rule {config.occupancy_keep_rule!r}; '
        "expected 'density' or 'alpha'.")
  return occ > config.occupancy_threshold


def update_grid(grid, cells, densities, decay: float):
  """max(decay * grid, the largest density landing in each cell): the
  EMA-max of culling.py:101-110, over the samples of every rank.  The
  maximum does not depend on the order of the writers, on the CPU or on the
  card, nor on the ranks', so the grid stays the same on every rank."""
  hit = torch.zeros_like(grid).scatter_reduce(
      0, cells.reshape(-1), densities.detach().reshape(-1).to(grid.dtype),
      'amax', include_self=True)
  return torch.maximum(grid * decay,
                       mesh.all_reduce_max(hit, mesh.data_group()))


def refresh_jitter(generator, resolution: int, device=None):
  """[R^3, 3] offsets in [-0.5, 0.5) of a cell, from `generator`: where the
  refresh probes each cell (culling.py:133-135)."""
  return torch.rand((resolution**3, 3), generator=generator,
                    device=device) - 0.5


def probe_grid(mlp, grid, config, jitter):
  """The grid after a refresh (culling.py:113-168): max(decay * grid, the
  density of the MLP's trunk and density head at each cell centre moved by
  `jitter` cells), probed in world space (the MLP applies its own warp)
  with an isotropic covariance of a quarter cell."""
  resolution = config.occupancy_grid_resolution
  cell_size = 4.0 / resolution
  ids = torch.arange(resolution**3, device=grid.device)
  k = ids % resolution
  j = (ids // resolution) % resolution
  i = ids // (resolution * resolution)
  centers = (torch.stack([i, j, k], dim=-1) + 0.5) * cell_size - 2.0
  centers = centers + jitter * cell_size
  # Keep the inverse contraction off its singular boundary.
  r = torch.sqrt(torch.sum(centers * centers, dim=-1, keepdim=True))
  centers = torch.where(r < 1.98, centers, centers * (1.98 / r))
  means = coord.inv_contract(centers)
  covs = ((0.25 * cell_size)**2 * torch.eye(3, device=grid.device)).expand(
      means.shape + (3,)).contiguous()
  density = mlp.probe_density(means[:, None, :], covs[:, None])[:, 0]
  return torch.maximum(grid * config.occupancy_grid_decay, density)


def refresh_grid(model, config, generator):
  """Refresh `model`'s grid in place from the final-level MLP (NerfMLP_0),
  its jitter drawn from `generator`."""
  grid = model.occupancy.grid
  with torch.no_grad():
    jitter = refresh_jitter(generator, config.occupancy_grid_resolution,
                            grid.device)
    grid.copy_(probe_grid(model.NerfMLP_0, grid, config, jitter))


def half_grid(resolution: int, device=None):
  """[R^3] the half-occupied grid of bench.py:143-149: every other cell of
  the flat grid at 1.0, the rest empty.  A forced rung's throughput
  depends on its capacity, not on the grid, and this grid gives the mix of
  kept samples and overflow a trained scene gives (``profile_step``)."""
  grid = torch.zeros(resolution**3, device=device)
  grid[::2] = 1.0
  return grid


def half_space_grid(resolution: int, device=None):
  """[R^3] a grid whose cells on the x < 0 side of contracted space are
  empty and the others dense (uniform 0.5-2, seeded): keep decisions flip
  only at that plane."""
  grid = np.zeros((resolution,) * 3, np.float32)
  grid[resolution // 2:] = np.random.RandomState(5).uniform(
      0.5, 2.0, grid[resolution // 2:].shape)
  return torch.tensor(grid.reshape(-1), device=device)


# The profiler range around the compaction and its gathers in apply_culled;
# the backward of the ops inside it carries their sequence numbers
# (profile_step reads both).
COMPACTION = 'culling.compaction'


def round_capacity(n: int, frac: float) -> int:
  """The compact buffer's size: a multiple of 256 in [256, n]
  (culling.py:245-249).  Across ranks `n` is a rank's samples: each rank
  compacts its own, where JAX compacts the global batch (ROADMAP.md,
  Queue 3)."""
  c = int(n * frac)
  c = max(256, (c // 256) * 256)
  return min(c, n)


@functools.lru_cache(maxsize=8)
def interleave_perm(b: int, s: int):
  """The diagonal interleave of [b, s] samples and its inverse, numpy int32
  (culling.py:201-214): position i visits ray i % b, sample
  (i // b + i % b) % s."""
  i = np.arange(b * s)
  r = i % b
  perm = (r * s + (i // b + r) % s).astype(np.int32)
  inv_perm = np.zeros_like(perm)
  inv_perm[perm] = i.astype(np.int32)
  return perm, inv_perm


@functools.lru_cache(maxsize=8)
def _perm_tensors(b: int, s: int, device):
  perm, inv_perm = interleave_perm(b, s)
  return (torch.from_numpy(perm).long().to(device),
          torch.from_numpy(inv_perm).long().to(device))


def compact_slots(keep, cap: int):
  """(slot [b * s], inv [cap]) of a [b, s] keep mask, int64.

  slot[i] is the compact row of flat sample i, `cap` (the trash row) when it
  is not evaluated; inv[c] is the sample in row c.  Slots go to the kept
  samples in interleaved order, up to `cap`, then to the samples not kept,
  so every row below `cap` has exactly one sample (culling.py:329-349).
  """
  b, s = keep.shape
  perm, inv_perm = _perm_tensors(b, s, keep.device)
  keep_p = keep.reshape(-1)[perm]
  pos = torch.cumsum(keep_p, 0) - 1
  kept_p = keep_p & (pos < cap)
  num_kept = torch.clamp(pos[-1:] + 1, max=cap)
  pos_fill = num_kept + torch.cumsum(~keep_p, 0) - 1
  fill_p = ~keep_p & (pos_fill < cap)
  slot_p = torch.where(kept_p, pos, torch.where(fill_p, pos_fill, cap))
  slot = slot_p[inv_perm]
  # The samples left out all write the trash row, which is cut off.
  inv = torch.zeros(cap + 1, dtype=torch.int64, device=keep.device)
  inv = inv.index_put_((slot_p,), perm)[:cap]
  return slot, inv


class GatherRows(torch.autograd.Function):
  """ext[slot] whose backward is the row gather g[inv] (culling.py:217-242):
  each row below the trash row has one reader, so its cotangent is that
  reader's; the trash row is the constant fill and gets zero."""

  @staticmethod
  def forward(ctx, ext, slot, inv):
    ctx.save_for_backward(inv)
    return ext[slot]

  @staticmethod
  def backward(ctx, g):
    inv, = ctx.saved_tensors
    d_rows = g[inv]
    return torch.cat([d_rows, torch.zeros_like(d_rows[:1])]), None, None


def apply_culled(mlp, means, covs, keep, capacity_frac: float, viewdirs=None,
                 glo_vec=None, generator=None, cells=None):
  """Run `mlp` on the kept samples only, compacted to a static capacity
  (culling.py:252-404).

  Args:
    mlp: a models.mlp.MLP.
    means, covs: [..., S, 3] and [..., S, 3, 3] sample Gaussians.
    keep: [..., S] bool, from keep_mask.
    capacity_frac: the buffer's size as a fraction of the samples
      (round_capacity).  Kept samples past it are not evaluated; the
      interleaved order spreads them over rays and depths.
    viewdirs, glo_vec: per-ray conditioning, gathered per compact sample.
    generator: the MLP's noise, as in an unculled call.
    cells: [..., S] cell ids; with them the output carries the compact grid
      feedback 'occ_cells' and 'occ_density' of the evaluated samples.

  Returns:
    The MLP's outputs at [..., S, ...], zero where a sample was not
    evaluated, and 'occ_keep_frac', the share of samples kept.
  """
  batch_shape = means.shape[:-2]
  s = means.shape[-2]
  keep = keep.reshape(-1, s)
  b = keep.shape[0]
  n = b * s
  cap = round_capacity(n, capacity_frac)
  per_ray = lambda x: None if x is None else x.reshape(
      (b,) + x.shape[len(batch_shape):])[ray_idx]
  with torch.profiler.record_function(COMPACTION):
    slot, inv = compact_slots(keep, cap)
    ray_idx = inv // s
    # One row gather for the 12 floats of each sample's Gaussian; the
    # kernels take the two parts contiguous.
    packed = torch.cat([means.reshape(n, 3), covs.reshape(n, 9)],
                       dim=-1)[inv]
    c_means = packed[:, :3].contiguous().reshape(cap, 1, 3)
    c_covs = packed[:, 3:].contiguous().reshape(cap, 1, 3, 3)
    c_viewdirs, c_glo_vec = per_ray(viewdirs), per_ray(glo_vec)
  results = mlp(c_means, c_covs, viewdirs=c_viewdirs, glo_vec=c_glo_vec,
                generator=generator)

  # Scatter back with one row gather over every output, packed as columns
  # of a [cap + 1, C] buffer whose last row is the fill: 0 for every
  # output (density 0 has alpha 0).
  with torch.profiler.record_function(COMPACTION):
    names = [k for k, v in results.items() if v is not None]
    cols = [results[k].reshape(cap, -1).float() for k in names]
    ext = torch.cat(cols, dim=-1)
    ext = torch.cat([ext, ext.new_zeros((1, ext.shape[-1]))])
    gathered = GatherRows.apply(ext, slot, inv)
    out = {k: None for k in results}
    ofs = 0
    for name, col in zip(names, cols):
      w = col.shape[-1]
      out[name] = gathered[:, ofs:ofs + w].reshape(
          batch_shape + (s,) + results[name].shape[2:])
      ofs += w
    out['occ_keep_frac'] = torch.mean(keep.float())
    if cells is not None:
      out['occ_cells'] = cells.reshape(n)[inv]
      out['occ_density'] = results['density'].reshape(cap).detach()
  return out
