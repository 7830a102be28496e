"""Plain PyTorch and NumPy operations of mip-NeRF 360 and Ref-NeRF.

A frozen copy of the plain operations the port runs (ray warps, the
integrated positional encoding, the stratified resampler, the proposal and
distortion losses, frustum casting, alpha compositing, the integrated
directional encoding), kept here so that the reference imports nothing of
the program.  Each follows the published equations of mip-NeRF 360
(arxiv.org/abs/2111.12077) and Ref-NeRF (arxiv.org/abs/2112.03907).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
TRIG_PERIOD = 100.0 * math.pi

_CONSTS = {}


def const(array, device):
  """A host table as an f32 tensor on `device`, made once."""
  host = np.ascontiguousarray(array, np.float32)
  key = (host.tobytes(), host.shape, str(torch.device(device)))
  if key not in _CONSTS:
    _CONSTS[key] = torch.from_numpy(host.copy()).to(device)
  return _CONSTS[key]


# Products that stay in full f32 whatever the TF32 switch (the encodings'
# projections and tables), as the configurations compute them; the control
# of an f32 configuration turns TF32 on for every other product.
class _HP(torch.autograd.Function):

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a, b)
    return _f32_product(a, b)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    ga = gb = None
    if ctx.needs_input_grad[0]:
      ga = matmul_hp(g, b.transpose(-1, -2)).sum_to_size(a.shape)
    if ctx.needs_input_grad[1]:
      gb = matmul_hp(a.transpose(-1, -2), g).sum_to_size(b.shape)
    return ga, gb


def _f32_product(a, b):
  flags = torch.backends.cuda.matmul
  saved = flags.allow_tf32
  flags.allow_tf32 = False
  try:
    return a @ b
  finally:
    flags.allow_tf32 = saved


def matmul_hp(a, b):
  """a @ b in full f32, in its gradients too."""
  if a.dim() > 2 and b.dim() == 2:
    out = matmul_hp(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(a.shape[:-1] + out.shape[-1:])
  return _HP.apply(a, b)


def _reduce(x):
  return torch.where(torch.abs(x) < TRIG_PERIOD, x,
                     torch.remainder(x, TRIG_PERIOD))


def safe_sin(x):
  return torch.sin(_reduce(x))


def safe_cos(x):
  return torch.cos(_reduce(x))


def learning_rate_decay(step, lr_init, lr_final, max_steps, lr_delay_steps=0,
                        lr_delay_mult=1.0):
  """Log-linear decay with the sine-eased warm-up (mip-NeRF 360's)."""
  if lr_delay_steps > 0:
    delay = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
        0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
  else:
    delay = 1.0
  t = np.clip(step / max_steps, 0, 1)
  return float(delay * np.exp(t * np.log(lr_final) +
                              (1 - t) * np.log(lr_init)))


# --- Step functions. -----------------------------------------------------------


def interp_sorted(x, xp, fp):
  """Batched linear interpolation of sorted queries in sorted fenceposts."""
  ge = x[..., None, :] >= xp[..., :, None]

  def bracket(vals):
    lo = torch.where(ge, vals[..., None], vals[..., :1, None]).amax(dim=-2)
    hi = torch.where(ge, vals[..., -1:, None], vals[..., None]).amin(dim=-2)
    return lo, hi

  fp0, fp1 = bracket(fp)
  xp0, xp1 = bracket(xp)
  frac = torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0).clamp(0, 1)
  return fp0 + frac * (fp1 - fp0)


def integrate_weights(w):
  cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
  pad = torch.zeros(cw.shape[:-1] + (1,), dtype=cw.dtype, device=cw.device)
  return torch.cat([pad, cw, torch.ones_like(pad)], dim=-1)


def max_dilate_weights(t, w, dilation, domain, eps=F32_EPS**2):
  """Dilate a histogram by +-dilation in density space, renormalized."""
  p = w / torch.clamp(t[..., 1:] - t[..., :-1], min=eps)
  t0 = t[..., :-1] - dilation
  t1 = t[..., 1:] + dilation
  t_d = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
  t_d = torch.clamp(t_d, *domain)
  covers = ((t0[..., None, :] <= t_d[..., None]) &
            (t1[..., None, :] > t_d[..., None]))
  p_d = torch.where(covers, p[..., None, :], 0).amax(dim=-1)[..., :-1]
  w_d = p_d * (t_d[..., 1:] - t_d[..., :-1])
  w_d = w_d / torch.clamp(torch.sum(w_d, dim=-1, keepdim=True), min=eps)
  return t_d, w_d


def sample_intervals(generator, t, w_logits, num_samples, single_jitter,
                     domain):
  """Stratified inverse-CDF intervals: [..., num_samples + 1] fences.  The
  jitter is one torch.rand call on `generator` per call (or none)."""
  eps = F32_EPS
  strata = torch.arange(num_samples, dtype=t.dtype, device=t.device)
  if generator is None:
    pad = 1 / (2 * num_samples)
    u = pad + strata * ((1 - 2 * pad - eps) / (num_samples - 1))
    u = torch.broadcast_to(u, t.shape[:-1] + (num_samples,))
  else:
    u_max = eps + (1 - eps) / num_samples
    pitch = (1 - u_max) / (num_samples - 1)
    shape = t.shape[:-1] + ((1,) if single_jitter else (num_samples,))
    u = strata * pitch + torch.rand(shape, generator=generator,
                                    dtype=t.dtype, device=t.device) * (
                                        pitch - eps)
  cw = integrate_weights(torch.softmax(w_logits, dim=-1))
  centers = interp_sorted(u, cw, t)
  lo = 2 * centers[..., :1] - centers[..., 1:2]
  hi = 2 * centers[..., -1:] - centers[..., -2:-1]
  padded = torch.cat([lo, centers, hi], dim=-1)
  fences = 0.5 * (padded[..., :-1] + padded[..., 1:])
  return torch.cat([torch.clamp(fences[..., :1], min=domain[0]),
                    fences[..., 1:-1],
                    torch.clamp(fences[..., -1:], max=domain[1])], dim=-1)


def lossfun_outer(t, w, t_env, w_env, eps=F32_EPS):
  left = t_env[..., :-1, None] <= t[..., None, 1:]
  right = t_env[..., 1:, None] > t[..., None, :-1]
  w_outer = torch.sum(torch.where(left & right, w_env[..., None], 0), dim=-2)
  return torch.clamp(w - w_outer, min=0)**2 / (w + eps)


def lossfun_distortion(t, w):
  mids = 0.5 * (t[..., 1:] + t[..., :-1])
  wm = w * mids
  p = torch.cumsum(w, dim=-1) - w
  q = torch.cumsum(wm, dim=-1) - wm
  inter = 2 * torch.sum(w * (mids * p - q), dim=-1)
  intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
  return inter + intra


# --- Warps and encodings. --------------------------------------------------------


def contract_gaussian(mean, cov):
  """Gaussians through the scene contraction, cov' = J cov J^T."""
  r_sq = torch.clamp(torch.sum(mean**2, dim=-1, keepdim=True), min=F32_EPS)
  r = torch.sqrt(r_sq)
  g = (2 * r - 1) / r_sq
  c = (2 - 2 * r) / (r_sq * r_sq)
  inside = r_sq <= 1
  new_mean = torch.where(inside, mean, g * mean)
  m = torch.einsum('...ij,...j->...i', cov, mean)
  xcx = torch.sum(mean * m, dim=-1)
  outer_xm = mean[..., :, None] * m[..., None, :]
  outer_xx = mean[..., :, None] * mean[..., None, :]
  g_, c_ = g[..., None], c[..., None]
  new_cov = (g_**2 * cov + g_ * c_ * (outer_xm + outer_xm.transpose(-1, -2))
             + c_**2 * xcx[..., None, None] * outer_xx)
  return new_mean, torch.where(inside[..., None], cov, new_cov)


def ray_warps(name, t_near, t_far):
  """(s -> t) of the normalized ray distance: 'reciprocal' or None."""
  if name is None:
    fwd = inv = lambda x: x
  elif name == 'reciprocal':
    fwd = inv = torch.reciprocal
  else:
    raise ValueError(name)
  s_near, s_far = fwd(t_near), fwd(t_far)
  return lambda s: inv(s * s_far + (1 - s) * s_near)


def ipe_lifted(mean, cov, basis, min_deg, max_deg, anchor_every=4):
  """The lifted integrated positional encoding, sin rows then cos rows,
  degree-major: every `anchor_every`-th degree direct, the ones between by
  the double-angle recurrence and squared attenuations (the configurations'
  form, past two degrees)."""
  if max_deg - min_deg <= 2:
    raise NotImplementedError('the direct form of two degrees or fewer')
  basis = np.asarray(basis, np.float32)
  base = 2.0**min_deg
  basis_t = np.asarray(base * basis.T, np.float32)
  bb_t = np.asarray((base * base) * np.einsum(
      'ik,jk->kij', basis, basis).reshape(basis.shape[-1], 9), np.float32)
  shape = mean.shape[:-1]
  args0 = matmul_hp(mean.reshape(-1, 3), const(basis_t.T, mean.device))
  var0 = matmul_hp(cov.reshape(-1, 9), const(bb_t.T, mean.device))
  sins, coss = [], []
  s = c = e = None
  for d in range(max_deg - min_deg):
    if d % anchor_every == 0:
      freq = 2.0**d
      a = args0 if d == 0 else freq * args0
      s, c = safe_sin(a), safe_cos(a)
      e = torch.exp((-0.5 * freq * freq) * var0)
    else:
      s, c = 2.0 * (s * c), 1.0 - 2.0 * (s * s)
      e2 = e * e
      e = e2 * e2
    sins.append(e * s)
    coss.append(e * c)
  feats = torch.cat(sins + coss, dim=-1)
  return feats.reshape(shape + (feats.shape[-1],))


def pos_enc(x, min_deg, max_deg):
  scales = 2.0**torch.arange(min_deg, max_deg, dtype=x.dtype, device=x.device)
  sx = torch.reshape(x[..., None, :] * scales[:, None], x.shape[:-1] + (-1,))
  return torch.cat([x, torch.sin(torch.cat([sx, sx + 0.5 * math.pi], -1))],
                   dim=-1)


def _sq_dist(mat0, mat1=None):
  mat1 = mat0 if mat1 is None else mat1
  d = (np.sum(mat0**2, 0)[:, None] + np.sum(mat1**2, 0)[None, :] -
       2 * mat0.T @ mat1)
  return np.maximum(0, d)


def _tesselate(base_verts, base_faces, v, eps=1e-4):
  weights = np.array([(i, j, v - (i + j)) for i in range(v + 1)
                      for j in range(v + 1 - i)]) / v
  verts = []
  for face in base_faces:
    new = np.matmul(weights, base_verts[face, :])
    new /= np.sqrt(np.sum(new**2, 1, keepdims=True))
    verts.append(new)
  verts = np.concatenate(verts, 0)
  sq = _sq_dist(verts.T)
  assignment = np.array([np.min(np.argwhere(d <= eps)) for d in sq])
  return verts[np.unique(assignment), :]


def generate_basis(shape, subdivisions, eps=1e-4):
  """The geodesic direction basis [n, 3] of the lifted encoding."""
  if shape == 'icosahedron':
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
  elif shape == 'octahedron':
    verts = np.array([(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0),
                      (-1, 0, 0), (1, 0, 0)])
    corners = np.array(list(itertools.product([-1, 1], repeat=3)))
    pairs = np.argwhere(_sq_dist(corners.T, verts.T) == 2)
    faces = np.sort(np.reshape(pairs[:, 1], [3, -1]).T, 1)
  else:
    raise ValueError(shape)
  verts = _tesselate(verts, faces, subdivisions)
  match = _sq_dist(verts.T, -verts.T) < eps
  verts = verts[np.any(np.triu(match), 1), :]
  return verts[:, ::-1]


def l2_normalize(x, eps=F32_EPS):
  return x / torch.sqrt(torch.clamp(torch.sum(x**2, dim=-1, keepdim=True),
                                    min=eps))


def reflect(viewdirs, normals):
  return 2.0 * torch.sum(normals * viewdirs, dim=-1,
                         keepdim=True) * normals - viewdirs


def _ml_array(deg_view):
  return np.array([(m, 2**i) for i in range(deg_view)
                   for m in range(2**i + 1)]).T


def _sph_harm_coeff(l, m, k):
  binom = lambda a, n: np.prod(a - np.arange(n)) / math.factorial(n)
  legendre = ((-1)**m * 2**l * math.factorial(l) / math.factorial(k) /
              math.factorial(l - k - m) * binom(0.5 * (l + k + m - 1.0), l))
  return np.sqrt((2.0 * l + 1.0) * math.factorial(l - m) /
                 (4.0 * np.pi * math.factorial(l + m))) * legendre


def ide_width(deg_view):
  return 2 * _ml_array(deg_view).shape[1]


def generate_ide_fn(deg_view):
  """Ref-NeRF's integrated directional encoding (Eq 6-8)."""
  ml = _ml_array(deg_view)
  l_max = 2**(deg_view - 1)
  mat = np.zeros((l_max + 1, ml.shape[1]))
  for i, (m, l) in enumerate(ml.T):
    for k in range(l - m + 1):
      mat[k, i] = _sph_harm_coeff(l, m, k)
  m_cols = [int(m) for m in ml[0, :]]
  sigma = 0.5 * ml[1, :] * (ml[1, :] + 1)

  def pow_int(x, y):
    if y == 0:
      return torch.ones_like(x)
    acc = None
    while y > 0:
      if y & 1:
        acc = x if acc is None else acc * x
      y >>= 1
      if y > 0:
        x = x * x
    return acc

  def ide(xyz, kappa_inv):
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    vmz = torch.cat([pow_int(z, i) for i in range(mat.shape[0])], dim=-1)
    polar = matmul_hp(vmz, const(mat, xyz.device))
    re_p, im_p = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(l_max):
      re, im = re_p[-1], im_p[-1]
      re_p.append(re * x - im * y)
      im_p.append(re * y + im * x)
    re_m = torch.cat([re_p[m] for m in m_cols], dim=-1)
    im_m = torch.cat([im_p[m] for m in m_cols], dim=-1)
    atten = torch.exp(-const(sigma, xyz.device) * kappa_inv)
    return torch.cat([re_m * polar * atten, im_m * polar * atten], dim=-1)

  return ide


def linear_to_srgb(linear):
  srgb0 = 323 / 25 * linear
  srgb1 = (211 * torch.clamp(linear, min=F32_EPS)**(5 / 12) - 11) / 200
  return torch.where(linear <= 0.0031308, srgb0, srgb1)


# --- Rays and compositing. --------------------------------------------------------


def cast_frustums(tdist, origins, directions, radii):
  """Conical frustums [..., s] -> (means [..., s, 3], covs [..., s, 3, 3])."""
  t0, t1 = tdist[..., :-1], tdist[..., 1:]
  mid, half = (t0 + t1) / 2, (t1 - t0) / 2
  denom = torch.clamp(3 * mid**2 + half**2, min=F32_EPS)
  t_mean = mid + (2 * mid * half**2) / denom
  t_var = half**2 / 3 - (4 / 15) * half**4 * (12 * mid**2 - half**2) / denom**2
  r_var = (mid**2 / 4 + (5 / 12) * half**2 -
           (4 / 15) * half**4 / denom) * radii**2
  d = directions
  mean = d[..., None, :] * t_mean[..., None]
  d_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
  along = d[..., :, None] * d[..., None, :]
  eye = torch.eye(3, dtype=d.dtype, device=d.device)
  perp = eye - d[..., :, None] * (d / d_sq)[..., None, :]
  cov = (t_var[..., None, None] * along[..., None, :, :] +
         r_var[..., None, None] * perp[..., None, :, :])
  return mean + origins[..., None, :], cov


def alpha_weights(density, tdist, dirs, opaque_background):
  delta = (tdist[..., 1:] - tdist[..., :-1]) * torch.linalg.norm(
      dirs[..., None, :], dim=-1)
  depth = density * delta
  if opaque_background:
    depth = torch.cat([depth[..., :-1],
                       torch.full_like(depth[..., -1:], torch.inf)], dim=-1)
  alpha = 1 - torch.exp(-depth)
  trans = torch.exp(-torch.cat([torch.zeros_like(depth[..., :1]),
                                torch.cumsum(depth[..., :-1], dim=-1)], -1))
  return alpha * trans
