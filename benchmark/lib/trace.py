"""Spans around the port's calls, and the reduction of a torch.profiler
trace to the numbers the per-layer readers take.

The benchmark names its own spans (``bench/<what>``, host ranges through
``torch.profiler.record_function``) around the calls into each layer, and,
in a traced run only, wraps each launch of a hand-written kernel (K1-K4)
to record the least time its shapes allow.  The reduction takes the device
intervals (kernels, copies, memsets) of the profiled window: their union
is the busy time; the device kernels of the port's K1-K4 libraries, known
by name, are the hand-written kernels' time; the gaps in the union are
named by the innermost ``bench/`` span the host was in when each began.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import re

import numpy as np
import torch

from benchmark.lib import flops

SPAN = 'bench/'
# The device kernels of K1-K4 (csrc/density_mlp*.cu, featurize_dense*.cu
# and the featurize-cast and dW GEMM stages they share).
HAND_WRITTEN = re.compile(r'density_mlp_fwd_kernel|density_mlp_bwd_tile_kernel|'
                          r'featurize_dense_fwd_kernel|featurize_cast_kernel|'
                          r'dw_gemm_kernel|reduce_splits_kernel')


def union_s(intervals):
  """Seconds covered by a union of (start_us, end_us) intervals."""
  total, end = 0.0, -np.inf
  for lo, hi in sorted(intervals):
    if hi > end:
      total += hi - max(lo, end)
      end = hi
  return total / 1e6


def gaps_us(intervals, start, stop):
  """The (start, end) gaps of a union of intervals within [start, stop]."""
  out, end = [], start
  for lo, hi in sorted(intervals):
    if lo > end:
      out.append((end, min(lo, stop)))
    end = max(end, hi)
  if stop > end:
    out.append((end, stop))
  return [(a, b) for a, b in out if b > a]


def span(name):
  return torch.profiler.record_function(SPAN + name)


class KernelBounds:
  """Wraps the port's K1-K4 launch functions while active, adding up each
  launch's least time from its shapes.  Touches nothing while inactive."""

  # (module, function, kernel): the plain-or-launch entries of the port.
  ENTRIES = (('density_mlp', 'density_mlp_forward', 'K1'),
             ('featurize_dense', 'featurize_dense_forward', 'K2'),
             ('density_mlp', 'density_mlp_backward', 'K3'),
             ('featurize_dense', 'featurize_dense_dw', 'K4'))

  def __init__(self):
    self.bounds = collections.defaultdict(float)  # kernel -> seconds

  def _wrap(self, fn, kernel):
    @functools.wraps(fn)
    def wrapped(means, covs, *args, **kw):
      n = means.shape[0]
      if kernel in ('K1', 'K3'):
        ws = args[0]
        feats, width, depth = ws[0].shape[0], ws[0].shape[1], len(ws)
      elif kernel == 'K2':
        feats, width, depth = args[0].shape[0], args[0].shape[1], None
      else:  # K4: (g, basis [3, L], min_deg, max_deg, use_contract).
        static = dict(zip(('basis', 'min_deg', 'max_deg'), args[1:4]), **kw)
        feats = 2 * (static['max_deg'] - static['min_deg']) * np.asarray(
            static['basis']).shape[-1]
        width, depth = args[0].shape[1], None
      self.bounds[kernel] += flops.kernel_bound_s(kernel, n, feats, width,
                                                  depth)
      return fn(means, covs, *args, **kw)
    return wrapped

  @contextlib.contextmanager
  def active(self):
    import importlib
    saved = []
    for module, name, kernel in self.ENTRIES:
      mod = importlib.import_module(
          f'multinerf_tpu_torch.ops.kernels.{module}')
      saved.append((mod, name, getattr(mod, name)))
      setattr(mod, name, self._wrap(getattr(mod, name), kernel))
    try:
      yield self
    finally:
      for mod, name, fn in saved:
        setattr(mod, name, fn)


def reduce_profile(prof, wall_s, units):
  """The traced window's summary: busy seconds, the device ops by time,
  the idle gaps by host span, seconds per ``bench/`` span and the device
  seconds of the hand-written kernels.  `units` is the number of steps or
  frames in the window."""
  events = prof.events()
  device = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and
            not e.is_user_annotation]
  host_spans = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU and
                e.name.startswith(SPAN)]
  intervals = [(e.time_range.start, e.time_range.end) for e in device]
  by_op = collections.Counter()
  for e in device:
    by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
  span_s = collections.Counter()
  for e in host_spans:
    span_s[e.name[len(SPAN):]] += (e.time_range.end - e.time_range.start) / 1e6
  if host_spans:
    start = min(e.time_range.start for e in host_spans)
    stop = max(e.time_range.end for e in host_spans)
  else:
    start = min(i[0] for i in intervals) if intervals else 0
    stop = start + wall_s * 1e6
  idle = collections.Counter()
  for a, b in gaps_us(intervals, start, stop):
    inner = [e for e in host_spans
             if e.time_range.start <= a < e.time_range.end]
    name = (min(inner, key=lambda e: e.time_range.end - e.time_range.start)
            .name[len(SPAN):] if inner else 'outside')
    idle[name] += (b - a) / 1e6
  return {'busy_s': union_s(intervals), 'window_s': wall_s, 'units': units,
          'device_ops': [[k, v] for k, v in by_op.most_common(10)],
          'idle_gaps': [[k, v] for k, v in idle.most_common(10)],
          'span_s': dict(span_s),
          'kernel_s': sum(v for k, v in by_op.items() if HAND_WRITTEN.search(k)),
          'device_events': len(device)}
