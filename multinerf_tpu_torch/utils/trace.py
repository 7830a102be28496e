"""The port's named spans, on the clock of torch.profiler's trace, and what
a profile says about them.

``span(name)`` is a host range: while a profiler records on the calling
thread it is a ``torch.profiler.record_function`` range, an event of the
same Kineto trace as the CUDA kernels, copies and memsets; otherwise it is
one boolean check and makes no ``RecordFunction`` (an unguarded range costs
microseconds even with the profiler off).  So the spans are written out
wherever a profile is: the benchmark's traced runs, ``profile_step`` and
``train.py``'s ``Config.profile_step`` TensorBoard trace.  No span reads
the device or changes a value.

The spans (``SPANS``) and where they are:

* ``train/step``: ``train_lib.create_train_step``'s step, holding
  ``train/cast`` (``cast_rays_in_train_step``), ``train/forward`` (the
  model through the summed loss), ``train/backward`` (``loss.backward()``),
  ``train/optimizer`` (clip, ``nan_to_num``, learning rate, Adam, the
  occupancy grid's update) and ``train/stats`` (the tree statistics).
* ``data/take`` and ``data/stage``: ``train_lib.Prefetcher``;
  ``data/wait``: a ``datasets.Dataset`` consumer blocked on the empty queue
  of its producer thread (one a starved take); ``data/draw``: a batch drawn
  and cast by ``device_sampler.DeviceDataPlane``.
* ``loop/sync``, ``loop/loss``, ``loop/summaries``, ``loop/checkpoint``,
  ``loop/test_render``: ``train.py``'s loop.
* ``render/frame``: a whole frame of ``nerf.DeviceImageRenderer`` or
  ``nerf.ImageRenderer``, holding ``render/chunk`` (one a chunk),
  ``render/assemble`` (the gather across ranks and the assembly) and
  ``render/to_host`` (the read-back).
* ``cull/compaction`` (``culling.COMPACTION``): the compaction and its
  gathers in ``culling.apply_culled``.
* ``parallel/collective``: every collective of ``parallel/mesh.py``.

Device work belongs to the innermost span whose host interval holds the
runtime call that launched it (a kernel launch, copy or memset), on any
thread of the process, and to the spans around that one.  The backward of
an op runs where its call to backward was, and below those spans it keeps
the spans its forward op was in (autograd's sequence numbers link the
two): the backward of the compaction's gathers belongs to
``train/backward`` and to ``cull/compaction``, not to ``train/forward``.
Work whose runtime call the profile lacks belongs to no span; its time is
counted apart, under ``UNLINKED``.
An idle gap of the device is named, whole, by the host's innermost span
where it begins: the host was there when the device ran out of work.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

import numpy as np
import torch

SPANS = ('train/step', 'train/cast', 'train/forward', 'train/backward',
         'train/optimizer', 'train/stats', 'data/take', 'data/stage',
         'data/wait', 'data/draw', 'loop/sync', 'loop/loss',
         'loop/summaries', 'loop/checkpoint', 'loop/test_render',
         'render/frame', 'render/chunk', 'render/assemble', 'render/to_host',
         'cull/compaction', 'parallel/collective')
OUTSIDE = 'outside'  # Idle time while the host is in no span.
UNLINKED = 'unlinked'  # Device time whose runtime call is not in the profile.

# Whether a profiler records on the calling thread.
_recording = torch._C._autograd._profiler_enabled  # pylint: disable=W0212
_OFF = contextlib.nullcontext()


def span(name):
  """A context manager: the host range `name` while a profiler records on
  this thread, else nothing."""
  if not _recording():
    return _OFF
  return torch.profiler.record_function(name)


# --- What a profile says about the spans. ------------------------------------

_CPU = torch.autograd.DeviceType.CPU
_CUDA = torch.autograd.DeviceType.CUDA


def union_us(intervals):
  """Total length of the union of (start, end) intervals."""
  total, end = 0.0, -np.inf
  for lo, hi in sorted(intervals):
    if hi > end:
      total += hi - max(lo, end)
      end = hi
  return total


def device_events(events):
  """The device activity of a profile's ``events()``: kernels, copies and
  memsets (not the device rows of the host ranges)."""
  return [e for e in events
          if e.device_type == _CUDA and not e.is_user_annotation]


def _interval(e):
  return e.time_range.start, e.time_range.end


class _Timeline:
  """The spans of a profile as host intervals: the chain of spans (outermost
  first) the host is in at any time, from the events of every thread."""

  def __init__(self, events):
    spans = [e for e in events
             if e.device_type == _CPU and e.name in SPANS]
    self.spans = spans
    self.bounds = sorted({t for e in spans for t in _interval(e)})
    self.chains = []
    for lo in self.bounds[:-1]:
      inside = sorted((e for e in spans
                       if e.time_range.start <= lo < e.time_range.end),
                      key=lambda e: (e.time_range.start, -e.time_range.end))
      self.chains.append(tuple(e.name for e in inside))

  def at(self, t):
    """The chain of spans at host time `t`."""
    i = bisect.bisect_right(self.bounds, t) - 1
    return self.chains[i] if 0 <= i < len(self.chains) else ()


def _is_runtime(e):
  """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
  cudaMemcpyAsync, ...): it shares its correlation id with the device
  activity it starts."""
  return (e.device_type == _CPU and e.name.startswith('cu') and
          '::' not in e.name and not e.is_user_annotation)


def _makers(cpu):
  """{(sequence number, thread): the forward op that made that autograd
  node}.  A forward op records its thread's sequence counter as it starts,
  and the op that makes a node takes that number for it: so the node of
  number s on a thread was made by the last outermost forward op that
  recorded s there.  Its backward carries s and that thread."""
  makers = {}
  for e in cpu:
    parent = e.cpu_parent
    if (e.sequence_nr < 0 or e.fwd_thread or
        (parent is not None and parent.sequence_nr == e.sequence_nr)):
      continue
    key = (e.sequence_nr, e.thread)
    if key not in makers or (e.time_range.start >
                             makers[key].time_range.start):
      makers[key] = e
  return makers


def _node_of(e):
  """(sequence number, forward thread) of the innermost autograd node whose
  backward the CPU event `e` is or runs in, or None outside a backward."""
  while e is not None:
    if e.sequence_nr >= 0 and e.fwd_thread:
      return e.sequence_nr, e.fwd_thread
    e = e.cpu_parent
  return None


class _Spans:
  """Which spans each host event of a profile belongs to."""

  def __init__(self, events):
    self.timeline = _Timeline(events)
    self.cpu = [e for e in events if e.device_type == _CPU and not e.is_async]
    self._makers = _makers(self.cpu)

  def of(self, e):
    """The chain of spans (outermost first) of the CPU event `e`: those its
    start is in and, for a backward, below them the spans of the forward op
    that made its node."""
    chain = self.timeline.at(e.time_range.start)
    maker = self._makers.get(_node_of(e))
    if maker is not None:
      chain = chain + self.timeline.at(maker.time_range.start)[len(chain):]
    return chain


def device_us_by_span(events):
  """{span: device time of the work that belongs to it (module docstring),
  the union of its intervals over the profile, in us}; the work whose
  runtime call the profile lacks is charged to no span but to
  ``UNLINKED``."""
  spans = _Spans(events)
  runtime = {e.id: e for e in spans.cpu if _is_runtime(e)}
  by_span = collections.defaultdict(list)
  for d in device_events(events):
    call = runtime.get(d.id)
    for name in spans.of(call) if call is not None else (UNLINKED,):
      by_span[name].append(_interval(d))
  return {name: union_us(v) for name, v in by_span.items()}


def idle_by_span(events):
  """{span: device idle us}: the gaps in the union of the device intervals
  between the profile's first event and its last, each named whole by the
  host's innermost span where it begins (the host was there when the device
  ran out of work; ``OUTSIDE`` in no span)."""
  timeline = _Timeline(events)
  intervals = sorted(_interval(d) for d in device_events(events))
  bounds = intervals + [_interval(e) for e in timeline.spans]
  if not intervals:
    return {}
  lo = min(a for a, _ in bounds)
  hi = max(b for _, b in bounds)
  gaps, end = [], lo
  for a, b in intervals:
    if a > end:
      gaps.append((end, a))
    end = max(end, b)
  if hi > end:
    gaps.append((end, hi))
  idle = collections.Counter()
  for a, b in gaps:
    chain = timeline.at(a)
    idle[chain[-1] if chain else OUTSIDE] += b - a
  return dict(idle)
