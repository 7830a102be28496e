"""The program's own spans (``train/step``, ``data/take``, ...: host
ranges of the same profile) leave the benchmark's reduction as it was:
every key of ``trace.reduce_profile`` reads the same with them in the
profile as with them taken out."""

import torch

from benchmark.lib import trace

PROGRAM = ('data/take', 'data/stage', 'train/step', 'train/forward',
           'train/backward', 'train/optimizer')


class _Without:
  """A profile's events without the program's ranges."""

  def __init__(self, prof):
    self._events = [e for e in prof.events() if e.name not in PROGRAM]

  def events(self):
    return self._events


def test_program_spans_leave_the_summary_as_it_was():
  w = torch.randn(64, 64, requires_grad=True)
  x = torch.randn(32, 64)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    for _ in range(2):
      with trace.span('take'), torch.profiler.record_function('data/take'):
        batch = x + 1
      with trace.span('stage'), torch.profiler.record_function('data/stage'):
        batch = batch.clone()
      with trace.span('step'), torch.profiler.record_function('train/step'):
        with torch.profiler.record_function('train/forward'):
          loss = (batch @ w).square().mean()
        with torch.profiler.record_function('train/backward'):
          loss.backward()
        with torch.profiler.record_function('train/optimizer'):
          with torch.no_grad():
            w -= 0.1 * w.grad
          w.grad = None
  names = {e.name for e in prof.events()}
  assert set(PROGRAM) <= names
  got = trace.reduce_profile(prof, 0.01, 2)
  assert got == trace.reduce_profile(_Without(prof), 0.01, 2)
  assert set(got['span_s']) == {'take', 'stage', 'step'}
  assert {name for name, _ in got['idle_gaps']} <= {'take', 'stage', 'step',
                                                     'outside'}
