"""The port's spans (``multinerf_tpu_torch/utils/trace.py``): free while no
profiler records, where they sit in a train step, a frame and the data
plane, and the reduction of a profile to device time and idle time by
span, on a synthetic profile whose backward runs on another thread.

Debug widths (``configs/debug.gin`` cut further), on the CPU; a CPU profile
has host events only, so the device arithmetic is checked on events built
by hand, with the fields a CUDA profile gives them.  One test, marked
``cuda``, profiles a step on the GPU: each of its kernels, copies and
memsets finds the runtime call that launched it.
"""

import argparse
import contextlib
import dataclasses
import os
import sys
import threading
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import EventList
from torch.autograd.profiler_util import FunctionEvent

from multinerf_tpu_torch import bridge
from multinerf_tpu_torch import configs
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.models import nerf
from multinerf_tpu_torch.utils import trace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINDINGS = ("Config.dataset_loader = 'dummy'", 'Config.batch_size = 64',
            'Config.render_chunk_size = 96', 'Model.num_prop_samples = 8',
            'Model.num_nerf_samples = 8', 'PropMLP.net_width = 16',
            'NerfMLP.net_width = 32')
FRAME = (24, 16)  # 384 rays: 4 chunks of 96.


def _profile():
  return torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(events):
  return [e for e in events if e.name in trace.SPANS]


def _inside(inner, outer):
  return (outer.time_range.start <= inner.time_range.start and
          inner.time_range.end <= outer.time_range.end)


@pytest.fixture(scope='module')
def debug():
  """One step of two models from the same seed on the same batch, one off
  the profiler (its ranges replaced by a recorder), one under it; and a
  frame under it."""
  config = configs.load_config(argparse.Namespace(
      gin_configs=[os.path.join(ROOT, 'configs', 'debug.gin')],
      gin_bindings=list(BINDINGS)))
  out = {'config': config}
  with datasets.load_dataset('train', None, config, seed=3) as dataset:
    batch = next(dataset)  # The same host batch for both steps.

    def step(profiled):
      model, state, render_fn, train_step, _ = train_lib.setup_model(
          config, 5, 'cpu', dataset)
      feed = train_lib.Prefetcher(iter([batch, batch]), 'cpu')
      generator = torch.Generator().manual_seed(1)
      with _profile() if profiled else contextlib.nullcontext() as prof:
        state, stats = train_step(generator, state, feed.take(), 0.0, True)
        feed.stage()
      params = {k: v.detach().clone()
                for k, v in bridge.named_parameters(model).items()}
      return params, stats['loss'], render_fn, prof

    calls = []
    with pytest.MonkeyPatch.context() as patch:
      patch.setattr(torch.profiler, 'record_function',
                    lambda name: calls.append(name) or
                    contextlib.nullcontext())
      out['plain'] = step(False)[:2]
    out['calls'] = calls
    params, loss, render_fn, prof = step(True)
    out['profiled'] = params, loss
    out['step_events'] = prof.events()
  test_config = dataclasses.replace(config, render_path=True,
                                    render_resolution=FRAME)
  with datasets.load_dataset('test', None, test_config) as test:
    renderer = nerf.choose_renderer(render_fn, test_config, test, 'cpu')
    with _profile() as prof:
      renderer(1.0, 0)
  out['renderer'] = renderer
  out['frame_events'] = prof.events()
  return out


def test_off_the_profiler_a_span_makes_no_record_function(debug):
  assert debug['calls'] == []
  assert not torch._C._autograd._profiler_enabled()  # pylint: disable=W0212
  assert trace.span('train/step') is trace.span('render/frame')


def test_spans_leave_the_step_unchanged(debug):
  (plain, plain_loss), (profiled, profiled_loss) = (debug['plain'],
                                                    debug['profiled'])
  assert torch.equal(plain_loss, profiled_loss)
  assert set(plain) == set(profiled)
  for name, value in plain.items():
    assert torch.equal(value, profiled[name]), name


def test_a_profiled_step_holds_its_phases(debug):
  spans = _spans(debug['step_events'])
  names = [e.name for e in spans]
  assert names.count('train/step') == 1
  step = spans[names.index('train/step')]
  for phase in ('train/forward', 'train/backward', 'train/optimizer'):
    assert names.count(phase) == 1, phase
    assert _inside(spans[names.index(phase)], step), phase
  order = [e.name for e in spans
           if e.name in ('train/forward', 'train/backward', 'train/optimizer')]
  assert order == ['train/forward', 'train/backward', 'train/optimizer']
  # The tree statistics, before and after Adam.
  assert [e for e in spans if e.name == 'train/stats' and _inside(e, step)]
  take = spans[names.index('data/take')]
  stage = [e for e in spans if e.name == 'data/stage']
  assert take.time_range.end <= step.time_range.start
  assert stage[-1].time_range.start >= step.time_range.end


def test_a_profiled_frame_has_a_chunk_span_per_planned_chunk(debug):
  spans = _spans(debug['frame_events'])
  names = [e.name for e in spans]
  _, num_chunks, _ = nerf._plan_chunks(debug['config'],  # pylint: disable=W0212
                                       FRAME[0] * FRAME[1])
  assert isinstance(debug['renderer'], nerf.DeviceImageRenderer)
  assert num_chunks == 4
  assert names.count('render/frame') == 1
  assert names.count('render/chunk') == num_chunks
  assert names.count('render/assemble') == names.count('render/to_host') == 1
  frame = spans[names.index('render/frame')]
  assert all(_inside(e, frame) for e in spans)


def test_data_wait_only_where_the_queue_is_empty(debug):
  with datasets.load_dataset('train', None, debug['config'],
                             seed=4) as dataset:
    # The producer's first batch waits until the consumer has found the
    # queue empty.
    gate = threading.Event()
    make = dataset._next_train  # pylint: disable=W0212
    dataset._next_train = lambda: gate.wait(60) and make()
    timer = threading.Timer(0.2, gate.set)
    with _profile() as prof:
      timer.start()
      next(dataset)
      deadline = time.monotonic() + 60
      while not dataset._queue.full():  # pylint: disable=W0212
        assert time.monotonic() < deadline, 'the producer never filled'
        time.sleep(0.01)
      next(dataset)
  assert [e.name for e in _spans(prof.events())] == ['data/wait']


# --- A synthetic CUDA profile. ------------------------------------------------
#
# Host thread 1 (us): train/step [0, 100] holding train/forward [0, 40]
# (with cull/compaction [10, 20]), train/backward [50, 95] and
# train/optimizer [95, 99].  The backward runs on thread 2, its nodes
# linked by sequence numbers to the forward ops on thread 1 that made them.
# Each launch is a runtime call sharing its id with its kernel; the forward
# mm's own id is one of those ids too, as the profiler's two counters allow.
# Device: [5, 15] forward mm, [15, 18] compaction index, [60, 70] its
# backward, [72, 90] the mm's backward, [97, 98] Adam.


def _event(name, start, end, thread=1, device=DeviceType.CPU, eid=0,
           seq=-1, fwd_thread=0, annotation=False):
  return FunctionEvent(id=eid, name=name, thread=thread, start_us=start,
                       end_us=end, fwd_thread=fwd_thread, sequence_nr=seq,
                       device_type=device, is_user_annotation=annotation)


def _synthetic(unlinked=None):
  span = lambda name, start, end: _event(name, start, end, annotation=True)
  kernel = lambda eid, start, end: _event(f'kernel{eid}', start, end,
                                          thread=0, device=DeviceType.CUDA,
                                          eid=eid)
  launch = lambda eid, start, thread: _event('cudaLaunchKernel', start,
                                             start + 0.5, thread, eid=eid)
  events = [
      span('train/step', 0, 100), span('train/forward', 0, 40),
      _event('aten::mm', 1, 5, eid=104, seq=0), launch(101, 2, 1),
      span('cull/compaction', 10, 20),
      _event('aten::index', 11, 14, eid=7, seq=1), launch(102, 12, 1),
      span('train/backward', 50, 95),
      _event('autograd::engine::evaluate_function: IndexBackward0', 55, 60,
             thread=2, eid=8, seq=1, fwd_thread=1),
      _event('aten::index_put_', 56, 59, thread=2, eid=9), launch(103, 57, 2),
      _event('autograd::engine::evaluate_function: MmBackward0', 61, 70,
             thread=2, eid=10, seq=0, fwd_thread=1),
      _event('aten::mm', 62, 69, thread=2, eid=11), launch(104, 63, 2),
      span('train/optimizer', 95, 99),
      _event('aten::add_', 96, 97, eid=12), launch(105, 96.2, 1),
      kernel(101, 5, 15), kernel(102, 15, 18), kernel(103, 60, 70),
      kernel(104, 72, 90), kernel(105, 97, 98),
      # The device row of a host range is no device work.
      _event('train/forward', 5, 18, thread=0, device=DeviceType.CUDA,
             annotation=True)]
  if unlinked is not None:
    events.append(kernel(200, *unlinked))
  events.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
  out = EventList(events)
  out._build_tree()  # pylint: disable=W0212
  return out


def test_device_time_by_span_follows_launches_and_backward():
  assert trace.device_us_by_span(_synthetic()) == {
      'train/step': 13 + 28 + 1, 'train/forward': 13,
      'cull/compaction': 3 + 10, 'train/backward': 10 + 18,
      'train/optimizer': 1}


def test_device_time_without_its_runtime_call_is_charged_to_no_span():
  # A kernel in train/forward's interval whose launch the profile lacks.
  by_span = trace.device_us_by_span(_synthetic(unlinked=(20, 25)))
  assert by_span == {
      'train/step': 42, 'train/forward': 13, 'cull/compaction': 13,
      'train/backward': 28, 'train/optimizer': 1, trace.UNLINKED: 5}


def test_idle_is_named_by_the_hosts_innermost_span():
  # Gaps [0, 5], [18, 60], [70, 72], [90, 97], [98, 100], each whole by the
  # host's innermost span where it begins.
  assert trace.idle_by_span(_synthetic()) == {
      'train/forward': 5, 'cull/compaction': 42, 'train/backward': 2 + 7,
      'train/optimizer': 2}
  assert trace.idle_by_span(EventList([])) == {}


@pytest.mark.cuda
def test_every_device_event_of_a_gpu_step_finds_its_runtime_call():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA GPU.')
  device = torch.device('cuda')
  config = configs.load_config(argparse.Namespace(
      gin_configs=[tp.CONFIG_360],
      gin_bindings=list(tp.SMALL_BINDINGS) + [
          "Config.dataset_loader = 'dummy_unbounded'",
          'Config.batch_size = 256']))
  with datasets.load_dataset('train', None, config, seed=0) as dataset:
    _, state, _, train_step, _ = train_lib.setup_model(config, 0, device,
                                                       dataset)
    feed = train_lib.Prefetcher(dataset, device)
    generator = torch.Generator(device).manual_seed(1)
    # The first step builds the kernels; the second is profiled.
    for profiled in (False, True):
      activities = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
      with (torch.profiler.profile(activities=activities) if profiled else
            contextlib.nullcontext()) as prof:
        state, _ = train_step(generator, state, feed.take(), 0.5, True)
        feed.stage()
        torch.cuda.synchronize(device)
  events = prof.events()
  assert len(trace.device_events(events)) > 100
  by_span = trace.device_us_by_span(events)
  assert trace.UNLINKED not in by_span, by_span
  for name in ('train/step', 'train/forward', 'train/backward',
               'train/optimizer'):
    assert by_span.get(name, 0) > 0, name
