"""Share of a train step the device is idle: 1 - the traced steps' busy
time per step over the mean step time of the run's unprofiled window (the
profiler lengthens the steps it traces)."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'train'):
    return None
  return readers.idle_pct(summary)
