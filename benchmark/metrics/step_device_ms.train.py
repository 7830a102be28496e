"""Device-busy milliseconds a train step: the union of the CUDA kernel,
copy and memset intervals of the traced steps, per step."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'train'):
    return None
  return readers.busy_ms_per_unit(summary)
