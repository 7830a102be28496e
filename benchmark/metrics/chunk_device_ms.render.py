"""Device-busy milliseconds per render chunk: the union of the device
intervals of the traced frames over their chunks."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'render'):
    return None
  return readers.busy_ms_per_unit(summary) / summary['chunks']
