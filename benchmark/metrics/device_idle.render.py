"""Share of a frame the device is idle, as ``device_idle.train`` reckons
it per frame."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'render'):
    return None
  return readers.idle_pct(summary)
