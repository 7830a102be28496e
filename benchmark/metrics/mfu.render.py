"""Forward model FLOPs of a frame over the mean frame time of the run's
unprofiled window, as a share of the card's dense bf16 peak."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'render'):
    return None
  return readers.mfu_pct(summary)
