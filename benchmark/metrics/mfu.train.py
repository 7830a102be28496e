"""Model FLOPs of a train step over the mean step time of the run's
unprofiled window, as a share of the card's dense bf16 peak."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'train'):
    return None
  return readers.mfu_pct(summary)
