"""Share of their roofline the hand-written kernels (K1, K2) reach in the
traced frames, as ``kernel_roofline.train`` reckons it."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'render'):
    return None
  return readers.roofline_pct(summary)
