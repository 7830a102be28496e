"""Share of their roofline the hand-written kernels (K1-K4) reach in the
traced train steps: the sum of each launch's least time (from its shapes,
``flops.kernel_bound_s``) over the sum of the device time of the kernels
that launch started.  None where no such kernel ran."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'train'):
    return None
  return readers.roofline_pct(summary)
