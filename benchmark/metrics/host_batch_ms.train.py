"""Host milliseconds a train step spends taking its batch and staging the
next (the data plane: ``Prefetcher.take`` and ``stage``), from the
benchmark's spans in the traced steps."""
from benchmark.lib import readers


def read(summary):
  if not readers.on_device(summary, 'train'):
    return None
  spans = summary['span_s']
  return 1e3 * (spans.get('take', 0.0) + spans.get('stage', 0.0)) / (
      summary['units'])
