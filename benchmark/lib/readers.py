"""Shared arithmetic of the per-layer readers (``benchmark/metrics``).

Each reader takes the traced run's summary (``trace.reduce_profile`` plus
the generator's fields: ``kind`` 'train' or 'render', ``unit_s`` the mean
step or frame of the same run's unprofiled window, ``model_flops`` per
unit, ``bounds_s`` the least seconds of each hand-written kernel's
launches, ``kernel_s`` their measured device seconds) and returns a
number or None: None where the run has nothing to read, such as a run
with no device activity, or a cell whose traffic launches no hand-written
kernel.
"""

from __future__ import annotations

from benchmark.lib import flops


def on_device(summary, kind):
  return (summary is not None and summary.get('kind') == kind and
          summary['device_events'] > 0 and summary['busy_s'] > 0)


def busy_ms_per_unit(summary):
  return 1e3 * summary['busy_s'] / summary['units']


def idle_pct(summary):
  return 100.0 * (1.0 - summary['busy_s'] / summary['units'] /
                  summary['unit_s'])


def mfu_pct(summary):
  return 100.0 * summary['model_flops'] / (summary['unit_s'] *
                                           flops.PEAK_BF16_FLOPS)


def roofline_pct(summary):
  measured = summary['kernel_s']
  if measured <= 0:
    return None
  return 100.0 * sum(summary['bounds_s'].values()) / measured
