"""Cells of BENCHMARK.json cut to debug widths, for the CPU tests.

The same files, generators and reference as a chip run, with the program's
widths, sample counts, batch and frame cut by extra gin bindings and the
reference's description cut to match.  On the CPU the program's kernel
wrappers take their plain versions.
"""

from __future__ import annotations

import copy

from benchmark.lib import harness

_MLP = {'NerfMLP': ('nerf_mlp', {'net_width': 32, 'net_width_viewdirs': 16,
                                 'bottleneck_width': 16, 'max_deg_point': 4}),
        'PropMLP': ('prop_mlp', {'net_width': 16, 'max_deg_point': 4})}


def small_cell(name, batch=64, frame=(24, 16)):
  """`name`'s Cell at debug widths: the gin bindings and the reference's
  model cut alike."""
  cell = harness.Cell(name)
  cfg = copy.deepcopy(cell.config)
  model = cfg['model']
  bindings = []
  for gin_name, (key, fields) in _MLP.items():
    if key not in model:
      continue
    for field, value in fields.items():
      if field == 'bottleneck_width' and model[key][field] == 0:
        continue
      model[key][field] = value
      bindings.append(f'{gin_name}.{field} = {value}')
  for field in ('num_prop_samples', 'num_nerf_samples'):
    model[field] = 8
    bindings.append(f'Model.{field} = 8')
  cfg['gin_bindings'] = list(cfg['gin_bindings']) + bindings
  cell.config = cfg
  traffic = copy.deepcopy(cell.traffic)
  if traffic['generator'] == 'train':
    traffic['batch_size'] = batch
    traffic['gin_bindings'] = [f'Config.batch_size = {batch}']
    traffic['trace_units'] = 2
  else:
    width, height = frame
    traffic['frame'] = {'width': width, 'height': height,
                        'focal': 1.2 * width, 'chunk': 128}
    traffic['check_pixels'] = 64
    traffic['reference_block'] = 32
  cell.traffic = traffic
  return cell
