"""Checks of the data-parallel train path on the card, one process per rank.

    python -m torch.distributed.run --nproc_per_node=N --max-restarts=0 \
        -m multinerf_tpu_torch.ddp_probe SPEC.json OUT_DIR

or with no launcher (one process, no process group).  SPEC.json holds
``device`` ('cuda': each rank's own card; 'cuda:0': every rank on card 0),
``backend`` (null: NCCL on CUDA; 'gloo'), ``model_parallel`` (default 1:
the ranks of ``mesh.create_mesh``'s model groups, which split the wide
NerfMLP layers; ``min_dim_to_shard``, default 512, its threshold) and
``parts``, run in turn, each saving this rank's result, with its seconds,
the world size and the model size, as ``OUT_DIR/<name>_rank<r>.pt``:

* kind ``step``: ``steps`` optimizer steps of the configuration of the gin
  flags ``argv`` on this rank's rows of one global batch: ``rays`` pixels
  of the train split drawn from numpy's ``RandomState(seed)`` and cast on
  the device by ``data/device_sampler.py``, their ray origins moved by
  ``train_lib.NUDGE`` with ``nudge``.  Give ``Config.randomized = False``
  for steps with no jitter.  Each step is ``train_lib.loss_and_grads`` then
  ``train_lib.apply_gradients``, as the train step runs them unculled.
  With ``drop_rank`` that rank's share of the gradient is zeroed before the
  all-reduce, with ``drop_model_rank`` that model rank's partial sum in the
  first forward all-reduce over the model group: the controls that
  ``hold_parity``'s bounds must catch.  Result: the losses, step 1's
  gradient (the global one, which the clip sees, split leaves gathered;
  rank 0 only), whether the ranks' parameters after every step are
  bitwise equal (leaves split over the model group across the data
  group), the bytes of parameters and Adam state this rank holds
  (``tensor.per_rank_bytes``), each step's synchronised ms, the launches of
  K1-K6 in each step, and with ``profile`` (on a card) the device ms of
  the last step's NCCL kernels on rank 0.
* kind ``render``: test view 0 of the configuration, rendered on its
  seed-0 weights by ``DeviceImageRenderer``.  Result: the frame (numpy
  buffers) and its launches.
* kind ``train``: ``train.main(argv)`` with the launches of K1-K6 counted
  around every step.  Result: the per-step launches, the plain-version
  calls, the losses, the step seconds, the process id and the files it
  opened for writing.
* kind ``eval``: ``eval.main(argv)`` with its launches counted.  Result:
  the metrics (on rank 0), launches, plain calls and the files written.

``Launch`` starts any command under ``torch.distributed.run`` with a time
limit, ``start_parts`` / ``part_results`` this module's parts, and
``hold_parity`` holds a 'step' part against one process's steps.
"""

from __future__ import annotations

import argparse
import builtins
import collections
import contextlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from multinerf_tpu_torch import bridge
from multinerf_tpu_torch import configs
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.data import device_sampler
from multinerf_tpu_torch.ops.kernels import density_mlp
from multinerf_tpu_torch.ops.kernels import featurize_dense
from multinerf_tpu_torch.ops.kernels import int8_trunk
from multinerf_tpu_torch.models import nerf
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.parallel import tensor
from multinerf_tpu_torch.utils import checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Step 1's loss: the ranks' shares sum in another order than one process's
# sums, nothing more.
LOSS_RTOL = 1e-5
# Steps 2-3 of 360.gin's step at full width with the bf16 or int8 trunk, on
# 4,096 fixed rays: Adam's first update carries step 1's last bits into
# them.  Set between the readings of the sound steps (up to 8.2e-5) and of
# the control with a rank's gradient dropped (from 1.3e-2; PERF.md, PR 17).
LATER_LOSS_RTOL = 4e-4

_COUNTERS = {
    'density_mlp': density_mlp.counts,
    'featurize_dense': featurize_dense.counts,
    'density_mlp_bwd': density_mlp.bwd_counts,
    'featurize_dense_dw': featurize_dense.bwd_counts,
    'int8_trunk': int8_trunk.counts,
    'int8_trunk_bwd': int8_trunk.bwd_counts,
}


def counts():
  """({kernel: launches}, {kernel: plain-version calls}) so far."""
  return ({k: c['launches'] for k, c in _COUNTERS.items()},
          {k: c['plain_calls'] for k, c in _COUNTERS.items()})


def _since(before):
  after = counts()
  return tuple({k: a[k] - b[k] for k in a} for a, b in zip(after, before))


@contextlib.contextmanager
def record_writes(paths):
  """Appends to `paths` every file opened for writing, by ``open`` or
  ``torch.save``, while it is entered."""
  real_open, real_save = builtins.open, torch.save

  def recording_open(file, mode='r', *args, **kwargs):
    if any(c in mode for c in 'wax+'):
      paths.append(os.path.abspath(str(file)))
    return real_open(file, mode, *args, **kwargs)

  def recording_save(obj, f, *args, **kwargs):
    if isinstance(f, (str, os.PathLike)):
      paths.append(os.path.abspath(str(f)))
    return real_save(obj, f, *args, **kwargs)

  builtins.open, torch.save = recording_open, recording_save
  try:
    yield
  finally:
    builtins.open, torch.save = real_open, real_save


def local_rows(batch):
  """This rank's rows (rays, or patches) of a global Batch."""
  n = mesh.process_local_slice(batch.rgb.shape[0])
  lo = mesh.data_rank() * n
  cut = lambda x: None if x is None else x[lo:lo + n]
  rays = type(batch.rays)(**{f: cut(getattr(batch.rays, f))
                             for f in batch.rays.__dataclass_fields__})
  return type(batch)(rays=rays, **{f: cut(getattr(batch, f))
                                   for f in ('rgb', 'disps', 'normals',
                                             'alphas')})


def global_batch_rows(config, device, rays, seed, nudge=False):
  """This rank's rows of a global batch of `rays` pixels of the train
  split, drawn from numpy's RandomState(`seed`) and cast on `device`."""
  with datasets.load_dataset('train', config.data_dir, config) as dataset:
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
    rng = np.random.RandomState(seed)
    pixels = [rng.randint(0, size, (rays, 1, 1)) for size in (
        dataset.width, dataset.height, dataset.size)]
  batch = plane.make_batch(*(torch.as_tensor(a, device=device)
                             for a in pixels))
  return local_rows(train_lib.nudge_origins(batch) if nudge else batch)


def drop_gradient(model, rank):
  """On rank `rank`, hooks that zero every parameter's gradient, so that
  the all-reduce sums the other ranks' shares alone; their handles."""
  if mesh.rank() != rank:
    return []
  return [p.register_hook(torch.zeros_like) for p in model.parameters()
          if p.requires_grad]


def drop_model_partial(rank):
  """On model rank `rank`, zero this rank's part in the next collective
  over the model group, once: a row layer's partial sum in its forward
  all-reduce (``tensor.reduce_from_model``), or, where the weights are
  gathered first (the int8 trunks), a weight's part in its all-gather."""
  if mesh.model_size() == 1 or mesh.model_rank() != rank:
    return
  reduce, gather = tensor.reduce_from_model, tensor.gather_from_model

  def restore():
    tensor.reduce_from_model, tensor.gather_from_model = reduce, gather

  def dropping_reduce(x):
    restore()
    return reduce(x * 0)

  def dropping_gather(part, split):
    if split is None:
      return gather(part, split)
    restore()
    return gather(part * 0, split)

  tensor.reduce_from_model = dropping_reduce
  tensor.gather_from_model = dropping_gather


@contextlib.contextmanager
def launch_sizes():
  """{kernel: [N of each launch]} of K2, K4, K5 and K6 while inside."""
  sizes = {}
  saved = []
  for module, attr, name in ((featurize_dense, '_launch', 'featurize_dense'),
                             (featurize_dense, '_launch_dw',
                              'featurize_dense_dw'),
                             (int8_trunk, '_launch', 'int8_trunk'),
                             (int8_trunk, '_launch_bwd', 'int8_trunk_bwd')):
    fn = getattr(module, attr)
    sizes[name] = []

    def record(means, *args, _fn=fn, _name=name, **kwargs):
      sizes[_name].append(int(means.shape[0]))
      return _fn(means, *args, **kwargs)
    saved.append((module, attr, fn))
    setattr(module, attr, record)
  try:
    yield sizes
  finally:
    for module, attr, fn in saved:
      setattr(module, attr, fn)


def replicated(params):
  """Whether the ranks hold bitwise equal `params` (checkpoints'
  assert_replicated: split leaves over the data group)."""
  try:
    checkpoints.assert_replicated(params)
    return True
  except RuntimeError:
    return False


def _sync(device):
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def _nccl_ms(fn, device):
  """fn() under torch.profiler: the device ms of its NCCL kernels."""
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    fn()
    _sync(device)
  return sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and
             'nccl' in e.name.lower()) / 1e3


def run_steps(argv, device, rays, steps, seed=0, nudge=False,
              drop_rank=None, drop_model_rank=None, profile=False):
  """The 'step' part: {'losses', 'grads1' (rank 0), 'replicated', 'bytes',
  'step_ms', 'per_step' (each step's launches), 'sizes' ({kernel: {N:
  launches}} of K2, K4, K5, K6), 'plain' (plain-version calls)}."""
  config = configs.load_config(configs_args(argv))
  model, state, _, _, lr_fn = train_lib.setup_model(config, 0, device)
  batch = global_batch_rows(config, device, rays, seed, nudge)
  if drop_rank is not None:
    drop_gradient(model, drop_rank)
  if drop_model_rank is not None:
    drop_model_partial(drop_model_rank)
  splits = tensor.splits_of(state.params)
  out = {'losses': [], 'per_step': [], 'step_ms': [],
         'replicated_steps': []}
  first = counts()

  def step():
    nonlocal state
    state.optimizer.zero_grad(set_to_none=True)
    i = state.step + 1
    train_frac = float(np.clip((i - 1) / (config.max_steps - 1), 0, 1))
    loss, _, _, grads = train_lib.loss_and_grads(model, config, batch,
                                                 train_frac)
    if i == 1:
      whole = {k: tensor.gather(v, k, splits) for k, v in grads.items()}
      if mesh.is_main():
        out['grads1'] = {k: v.float().cpu().numpy()
                         for k, v in whole.items()}
    state = train_lib.apply_gradients(state, grads, config, lr_fn)
    out['losses'].append(float(loss))

  with launch_sizes() as sizes:
    for i in range(steps):
      before = counts()
      _sync(device)
      t0 = time.perf_counter()
      if profile and i == steps - 1 and torch.device(device).type == 'cuda':
        out['allreduce_ms'] = _nccl_ms(step, device)
      else:
        step()
      _sync(device)
      out['step_ms'].append(1e3 * (time.perf_counter() - t0))
      out['per_step'].append(_since(before)[0])
      out['replicated_steps'].append(replicated(state.params))
  out['sizes'] = {k: dict(sorted(collections.Counter(v).items()))
                  for k, v in sizes.items() if v}
  out['plain'] = _since(first)[1]
  out['replicated'] = all(out['replicated_steps'])
  out['bytes'] = tensor.per_rank_bytes(bridge.named_parameters(model),
                                       state.optimizer)
  del model
  return out


def run_render(argv, device):
  """The 'render' part: test view 0 on the seed-0 weights."""
  config = configs.load_config(configs_args(argv))
  _, _, render_fn, _, _ = train_lib.setup_model(config, 0, device)
  before = counts()
  with datasets.load_dataset('test', config.data_dir, config) as dataset:
    frame = nerf.DeviceImageRenderer(render_fn, config, dataset,
                                     device)(1.0, 0)
  launches, plain = _since(before)
  return {'frame': frame, 'launches': launches, 'plain': plain}


def hold_parity(got, ref, ref_nudged, cap, later_rtol, control):
  """Readings of an N-rank 'step' part against one process's steps on its
  global batch, and whether they hold ('ok').  `got` is each rank's result,
  `ref` one process's, `ref_nudged` one process's on the nudged batch,
  `control` each rank's result of the same part with ``drop_rank``.

  Held: step 1's loss within LOSS_RTOL; the later steps' within
  `later_rtol`, a bound set from readings of the configuration, since
  Adam's first steps carry step 1's last bits further in some
  configurations than in others; the control's later steps missing
  `later_rtol` at least once, so the bound sees a rank's share of the
  gradient go missing; step 1's gradient by ``train_lib.leaf_gaps`` at
  `cap`; the ranks' losses equal and their parameters bitwise equal."""
  want = np.array(ref['losses'])
  gap = lambda result: np.abs(np.array(result[0]['losses']) / want - 1)
  gaps, control_gaps = gap(got), gap(control)
  bounds = np.full_like(gaps, later_rtol)
  bounds[0] = LOSS_RTOL
  leaves = train_lib.leaf_gaps(got[0]['grads1'], ref['grads1'],
                               ref_nudged['grads1'], cap=cap)
  worst = max((gap / bound, k) for k, (gap, _, bound) in leaves.items())
  out = {'losses': got[0]['losses'], 'one_process_losses': want.tolist(),
         'loss_gaps': gaps.tolist(), 'loss_bounds': bounds.tolist(),
         'control_loss_gaps': control_gaps.tolist(),
         'control_caught': bool(np.any(control_gaps[1:] > later_rtol)),
         'worst_gradient_leaf': [worst[1], worst[0]],
         'leaves_over': sorted(k for k, (gap, _, bound) in leaves.items()
                               if not gap <= bound),
         'replicated': all(r['replicated'] for r in got),
         'same_losses': all(r['losses'] == got[0]['losses'] for r in got)}
  out['ok'] = bool(np.all(gaps <= bounds) and out['control_caught'] and
                   not out['leaves_over'] and out['replicated'] and
                   out['same_losses'])
  return out


def configs_args(argv):
  """Parsed gin flags of `argv` (--gin_configs / --gin_bindings)."""
  parser = argparse.ArgumentParser()
  configs.add_common_flags(parser)
  return parser.parse_args(argv)


def run_train(argv):
  """The 'train' part: train.main with the launches counted per step."""
  from multinerf_tpu_torch import train
  per_step = []
  create_train_step = train_lib.create_train_step

  def counted_train_step(*args, **kwargs):
    step_fn = create_train_step(*args, **kwargs)

    def step(*step_args):
      before = counts()
      out = step_fn(*step_args)
      per_step.append(_since(before)[0])
      return out
    return step

  before, writes = counts(), []
  train_lib.create_train_step = counted_train_step
  try:
    with record_writes(writes):
      summary = train.main(argv)
  finally:
    train_lib.create_train_step = create_train_step
  return {'per_step': per_step, 'plain': _since(before)[1],
          'losses': summary['losses'],
          'step_seconds': summary['step_seconds'], 'pid': os.getpid(),
          'writes': writes}


def run_eval(argv):
  """The 'eval' part: eval.main with its launches counted."""
  from multinerf_tpu_torch import eval as eval_lib
  before, writes = counts(), []
  with record_writes(writes):
    evaluated = eval_lib.main(argv)
  launches, plain = _since(before)
  metrics = {step: v for step, v in evaluated.items() if step != 'out_dir'}
  return {'metrics': metrics, 'launches': launches, 'plain': plain,
          'writes': writes}


class LaunchError(RuntimeError):
  """A launch that failed (`returncode`) or ran past its time limit
  (`returncode` None); `output` holds what its ranks printed."""

  def __init__(self, message, returncode, output):
    super().__init__(message)
    self.returncode, self.output = returncode, output


class Launch:
  """``python -m torch.distributed.run --nproc_per_node=nproc --standalone
  --max-restarts=0`` of `args` (a script and its arguments, or '-m' and a
  module), started at once in a process group of its own, from the
  repository's root with it on PYTHONPATH and OMP_NUM_THREADS=`threads`."""

  def __init__(self, nproc, args, threads=4):
    env = dict(os.environ, OMP_NUM_THREADS=str(threads), PYTHONPATH=(
        REPO + os.pathsep + os.environ.get('PYTHONPATH', '')))
    self.what = f'{" ".join(args[:2])} at {nproc} rank(s)'
    self.started = time.perf_counter()
    self.proc = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run',
         f'--nproc_per_node={nproc}', '--standalone', '--max-restarts=0'] +
        list(args), cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)

  def wait(self, timeout):
    """Its output once it has exited 0; LaunchError if it failed, or if it
    still ran `timeout` seconds after its start: then its whole process
    group is killed."""
    left = max(1.0, timeout - (time.perf_counter() - self.started))
    try:
      out, _ = self.proc.communicate(timeout=left)
    except subprocess.TimeoutExpired:
      os.killpg(self.proc.pid, signal.SIGKILL)
      out, _ = self.proc.communicate()
      raise LaunchError(f'{self.what}: killed after {timeout} s:\n'
                        f'{out[-3000:]}', None, out) from None
    if self.proc.returncode:
      raise LaunchError(f'{self.what}: exit {self.proc.returncode}:\n'
                        f'{out[-3000:]}', self.proc.returncode, out)
    return out


def start_parts(nproc, spec, out_dir):
  """The Launch of this module's parts `spec` at `nproc` ranks, writing
  their results under `out_dir`."""
  os.makedirs(out_dir, exist_ok=True)
  spec_path = os.path.join(out_dir, 'spec.json')
  with open(spec_path, 'w') as f:
    json.dump(spec, f)
  return Launch(nproc, ['-m', 'multinerf_tpu_torch.ddp_probe', spec_path,
                        out_dir])


def part_results(nproc, spec, out_dir):
  """{part name: [each rank's result]} of a finished start_parts."""
  return {part['name']: [torch.load(
      os.path.join(out_dir, f'{part["name"]}_rank{r}.pt'), weights_only=False)
                         for r in range(nproc)] for part in spec['parts']}


def main(argv):
  spec_path, out_dir = argv
  with open(spec_path) as f:
    spec = json.load(f)
  device = configs.setup_device(spec.get('device', 'cuda'),
                                spec.get('backend'))
  mesh.create_mesh(spec.get('model_parallel', 1),
                   spec.get('min_dim_to_shard', 512))
  for part in spec['parts']:
    t0 = time.perf_counter()
    if part['kind'] == 'step':
      result = run_steps(part['argv'], device, part['rays'], part['steps'],
                         part.get('seed', 0), part.get('nudge', False),
                         part.get('drop_rank'), part.get('drop_model_rank'),
                         part.get('profile', False))
    elif part['kind'] == 'render':
      result = run_render(part['argv'], device)
    elif part['kind'] == 'train':
      result = run_train(part['argv'] + [f'--device={device}'])
    elif part['kind'] == 'eval':
      result = run_eval(part['argv'] + [f'--device={device}'])
    else:
      raise ValueError(f'Unknown part kind {part["kind"]!r}.')
    result['world_size'] = mesh.world_size()
    result['model_size'] = mesh.model_size()
    result['seconds'] = time.perf_counter() - t0
    torch.save(result, os.path.join(
        out_dir, f'{part["name"]}_rank{mesh.rank()}.pt'))
    mesh.barrier()
  mesh.shutdown()


if __name__ == '__main__':
  main(sys.argv[1:])
