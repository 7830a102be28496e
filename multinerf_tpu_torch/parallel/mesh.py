"""Data and tensor parallelism across processes, one per device (port of
parallel/mesh.py).

The JAX package shards each batch over the ``data`` axis of one global mesh,
replicates the parameters, and lets XLA insert the gradient all-reduce.  The
port runs one process per GPU, launched by

    python -m torch.distributed.run --nproc_per_node=N --max-restarts=0 \
        -m multinerf_tpu_torch.train --gin_configs=... [--device=cuda]

and makes those collectives explicit through the helpers here: each rank
draws ``process_local_slice`` rays a step, the gradients and the step's
statistics are summed over the ranks, and the ranks' parameters stay
bitwise equal.  With no process group every helper returns its input and
nothing communicates, so one process computes what it did before.

The backend is NCCL for a CUDA device and gloo on the CPU.  Gloo also runs
on CUDA tensors (two ranks sharing one card, which NCCL refuses): its
collectives then go through pinned host memory, explicitly, since gloo's
own CUDA support differs from one collective to the next.  The process
group's timeout is finite, so a rank that dies ends the others' waits in a
collective; ``torch.distributed.run --max-restarts=0`` also stops the whole
run when one rank fails.

``create_mesh(model_parallel=k)`` lays the ranks out as the JAX mesh's
``(data, model)`` grid (devices reshaped to ``[n // k, k]``): rank
``data_rank * k + model_rank``.  It makes one model group per data index
(the k ranks that split the wide NerfMLP layers between them,
``parallel/tensor.py``) and one data group per model index (the ranks whose
gradients and batch rows are summed); the helpers take ``group=``.  Ranks
of one model group draw the same rays and hold the same replicated
parameters.  With k = 1 (and before any ``create_mesh``) the data group is
the whole world and the model group each rank alone, so every helper does
what it did with no model axis.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

TIMEOUT_SECONDS = 600


def _initialized() -> bool:
  return dist.is_available() and dist.is_initialized()


def init_from_env(device='cuda', backend=None,
                  timeout_seconds=TIMEOUT_SECONDS) -> int:
  """Join the process group that ``torch.distributed.run`` describes in the
  environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), if there is one
  and it is not joined yet.  `backend` ('nccl' or 'gloo') overrides the
  choice by `device`: NCCL for CUDA, gloo otherwise.  Returns the world
  size."""
  if not _initialized() and 'WORLD_SIZE' in os.environ:
    if backend is None:
      backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    dist.init_process_group(
        backend=backend, init_method='env://',
        rank=int(os.environ['RANK']),
        world_size=int(os.environ['WORLD_SIZE']),
        timeout=datetime.timedelta(seconds=timeout_seconds))
  return world_size()


def shutdown():
  """Leave the process group, if this process joined one, and forget the
  mesh."""
  global _MESH
  _MESH = None
  if _initialized():
    dist.destroy_process_group()


# A group of this process alone: every helper over it is the identity.
ALONE = 'alone'


@dataclasses.dataclass(frozen=True)
class Mesh:
  """The (data, model) layout of the ranks: `model_parallel` ranks a model
  group, their groups (a ProcessGroup, None for the whole world, or ALONE)
  and the tensor-parallel threshold of ``tensor.infer_layout``."""
  model_parallel: int
  data_group: Any
  model_group: Any
  min_dim_to_shard: int


_MESH = None


def create_mesh(model_parallel: int = 1, min_dim_to_shard: int = 512) -> Mesh:
  """Lay the ranks out as a (data, model) grid of [world // k, k], k =
  `model_parallel`, as the JAX package's create_mesh lays out devices;
  every rank calls it, after joining the process group, and every rank
  creates every group in the same order.  A dim of a Dense kernel is split
  over the model group when it is >= `min_dim_to_shard` and divisible by
  k (``tensor.infer_layout``).  Raises ValueError when the world size does
  not divide by k, and when k > 1 with no process group."""
  global _MESH
  n, k = world_size(), int(model_parallel)
  if k < 1 or n % k:
    raise ValueError(f'{n} processes not divisible by model_parallel={k}')
  if k > 1 and not _initialized():
    raise ValueError(f'model_parallel={k} needs a process group of {k} or '
                     'more ranks; none was joined.')
  data_group, model_group = None, ALONE
  if k > 1:
    me = rank()

    def group(ranks):
      made = dist.new_group(ranks) if len(ranks) > 1 else ALONE
      return made if me in ranks else None

    model_groups = [group(list(range(d * k, (d + 1) * k)))
                    for d in range(n // k)]
    data_groups = [group(list(range(m, n, k))) for m in range(k)]
    model_group = model_groups[me // k]
    data_group = data_groups[me % k]
  _MESH = Mesh(k, data_group, model_group, int(min_dim_to_shard))
  return _MESH


def model_size() -> int:
  return _MESH.model_parallel if _MESH else 1


def model_rank() -> int:
  return rank() % model_size()


def data_size() -> int:
  return world_size() // model_size()


def data_rank() -> int:
  return rank() // model_size()


def data_group():
  """The group of the ranks that hold this rank's model shards: the whole
  world with no model axis."""
  return _MESH.data_group if _MESH else None


def model_group():
  """The group of the ranks that split the model with this one; ALONE
  with no model axis."""
  return _MESH.model_group if _MESH else ALONE


def min_dim_to_shard() -> int:
  return _MESH.min_dim_to_shard if _MESH else 512


def group_size(group=None) -> int:
  """The ranks of `group` (None: the whole world)."""
  if group is ALONE or not _initialized():
    return 1
  return dist.get_world_size(group)


def group_rank(group=None) -> int:
  """This rank's index in `group` (None: the whole world)."""
  if group is ALONE or not _initialized():
    return 0
  return dist.get_rank(group)


def rank() -> int:
  return dist.get_rank() if _initialized() else 0


def world_size() -> int:
  return dist.get_world_size() if _initialized() else 1


def is_main() -> bool:
  """Whether this is rank 0, the one that writes files and logs."""
  return rank() == 0


def local_device(requested='cuda') -> torch.device:
  """The device of this process: a bare 'cuda' becomes
  'cuda:{LOCAL_RANK}' under ``torch.distributed.run`` (and the current
  device), and raises when that card is missing.  An explicit index
  ('cuda:0', how ranks share one card) and the CPU are taken as given."""
  device = torch.device(requested)
  if (device.type != 'cuda' or device.index is not None or
      'LOCAL_RANK' not in os.environ):
    return device
  index = int(os.environ['LOCAL_RANK'])
  count = torch.cuda.device_count()
  if index >= count:
    raise RuntimeError(f'LOCAL_RANK {index} has no card: {count} visible.')
  torch.cuda.set_device(index)
  return torch.device('cuda', index)


def process_local_slice(global_batch_size: int) -> int:
  """Rays this process must feed per step (global size / data-axis size:
  the ranks of a model group feed the same rays)."""
  n = data_size()
  if global_batch_size % n:
    raise ValueError(f'batch size {global_batch_size} not divisible by '
                     f'{n} processes')
  return global_batch_size // n


def _run(collective, tensor, group=None):
  """`collective(t)` in place on `tensor`; with gloo a CUDA tensor goes
  through pinned host memory."""
  if tensor.is_cuda and dist.get_backend(group) == 'gloo':
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    collective(host)
    tensor.copy_(host)
  else:
    collective(tensor)
  return tensor


def all_reduce_sum(tensor, group=None):
  """The sum of `tensor` over the ranks of `group` (None: all of them), in
  place; `tensor` itself over one rank."""
  if group_size(group) == 1:
    return tensor
  return _run(lambda t: dist.all_reduce(t, dist.ReduceOp.SUM, group=group),
              tensor, group)


def all_reduce_max(tensor, group=None):
  """The elementwise maximum of `tensor` over the ranks of `group`, in
  place."""
  if group_size(group) == 1:
    return tensor
  return _run(lambda t: dist.all_reduce(t, dist.ReduceOp.MAX, group=group),
              tensor, group)


def all_reduce_sum_dict(tensors, group=None):
  """{name: tensor} -> {name: its sum over the ranks of `group`}, through
  one all-reduce of the tensors packed into one float32 buffer."""
  if group_size(group) == 1 or not tensors:
    return dict(tensors)
  flat = all_reduce_sum(torch.cat(
      [t.detach().reshape(-1).to(torch.float32) for t in tensors.values()]),
                        group)
  out, start = {}, 0
  for name, t in tensors.items():
    out[name] = flat[start:start + t.numel()].reshape(t.shape).to(t.dtype)
    start += t.numel()
  return out


def all_gather_rows(tensor, group=None):
  """The `group` ranks' `tensor`s (the same shape on every rank)
  concatenated along dim 0 in rank order; `tensor` itself over one rank."""
  n = group_size(group)
  if n == 1:
    return tensor
  me = group_rank(group)

  def gather(parts):  # [n, ...], this rank's tensor at parts[me].
    out = [torch.empty_like(parts[me]) for _ in range(n)]
    dist.all_gather(out, parts[me].contiguous(), group=group)
    parts.copy_(torch.stack(out))

  parts = tensor.new_empty((n,) + tensor.shape)
  parts[me] = tensor
  _run(gather, parts, group)
  return parts.reshape((n * tensor.shape[0],) + tensor.shape[1:])


def barrier():
  """Wait until every rank gets here."""
  if world_size() == 1:
    return
  if dist.get_backend() == 'nccl':
    dist.barrier(device_ids=[torch.cuda.current_device()])
  else:
    dist.barrier()


def _scalar_device():
  return (torch.device('cuda', torch.cuda.current_device())
          if dist.get_backend() == 'nccl' else torch.device('cpu'))


def main_value(value: int) -> int:
  """Rank 0's integer `value`, on every rank."""
  if world_size() == 1:
    return value
  mine = value if is_main() else -2**62
  t = torch.tensor([mine], dtype=torch.int64, device=_scalar_device())
  return int(all_reduce_max(t).item())


def assert_replicated(tensors, what='tensors', group=None):
  """Raise unless every rank of `group` holds the same values in `tensors`
  ({name: tensor}); two all-reduces, nothing over one rank."""
  if group_size(group) == 1 or not tensors:
    return
  flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                    for t in tensors.values()])
  hi = all_reduce_max(flat.clone(), group)
  lo = all_reduce_max(-flat, group).neg_()
  if not torch.equal(hi, lo):
    raise RuntimeError(f'The ranks hold different {what}.')
