"""Data parallelism across processes, one per device (port of parallel/mesh.py).

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
"""

from __future__ import annotations

import datetime
import os

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
  """Leave the process group, if this process joined one."""
  if _initialized():
    dist.destroy_process_group()


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
  """Rays this process must feed per step (global size / process count)."""
  n = world_size()
  if global_batch_size % n:
    raise ValueError(f'batch size {global_batch_size} not divisible by '
                     f'{n} processes')
  return global_batch_size // n


def _run(collective, tensor):
  """`collective(t)` in place on `tensor`; with gloo a CUDA tensor goes
  through pinned host memory."""
  if tensor.is_cuda and dist.get_backend() == 'gloo':
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    collective(host)
    tensor.copy_(host)
  else:
    collective(tensor)
  return tensor


def all_reduce_sum(tensor):
  """The sum of `tensor` over the ranks, in place; `tensor` itself with no
  process group."""
  if world_size() == 1:
    return tensor
  return _run(lambda t: dist.all_reduce(t, dist.ReduceOp.SUM), tensor)


def all_reduce_max(tensor):
  """The elementwise maximum of `tensor` over the ranks, in place."""
  if world_size() == 1:
    return tensor
  return _run(lambda t: dist.all_reduce(t, dist.ReduceOp.MAX), tensor)


def all_reduce_sum_dict(tensors):
  """{name: tensor} -> {name: its sum over the ranks}, through one
  all-reduce of the tensors packed into one float32 buffer."""
  if world_size() == 1 or not tensors:
    return dict(tensors)
  flat = all_reduce_sum(torch.cat(
      [t.detach().reshape(-1).to(torch.float32) for t in tensors.values()]))
  out, start = {}, 0
  for name, t in tensors.items():
    out[name] = flat[start:start + t.numel()].reshape(t.shape).to(t.dtype)
    start += t.numel()
  return out


def all_gather_rows(tensor):
  """The ranks' `tensor`s (the same shape on every rank) concatenated along
  dim 0 in rank order; `tensor` itself with no process group."""
  n = world_size()
  if n == 1:
    return tensor
  me = rank()

  def gather(parts):  # [n, ...], this rank's tensor at parts[me].
    out = [torch.empty_like(parts[me]) for _ in range(n)]
    dist.all_gather(out, parts[me].contiguous())
    parts.copy_(torch.stack(out))

  parts = tensor.new_empty((n,) + tensor.shape)
  parts[me] = tensor
  _run(gather, parts)
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


def assert_replicated(tensors, what='tensors'):
  """Raise unless every rank holds the same values in `tensors` ({name:
  tensor}); two all-reduces, nothing with no process group."""
  if world_size() == 1:
    return
  flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                    for t in tensors.values()])
  hi = all_reduce_max(flat.clone())
  lo = all_reduce_max(-flat).neg_()
  if not torch.equal(hi, lo):
    raise RuntimeError(f'The ranks hold different {what}.')
