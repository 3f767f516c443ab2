"""Data parallelism over devices: one process per device.

Counterpart of ``geeco_tpu/parallel/mesh.py``.  The JAX package shards a
leading batch axis over a 1-d 'data' mesh and lets XLA partition one
program.  Here each device gets a process of its own, joined by
``torch.distributed``: the env step is bound by the host's launches (some
thousands a substep), so one host thread driving several devices would not
scale, and N processes do.

  * ``launch(fn, n, *args, device=, init_dir=)`` starts n ranks and runs
    ``fn(*args)`` in each: NCCL on ``cuda:rank``, gloo on the CPU, the
    group initialised through a file in ``init_dir`` (no TCP port).  Too
    few visible cards raises; nothing shares a card or drops to the CPU.
  * ``make_mesh()`` inside a rank describes the group: its size, this
    rank, this rank's device, and which rows of a batch are this rank's.
  * env batch: every rank steps its own rows (``shard_env_batch``);
    physics and rendering are per env, so nothing crosses devices inside
    the step, and results are gathered in global env order
    (``all_gather_rows``).
  * training: parameters replicated, the batch split, gradients
    all-reduced to the global-batch mean (``models/train.py``).

A placement is a row cut here (``Mesh.rows``), so the JAX package's
``batch_sharding``/``replicated`` and ``models/train.py``'s
``data_parallel_sharding``, which only name XLA placements, have no
counterpart.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
  """A 1-d 'data' mesh: ``size`` ranks, one device each; this process is
  ``rank`` on ``device``."""
  size: int
  rank: int
  device: torch.device
  axis: str = 'data'

  @property
  def is_root(self) -> bool:
    return self.rank == 0

  def rows(self, batch: int) -> slice:
    """This rank's rows of a [batch] axis: the rank-th of ``size`` equal
    blocks."""
    if batch % self.size:
      raise ValueError(f'leading dim {batch} not divisible by the '
                       f'{self.size}-device {self.axis} axis')
    n = batch // self.size
    return slice(self.rank * n, (self.rank + 1) * n)


def rank_device(device, rank: int) -> torch.device:
  """The device of ``rank`` when the run asks for ``device``: the rank-th
  card for CUDA (None means CUDA), the CPU for the CPU."""
  dev = torch.device('cuda' if device is None else device)
  if dev.type == 'cuda':
    return torch.device('cuda', rank)
  if dev.type == 'cpu':
    return dev
  raise ValueError(f'no data parallelism over {dev.type} devices')


def make_mesh(n_devices: Optional[int] = None, axis: str = 'data') -> Mesh:
  """The mesh of this process: the running process group, or, outside
  one, a single rank on the default device (``n_devices`` of 1 or None).
  ``n_devices`` larger than one needs the ranks ``launch`` starts."""
  if dist.is_available() and dist.is_initialized():
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, size):
      raise ValueError(f'a mesh of {n_devices} devices in a group of {size}')
    dev = (torch.device('cuda', torch.cuda.current_device())
           if dist.get_backend() == 'nccl' else torch.device('cpu'))
    return Mesh(size, rank, dev, axis)
  if (n_devices or 1) > 1:
    raise RuntimeError(f'make_mesh({n_devices}): start the ranks with '
                       'parallel.mesh.launch (one process per device)')
  return Mesh(1, 0, torch.device('cuda' if torch.cuda.is_available()
                                 else 'cpu'), axis)


def launch(fn: Callable, n_devices: int, *args, device=None,
           init_dir: str = '.', timeout: Optional[float] = None) -> Any:
  """Run ``fn(*args)`` in ``n_devices`` processes, one per device, and
  return rank 0's result.

  ``device`` is the run's device ('cuda', None for the card, or 'cpu'):
  rank r takes ``cuda:r`` with NCCL, or the CPU with gloo.  The ranks are
  spawned (fresh interpreters: ``fn`` and ``args`` are pickled) and
  rendezvous through a file made in ``init_dir``.  A rank's exception is
  raised here, and rank 0's ``SystemExit`` (a stop all ranks took
  together) is raised again with its code; ``timeout`` (seconds) kills the
  ranks and raises ``TimeoutError``."""
  import torch.multiprocessing as mp
  dev_type = rank_device(device, 0).type
  if dev_type == 'cuda':
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n_devices:
      raise RuntimeError(f'--num_devices {n_devices}: {visible} CUDA '
                         'device(s) visible (one process per card; no card '
                         'is shared)')
  os.makedirs(init_dir, exist_ok=True)
  stem = os.path.join(os.path.abspath(init_dir),
                      f'.dist-{os.getpid()}-{time.time_ns()}')
  ctx = mp.start_processes(_rank_main, args=(n_devices, dev_type, stem, fn,
                                             args),
                           nprocs=n_devices, join=False,
                           start_method='spawn')
  deadline = None if timeout is None else time.monotonic() + timeout
  try:
    while not ctx.join(timeout=1.0):
      if deadline is not None and time.monotonic() > deadline:
        for p in ctx.processes:
          p.kill()
        for p in ctx.processes:
          p.join()
        raise TimeoutError(f'{n_devices} ranks did not end within '
                           f'{timeout} s')
    with open(stem + '.result', 'rb') as f:
      kind, value = pickle.load(f)
    if kind == 'exit':
      raise SystemExit(value)
    return value
  finally:
    for suffix in ('', '.result'):
      if os.path.exists(stem + suffix):
        os.remove(stem + suffix)


def _rank_main(rank: int, size: int, dev_type: str, stem: str, fn: Callable,
               args: tuple):
  backend = 'nccl' if dev_type == 'cuda' else 'gloo'
  if dev_type == 'cuda':
    torch.cuda.set_device(rank)
  dist.init_process_group(backend, init_method=f'file://{stem}', rank=rank,
                          world_size=size)
  try:
    try:
      result = ('return', fn(*args))
    except SystemExit as e:     # a stop the ranks agreed on (any_rank)
      result = ('exit', e.code)
    if rank == 0:
      with open(stem + '.result', 'wb') as f:
        pickle.dump(result, f)
    dist.barrier()
  finally:
    dist.destroy_process_group()


# ------------------------------------------------------------- env batch


def _map_rows(tree, fn):
  """``fn`` on every tensor or array leaf of a dataclass / NamedTuple /
  dict / list / tuple tree; other leaves are kept."""
  if isinstance(tree, (torch.Tensor, np.ndarray)):
    return fn(tree)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: _map_rows(getattr(tree, f.name), fn)
        for f in dataclasses.fields(tree)})
  if isinstance(tree, tuple) and hasattr(tree, '_fields'):
    return type(tree)(*(_map_rows(x, fn) for x in tree))
  if isinstance(tree, dict):
    return {k: _map_rows(v, fn) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map_rows(x, fn) for x in tree)
  return tree


def shard_env_batch(batched_tree, mesh: Mesh):
  """This rank's rows of a [B, ...] tree (an EnvState, a ResetSpec, a
  dict of tensors), on the rank's device."""
  def take(x):
    x = x[mesh.rows(x.shape[0])]
    return x.to(mesh.device) if isinstance(x, torch.Tensor) else x
  return _map_rows(batched_tree, take)


def batched_env_step(env, mesh: Optional[Mesh] = None):
  """The env step over a whole [B] batch.  Without a mesh (or with one
  rank) that is ``env.step``.  With one, every rank steps its rows of the
  batch (``shard_env_batch``) and the new state is gathered in global env
  order on every rank, as the JAX package's sharded step returns the
  global batch."""
  if mesh is None or mesh.size == 1:
    return env.step

  def step(es, action):
    out = env.step(shard_env_batch(es, mesh), shard_env_batch(action, mesh))
    return _map_rows(out, lambda x: all_gather_rows(x, mesh))
  return step


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """The ranks' [b, ...] shards of one tensor as [size * b, ...], in rank
  order (the global env order)."""
  if mesh.size == 1:
    return x
  parts = [torch.empty_like(x) for _ in range(mesh.size)]
  dist.all_gather(parts, x.contiguous())
  return torch.cat(parts)


def all_gather_objects(obj, mesh: Mesh) -> List[Any]:
  """Every rank's ``obj`` (picklable), in rank order."""
  if mesh.size == 1:
    return [obj]
  out = [None] * mesh.size
  dist.all_gather_object(out, obj)
  return out


def barrier(mesh: Optional[Mesh]):
  """Wait for every rank (nothing to wait for without a mesh)."""
  if mesh is not None and mesh.size > 1:
    dist.barrier()


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
  """True on every rank when ``flag`` is true on any: a decision all ranks
  take together (stopping, a reset flag)."""
  if mesh is None or mesh.size == 1:
    return bool(flag)
  t = torch.tensor([int(bool(flag))], device=mesh.device)
  dist.all_reduce(t, op=dist.ReduceOp.MAX)
  return bool(t.item())
