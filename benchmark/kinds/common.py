"""What every kind of traffic shares: the cell's interface, the seeded
sample of a window's answers, and the comparison's record."""

from __future__ import annotations

import dataclasses
import random
import sys
from typing import Dict, List, Optional

import torch

from ..trace import Spans


def shared(cache, key, make):
  """``make()``, or, with a ``cache`` dict (cells of one process that share
  what they build, such as the envs), the object made for ``key`` before;
  a benchmark run passes None and shares nothing."""
  if cache is None:
    return make()
  if key not in cache:
    cache[key] = make()
  return cache[key]


class Cell:
  """One configuration under one traffic mix.

  ``setup()`` does all that comes before the window (build, load, warm-up);
  ``step(spans)`` runs one step of the window and returns the units of work
  it completed; ``release()`` frees the program's state once the window has
  closed; ``check()`` compares what the window produced with the plain
  reference and returns ``{name: (value, limit)}`` (``readings(control)``
  gives the numbers alone, of the program or of the control).
  ``rate_metric`` names the end-to-end metric that units per second give;
  ``span_names`` are the spans ``step`` opens; ``flops_by_dtype()`` gives
  the counted operations of one step by precision."""

  rate_metric: str = ''
  span_names: tuple = ()

  def setup(self):
    raise NotImplementedError

  def step(self, spans: Spans) -> int:
    raise NotImplementedError

  def release(self):
    pass

  def flops_by_dtype(self) -> Dict[str, float]:
    raise NotImplementedError

  def readings(self, control: bool = False) -> Dict[str, float]:
    raise NotImplementedError

  def check(self) -> Dict[str, tuple]:
    return with_limits(self.readings(), self.traffic['limits'])


class Reservoir:
  """A uniform sample of ``k`` of the items offered, drawn from ``seed``
  (Algorithm R): the decision to keep an item depends on the seed and its
  index alone, so the same seed keeps the same steps of equal windows."""

  def __init__(self, k: int, seed: int):
    self.k = k
    self.rng = random.Random(seed)
    self.items: List = []
    self.seen = 0

  def wants(self) -> Optional[int]:
    """The slot the next item goes to, or None when it is not kept; call
    once per item, then ``put`` the item when a slot was given."""
    i = self.seen
    self.seen += 1
    if i < self.k:
      return i
    j = self.rng.randrange(i + 1)
    return j if j < self.k else None

  def put(self, slot: int, item):
    if slot < len(self.items):
      self.items[slot] = item
    else:
      self.items.append(item)


def with_limits(values: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, tuple]:
  """{name: (value, limit)} for every limit the traffic file states."""
  missing = set(limits) - set(values)
  if missing:
    raise KeyError(f'no reading for the limits {sorted(missing)}')
  return {name: (float(values[name]), float(limits[name]))
          for name in limits}


def log(msg: str):
  print(f'# {msg}', file=sys.stderr, flush=True)


def convert(obj, cls):
  """A dataclass or NamedTuple of the program rebuilt as the reference's
  ``cls``, field by field (the tensors are shared, not copied); nested
  dataclasses are converted by the caller."""
  if dataclasses.is_dataclass(obj):
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
  else:
    fields = obj._asdict()
  return cls(**fields)


def set_tf32(on: bool):
  torch.backends.cuda.matmul.allow_tf32 = on
  torch.backends.cudnn.allow_tf32 = on


def free_device_memory():
  import gc
  gc.collect()
  if torch.cuda.is_available():
    torch.cuda.empty_cache()
