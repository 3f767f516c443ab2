"""Spans, the profiled slice and what is read from its trace.

Spans come from the benchmark's own files, around the calls into each
layer.  In a traced run's timed steps a span is bounded by two
synchronizes and its host time is summed by name (``Spans('timed')``); in
the profiled slice it is a ``torch.profiler.record_function`` range with no
synchronize (``Spans('annotate')``), so that the device runs as it does
unprofiled and the trace can name what the host was doing in each gap.
An untraced run takes ``Spans('off')``: no span costs anything.

The profile is read from the profiler's raw records: building its event
objects (``prof.events()``) takes a control step's ~125k records tens of
seconds.  The device time is the union of the device records' intervals
(kernels, copies, sets), so that nothing is counted twice.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

TOP = 10      # entries of each list of the breakdown


def _sync(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


class Spans:
  """Named spans around calls into the program's layers."""

  def __init__(self, mode: str = 'off',
               device: torch.device = torch.device('cpu')):
    if mode not in ('off', 'timed', 'annotate'):
      raise ValueError(f'unknown span mode {mode!r}')
    self.mode = mode
    self.device = device
    self.seconds: Dict[str, float] = defaultdict(float)

  @contextlib.contextmanager
  def __call__(self, name: str):
    if self.mode == 'off':
      yield
      return
    if self.mode == 'annotate':
      with torch.profiler.record_function(name):
        yield
      return
    _sync(self.device)
    t0 = time.perf_counter()
    try:
      yield
    finally:
      _sync(self.device)
      self.seconds[name] += time.perf_counter() - t0


def _hidden_record(e) -> bool:
  """A raw record the profiler's own event list leaves out (memory
  records, hidden events), by the test it applies."""
  from torch.autograd.profiler_util import _filter_name
  return (_filter_name(e.name()) or
          getattr(e, 'is_hidden_event', lambda: False)())


def _annotation(e, names) -> bool:
  """A user annotation (a ``record_function`` range), by the profiler's
  own flag where it has one, else by the benchmark's span names."""
  flag = getattr(e, 'is_user_annotation', None)
  return (flag is not None and flag()) or e.name() in names


def union_s(spans: List[Tuple[float, float]]) -> float:
  """The time the union of [(start, end)] intervals covers."""
  total, reach = 0.0, float('-inf')
  for start, end in sorted(spans):
    total += max(0.0, end - max(start, reach))
    reach = max(reach, end)
  return total


def idle_gaps(spans: List[Tuple[float, float]], start: float, end: float
              ) -> List[Tuple[float, float]]:
  """The intervals of [start, end] that no span covers."""
  gaps, reach = [], start
  for s, e in sorted(spans):
    if s > reach:
      gaps.append((reach, min(s, end)))
    reach = max(reach, e)
  if reach < end:
    gaps.append((reach, end))
  return [(s, e) for s, e in gaps if e > s]


class Profile:
  """What the profiled slice's trace says, in seconds from the slice's
  start: kernel launches, device intervals by name, the benchmark's span
  ranges, and the slice's length."""

  def __init__(self, launches: int, device: List[Tuple[str, float, float]],
               annotations: List[Tuple[str, float, float]], window_s: float,
               steps: int):
    self.launches = launches
    self.device = device
    self.annotations = annotations
    self.window_s = window_s
    self.steps = steps

  @property
  def busy_s(self) -> float:
    return union_s([(s, e) for _, s, e in self.device])

  def kernel_seconds(self, match: Callable[[str], bool]) -> float:
    """Device seconds of the records whose name ``match`` accepts."""
    return union_s([(s, e) for n, s, e in self.device if match(n)])

  def top_ops(self, n: int = TOP) -> List[list]:
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in self.device:
      by_name[name] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name, secs] for name, secs in top]

  def top_gaps(self, n: int = TOP) -> List[list]:
    """The longest idle gaps of the device, each named by the innermost
    benchmark span open at its middle ('outside any span' where none
    is)."""
    gaps = idle_gaps([(s, e) for _, s, e in self.device], 0.0,
                     self.window_s)
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
      mid = 0.5 * (s + e)
      open_ = [(a, name) for name, a, b in self.annotations if a <= mid <= b]
      name = max(open_)[1] if open_ else 'outside any span'
      out.append([name, e - s])
    return out


def profile(fn: Callable[[], int], span_names, device: torch.device
            ) -> Profile:
  """Run ``fn`` (which returns the steps it ran) under torch.profiler and
  read its raw records."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile as torch_profile
  _sync(device)
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    with torch.profiler.record_function('profiled slice'):
      steps = fn()
      _sync(device)
  results = prof.profiler.kineto_results
  records = [e for e in results.events() if not _hidden_record(e)]
  slice_ = [e for e in records if e.name() == 'profiled slice']
  if slice_:
    start_ns, end_ns = slice_[0].start_ns(), slice_[0].end_ns()
  else:     # no range recorded: the slice spans every record
    start_ns = min(e.start_ns() for e in records)
    end_ns = max(e.end_ns() for e in records)
  names = set(span_names) | {'profiled slice'}
  launches, dev, ann = 0, [], []
  for e in records:
    s, t = (e.start_ns() - start_ns) / 1e9, (e.end_ns() - start_ns) / 1e9
    if e.device_type() == DeviceType.CUDA:
      # a range of record_function (the benchmark's spans, the optimizer's)
      # is drawn on the device's timeline too: it is no device operation
      if not _annotation(e, names):
        dev.append((e.name(), s, t))
    elif e.name().startswith(('cudaLaunchKernel', 'cuLaunchKernel')):
      launches += 1
    elif e.name() in names:
      ann.append((e.name(), s, t))
  return Profile(launches, dev, ann, (end_ns - start_ns) / 1e9, steps)


@contextlib.contextmanager
def capture_k1(captured: Optional[list]):
  """Within: every launch of the program's tile rasterizer
  (``raster_kernel.raster_tiles``) appends its (coeffs, tile) to
  ``captured``; the function is restored after.  ``captured`` None: no
  capture."""
  if captured is None:
    yield
    return
  from geeco_tpu_torch.render import raster_kernel
  original = raster_kernel.raster_tiles

  def capturing(coeffs, tile, sky_packed):
    captured.append((coeffs, tile))
    return original(coeffs, tile, sky_packed)

  # the wrapped function counts its launches on the module's name
  capturing.launches = original.launches
  raster_kernel.raster_tiles = capturing
  try:
    yield
  finally:
    original.launches = capturing.launches
    raster_kernel.raster_tiles = original
