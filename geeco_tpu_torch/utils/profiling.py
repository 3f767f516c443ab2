"""The port's tracer: named spans and counters inside the program.

Counterpart of ``geeco_tpu/utils/profiling.py``'s ``trace``, extended into
one tracer for the hot paths:

  * ``span(name)``: a context manager around one layer's work.  Off (the
    default), it checks one module-level flag and returns a shared no-op
    context: nothing is allocated, launched, synchronized or recorded.
    On, it opens a ``torch.profiler.record_function`` range (so that under
    any ``torch.profiler`` session the span lies on the trace beside the
    device's kernels), takes the host clock at entry and exit, records a
    pair of CUDA events on the current stream (its time on the device's
    clock, read at ``snapshot``, with no synchronize), and takes the
    counters bumped inside it.  Its parent is the innermost open span.
  * ``count(name, n)``: a host counter, charged to the innermost open span
    (also from another thread: autograd's device threads run a backward
    pass for the span that called it).
    ``count_device(name, tensor)``: a tally kept on the device and read
    once at ``snapshot``.  Off, both return at the flag; callers guard the
    work that makes the tensor with ``if profiling.on():``.
  * ``syncs``: while the tracer is on, on the card, every synchronisation
    that ``torch.cuda.set_sync_debug_mode`` reports (a ``.item()``, a copy
    to the host, a solver's check of its result) is counted against the
    innermost open span instead of being printed.
  * ``enable``, ``disable``, ``reset``, ``snapshot``: the aggregates by span
    name (calls, host time, host self time, stream time, counters) as plain
    dicts, kept in memory.
  * ``trace(log_dir)``: the operator's exporter: turns the tracer on for its
    block and writes one Chrome-format trace of it (``chrome://tracing``,
    Perfetto) into ``log_dir``, the program's spans over the card's kernels
    and copies.

The tracer is process-wide: one flag, one table and one stack of open
spans, so spans are opened by one thread at a time.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import torch

_on = False
_NOOP = contextlib.nullcontext()
# the message torch.cuda.set_sync_debug_mode('warn') gives each sync
SYNC_MESSAGE = 'called a synchronizing CUDA operation'
# pending span events drained without a wait once this many are queued
_DRAIN_AT = 4096


class _Stat:
  __slots__ = ('calls', 'host_ns', 'self_ns', 'stream_ms', 'parents',
               'counters')

  def __init__(self):
    self.calls = 0
    self.host_ns = 0
    self.self_ns = 0
    self.stream_ms: Optional[float] = None   # None: no event recorded
    self.parents: Dict[str, int] = defaultdict(int)
    self.counters: Dict[str, float] = defaultdict(float)


_stats: Dict[str, _Stat] = {}
_outside: Dict[str, float] = defaultdict(float)   # counters of no span
_tallies: Dict[tuple, torch.Tensor] = {}          # (span, counter) -> sum
_pending: List[tuple] = []                         # (name, start, end)
_pool: List = []                                   # free CUDA events
_stack: List['_Span'] = []                         # the open spans
_syncs: Optional[dict] = None                      # what enable() replaced
_events = False                                    # spans record events


def on() -> bool:
  """Whether the tracer is on."""
  return _on


def _stat(name: str) -> _Stat:
  s = _stats.get(name)
  if s is None:
    s = _stats[name] = _Stat()
  return s


def _event():
  return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class _Span:
  __slots__ = ('name', 'rf', 'start', 'events', 'children_ns')

  def __init__(self, name: str):
    self.name = name

  def __enter__(self):
    self.rf = torch.profiler.record_function(self.name)
    self.rf.__enter__()
    self.children_ns = 0
    self.events = None
    if _events:
      self.events = (_event(), _event())
      self.events[0].record()
    _stack.append(self)
    self.start = time.perf_counter_ns()
    return self

  def __exit__(self, *exc):
    dur = time.perf_counter_ns() - self.start
    if self.events is not None:
      self.events[1].record()
      _pending.append((self.name,) + self.events)
    _stack.pop()
    s = _stat(self.name)
    s.calls += 1
    s.host_ns += dur
    s.self_ns += dur - self.children_ns
    if _stack:
      _stack[-1].children_ns += dur
      s.parents[_stack[-1].name] += 1
    else:
      s.parents[''] += 1
    self.rf.__exit__(*exc)
    if len(_pending) >= _DRAIN_AT:
      _drain(wait=False)
    return False


def span(name: str):
  """A context manager around one layer's work (see the module's
  docstring); the shared no-op context while the tracer is off."""
  if not _on:
    return _NOOP
  return _Span(name)


def _charge(name: str, n) -> None:
  if _stack:
    _stat(_stack[-1].name).counters[name] += n
  else:
    _outside[name] += n


def count(name: str, n=1) -> None:
  """Add ``n`` to the host counter ``name``, charged to the innermost open
  span."""
  if not _on:
    return
  _charge(name, n)


def count_device(name: str, tensor: torch.Tensor) -> None:
  """Add the scalar ``tensor`` to the device tally ``name`` of the
  innermost open span, with no synchronize; read at ``snapshot``."""
  if not _on:
    return
  key = (_stack[-1].name if _stack else '', name)
  t = tensor.detach().reshape(())
  acc = _tallies.get(key)
  if acc is None:
    _tallies[key] = t.clone()
  else:
    acc.add_(t)


def _drain(wait: bool) -> None:
  """Read the stream time of the spans whose end event the device has
  reached (all of them, after a synchronize, with ``wait``)."""
  global _pending
  if not _pending:
    return
  if wait:
    torch.cuda.synchronize()
  left = []
  for name, e0, e1 in _pending:
    if wait or e1.query():
      s = _stat(name)
      s.stream_ms = (s.stream_ms or 0.0) + e0.elapsed_time(e1)
      _pool.extend((e0, e1))
    else:
      left.append((name, e0, e1))
  _pending = left


def _show_warning(message, category, filename, lineno, file=None,
                  line=None):
  if str(message).startswith(SYNC_MESSAGE):
    _charge('syncs', 1)
    return
  _syncs['showwarning'](message, category, filename, lineno, file, line)


def _count_syncs_on() -> None:
  global _syncs
  ctx = warnings.catch_warnings()
  ctx.__enter__()
  warnings.filterwarnings('always', message=SYNC_MESSAGE)
  _syncs = {'ctx': ctx, 'showwarning': warnings.showwarning, 'mode': None}
  warnings.showwarning = _show_warning
  if torch.cuda.is_available():
    _syncs['mode'] = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('warn')


def _count_syncs_off() -> None:
  global _syncs
  if _syncs is None:
    return
  if _syncs['mode'] is not None:
    torch.cuda.set_sync_debug_mode(_syncs['mode'])
  _syncs['ctx'].__exit__(None, None, None)
  _syncs = None


def enable(syncs: Optional[bool] = None) -> None:
  """Turn the tracer on (a no-op when it is on).  ``syncs``: count the
  synchronisations torch reports; by default on the card only (the CPU
  has none to count)."""
  global _on, _events
  if _on:
    return
  _events = torch.cuda.is_available()
  if _events if syncs is None else syncs:
    _count_syncs_on()
  _on = True


def disable() -> None:
  """Turn the tracer off; what it gathered stays until ``reset``."""
  global _on
  _on = False
  _count_syncs_off()


def reset() -> None:
  """Forget every span, counter and tally gathered so far."""
  global _pending
  for _, e0, e1 in _pending:
    _pool.extend((e0, e1))
  _pending = []
  _stats.clear()
  _outside.clear()
  _tallies.clear()


def snapshot() -> Dict:
  """What the tracer gathered, as plain dicts (synchronizes the card once
  when spans recorded events on it):

    {'spans': {name: {'calls', 'host_s', 'self_s', 'stream_s',
                      'parents': {parent name ('' at the top): calls},
                      'counters': {name: value}}},
     'counters': {name: total over the spans and outside any}}

  ``stream_s`` is the time between the span's two events on the stream
  that was current at its entry; without a card, the host time."""
  with warnings.catch_warnings():      # the reads' own syncs are not counted
    warnings.filterwarnings('ignore', message=SYNC_MESSAGE)
    _drain(wait=True)
    keys = list(_tallies)
    values = torch.stack([_tallies[k].double() for k in keys]).tolist() \
        if keys else []
  for (where, name), value in zip(keys, values):
    if where:
      _stat(where).counters[name] += value
    else:
      _outside[name] += value
  _tallies.clear()
  spans, totals = {}, defaultdict(float, _outside)
  totals.setdefault('syncs', 0)       # none counted: the CPU has none
  for name, s in _stats.items():
    spans[name] = {
        'calls': s.calls, 'host_s': s.host_ns / 1e9,
        'self_s': s.self_ns / 1e9,
        'stream_s': s.host_ns / 1e9 if s.stream_ms is None
        else s.stream_ms / 1e3,
        'parents': dict(s.parents), 'counters': dict(s.counters)}
    for k, v in s.counters.items():
      totals[k] += v
  return {'spans': spans, 'counters': dict(totals)}


@contextlib.contextmanager
def trace(log_dir: str):
  """Profile the block with the tracer on; on exit write
  ``log_dir/trace-<pid>-<ns>.json``.

  The trace holds the host's operators and the program's spans, and the
  device's activity when CUDA is available (the caller synchronises the
  card inside the block if its last kernels are to be in the file).  The
  tracer keeps what it gathered (``snapshot``).  Yields the profiler."""
  from torch.profiler import ProfilerActivity, profile
  os.makedirs(log_dir, exist_ok=True)
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  was_on = _on
  enable()
  try:
    with profile(activities=activities) as prof:
      yield prof
  finally:
    if not was_on:
      disable()
  prof.export_chrome_trace(os.path.join(
      log_dir, f'trace-{os.getpid()}-{time.time_ns()}.json'))
