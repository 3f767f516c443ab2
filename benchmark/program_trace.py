"""The program's own spans and counters (``geeco_tpu_torch.utils.profiling``)
over a few steps of a traced run, for the per-layer metrics that read them.

``program(run)`` measures once per traced run, at the first reader that asks
(after the benchmark's profiled slice, before the program's state is
released), and keeps the result on the run.  It turns the program's tracer
on and runs ``profile_steps`` more steps of the cell, then takes the
tracer's snapshot.  It runs one more step under ``trace.profile`` with the
program's span names, which names each idle gap of the device by the
innermost program span open at it; those gaps and the idle seconds under
each innermost span go to stderr as ``# program gaps:``.  Last it turns the
tracer off and empties it.  On the CPU a span's stream time is its host
time.  Against a program without the tracer (no ``profiling.enable``) it
gives None, and so does every reader.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, Optional

from . import trace as T
from .kinds.common import log

# every span the program opens: the control step's, the renderer's and the
# trainer's
SPANS = ('env.step', 'physics.smooth', 'physics.collide',
         'physics.constraints', 'physics.solve', 'expert', 'render',
         'train.rerender', 'train.forward', 'train.backward', 'train.update')


def idle_by_span(prof: T.Profile) -> Dict[str, float]:
  """Idle seconds of the device in the profiled step, each charged to the
  innermost program span open on the host at that time ('outside any
  span' where none is)."""
  ann = [a for a in prof.annotations if a[0] in SPANS]
  bounds = sorted({0.0, prof.window_s} | {a for _, a, _ in ann} |
                  {b for _, _, b in ann})
  owner = []
  for lo, hi in zip(bounds, bounds[1:]):
    open_ = [(a, name) for name, a, b in ann if a <= lo and hi <= b]
    owner.append(max(open_)[1] if open_ else 'outside any span')
  idle: Dict[str, float] = defaultdict(float)
  for s, e in T.idle_gaps([(s, e) for _, s, e in prof.device], 0.0,
                          prof.window_s):
    i = max(0, bisect.bisect_right(bounds, s) - 1)
    while i < len(owner) and bounds[i] < e:
      idle[owner[i]] += max(0.0, min(e, bounds[i + 1]) - max(s, bounds[i]))
      i += 1
  return dict(idle)


def _measure(run) -> Optional[Dict]:
  from geeco_tpu_torch.utils import profiling
  if not hasattr(profiling, 'enable'):
    return None
  cell = run.cell
  n = int(cell.traffic['profile_steps'])

  def one_step():
    cell.step(T.Spans())
    return 1

  profiling.reset()
  profiling.enable()
  try:
    T._sync(cell.device)
    t0 = time.perf_counter()
    for _ in range(n):
      cell.step(T.Spans())
    T._sync(cell.device)
    step_s = (time.perf_counter() - t0) / n
    snap = profiling.snapshot()
    prof = T.profile(one_step, SPANS, cell.device)
  finally:
    profiling.disable()
    profiling.reset()
  idle = idle_by_span(prof)
  log(f'program trace: {n} step(s) with the tracer on, {step_s:.4f} s a '
      f'step (the traced window: {run.step_s:.4f} s a step)')
  log('program gaps: ' + ', '.join(f'{name} {secs:.6f} s'
                                   for name, secs in prof.top_gaps()) +
      '; idle by span: ' + ', '.join(
          f'{name} {secs:.6f} s'
          for name, secs in sorted(idle.items(), key=lambda kv: -kv[1])))
  return {'steps': n, 'snapshot': snap}


def program(run) -> Optional[Dict]:
  """The program's trace of the run (measured at the first call)."""
  if not hasattr(run, 'program_trace'):
    run.program_trace = _measure(run)
  return run.program_trace


def span_ms(run, name: str, clock: str) -> Optional[float]:
  """Milliseconds a step in the program's span ``name``, on the ``clock``
  'host' (its host time) or 'stream' (between its two events on the
  stream)."""
  p = program(run)
  if p is None or name not in p['snapshot']['spans']:
    return None
  return 1e3 * p['snapshot']['spans'][name][clock + '_s'] / p['steps']


def count_per_step(run, name: str) -> Optional[float]:
  """The program's counter ``name`` a step, over every span and outside."""
  p = program(run)
  if p is None or name not in p['snapshot']['counters']:
    return None
  return p['snapshot']['counters'][name] / p['steps']


def ratio_pct(run, num: str, den: str) -> Optional[float]:
  """The counter ``num`` as a share of the counter ``den``, in %."""
  a, b = count_per_step(run, num), count_per_step(run, den)
  if a is None or not b:
    return None
  return 100.0 * a / b
