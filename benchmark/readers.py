"""What the per-layer metrics share: each file under ``metrics/`` reads one
number from a traced run (``run.Traced``) through these, or returns None
when the run has nothing to read."""

from __future__ import annotations

from typing import Optional

from .counts import peaks

# the tile rasterizer's kernel, by the name the device trace gives it
K1_KERNEL = 'raster_tiles_kernel'


def span_ms(run, name: str) -> Optional[float]:
  """Milliseconds a step spent in the span ``name`` (summed over the
  step's spans of that name), over the traced window's timed steps."""
  if name not in run.spans or not run.timed_steps:
    return None
  return 1e3 * run.spans[name] / run.timed_steps


def k1_roofline(run) -> Optional[float]:
  """K1's share of its roofline in the profiled slice, in %: the count of
  its launches (``counts/k1.py``) at the card's peaks over the device time
  of its kernel."""
  if not run.k1 or run.k1['seconds'] <= 0:
    return None
  least = peaks.roofline_s(run.k1['ops'], run.k1['bytes'], 'float32')
  return 100.0 * least / run.k1['seconds']


def mfu(run) -> Optional[float]:
  """The step's counted operations, each part at its own peak (K1's at
  the float32 rate), over the traced window's time per step, in %."""
  if not run.step_s:
    return None
  least = peaks.seconds_at_peaks(run.cell.flops_by_dtype())
  if run.k1:
    least += run.k1['ops'] / run.profile.steps / peaks.FLOPS['float32']
  return 100.0 * least / run.step_s


def idle_share(run) -> Optional[float]:
  """The share of the profiled slice in which no operation ran on the
  device, in %."""
  if run.profile is None or run.profile.window_s <= 0:
    return None
  return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)


def launches_per_step(run) -> Optional[float]:
  """Kernel launches of the profiled slice per step."""
  if run.profile is None or not run.profile.steps:
    return None
  return run.profile.launches / run.profile.steps
