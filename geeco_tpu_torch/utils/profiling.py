"""Profiling and step-timing utilities (PyTorch).

Counterpart of ``geeco_tpu/utils/profiling.py``:
  * ``trace(log_dir)``: a context manager around ``torch.profiler`` that
    writes one Chrome-format trace (``chrome://tracing``, Perfetto) of the
    block into ``log_dir``, with the card's kernels and copies when a card
    is present;
  * ``StepTimer``: rolling wall-clock stats of a hot loop with JSONL export,
    carried across unchanged.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
  """Profile the block; on exit write ``log_dir/trace-<pid>-<ns>.json``.

  The trace holds the host's operators, and the device's activity when
  CUDA is available (the caller synchronises the card inside the block if
  its last kernels are to be in the file).  Yields the profiler."""
  from torch.profiler import ProfilerActivity, profile
  os.makedirs(log_dir, exist_ok=True)
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(os.path.join(
      log_dir, f'trace-{os.getpid()}-{time.time_ns()}.json'))


class StepTimer:
  """Rolling throughput stats for a hot loop."""

  def __init__(self, name: str = 'step', window: int = 50,
               jsonl_path: Optional[str] = None):
    self.name = name
    self.window = window
    self.times: List[float] = []
    self._t0: Optional[float] = None
    self._jsonl = open(jsonl_path, 'a') if jsonl_path else None
    self._count = 0

  def __enter__(self):
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *a):
    dt = time.perf_counter() - self._t0
    self.times.append(dt)
    self._count += 1
    if len(self.times) > self.window:
      self.times.pop(0)
    if self._jsonl:
      self._jsonl.write(json.dumps(
          {'name': self.name, 'n': self._count, 'dt': dt}) + '\n')

  def stats(self) -> Dict[str, float]:
    if not self.times:
      return {}
    ts = sorted(self.times)
    return {
        'mean_s': sum(ts) / len(ts),
        'p50_s': ts[len(ts) // 2],
        'p95_s': ts[int(len(ts) * 0.95)],
        'rate_hz': len(ts) / max(sum(ts), 1e-12),
    }

  def report(self) -> str:
    s = self.stats()
    if not s:
      return f'{self.name}: no samples'
    return (f'{self.name}: {s["mean_s"] * 1e3:.1f} ms mean, '
            f'{s["p95_s"] * 1e3:.1f} ms p95, {s["rate_hz"]:.1f} Hz')

  def close(self):
    if self._jsonl:
      self._jsonl.close()
