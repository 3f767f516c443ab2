"""The readings the limits of ``correct`` are set from (not run by the
benchmark's own runs).

  python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
      --seconds <s> [--control] [--fault <name>]

For each seed: the cell's set-up and a window of ``--seconds``, then the
numbers the run compares, read for the program; with ``--control``, also
for the control: the plain reference in the program's place, computed with
TF32 on (the configuration states float32 with TF32 off); with ``--fault``,
the program with that fault planted in its timed path (``kinds/*.py``'s
``FAULTS``).  One JSON line a seed on stdout.  The program's env is built
once and shared by the seeds of one process.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import run as R
from .kinds import common
from .trace import Spans


def main(argv=None, config_overrides=None, traffic_overrides=None):
  """Print the readings; returns them (the overrides shrink the cell, for
  the tests)."""
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seeds', required=True)
  ap.add_argument('--seconds', type=float, default=5.0)
  ap.add_argument('--control', action='store_true')
  ap.add_argument('--fault', default=None)
  ap.add_argument('--device', default='cuda')
  args = ap.parse_args(argv)
  _, config, traffic = R.load_cell(R.load_manifest(), args.workload)
  config = R._merge(config, config_overrides)
  traffic = R._merge(traffic, traffic_overrides)
  device = torch.device(args.device)
  import importlib
  kind = importlib.import_module(f'.kinds.{traffic["kind"]}', __package__)
  cache, lines = {}, []
  for seed in (int(s) for s in args.seeds.split(',')):
    t0 = time.perf_counter()
    cell = kind.build(config, traffic, seed, device, False, args.fault,
                      cache)
    cell.setup()
    steps, t1 = 0, time.perf_counter()
    while steps == 0 or time.perf_counter() - t1 < args.seconds:
      cell.step(Spans())
      steps += 1
    cell.release()
    out = {'seed': seed, 'steps': steps, 'fault': args.fault,
           'program': cell.readings()}
    if args.control:
      out['control'] = cell.readings(control=True)
    out['seconds'] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    lines.append(out)
    del cell
    common.free_device_memory()
  return lines


if __name__ == '__main__':
  main()
