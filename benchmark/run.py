"""Run one cell of the benchmark once.

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``,
whose ``kind`` names ``kinds/<kind>.py``).  The run builds and warms
up the cell from the seed (set-up), runs its steps for ``--seconds``
(the window: whole steps, ended by a synchronize), and once the window has
closed reads the peak device memory, frees the program's state and
compares what the window produced with the plain reference
(``benchmark/ref``).  ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` runs the window with a synchronized span around each layer's
calls, then one more step and ``profile_steps`` profiled ones, and reports
the cell's per-layer metrics (``metrics/<name>.py``) with the device's busy
time.

The last line on stdout is one JSON object: ``correct``, ``attempted``
(units of work the window completed), ``failed`` (numbers over their
limit), ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit, which also end
stderr.  The run fails, printing no result, without a card, when the card
count is under the cell's ``chips``, or when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'geeco_tpu')


def _process_age() -> float:
  """Seconds since this process started (from /proc), or since this module
  was loaded where /proc does not say."""
  try:
    with open('/proc/self/stat') as f:
      fields = f.read().rsplit(')', 1)[1].split()
    started = int(fields[19]) / os.sysconf('SC_CLK_TCK')
    with open('/proc/uptime') as f:
      uptime = float(f.read().split()[0])
    return uptime - started
  except (OSError, ValueError, IndexError):
    return time.perf_counter() - _START


_AGE0, _PC0 = _process_age(), time.perf_counter()


def since_start() -> float:
  return _AGE0 + time.perf_counter() - _PC0


def log(msg: str):
  print(f'# {msg}', file=sys.stderr, flush=True)


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
  out = dict(base)
  for k, v in (over or {}).items():
    out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
        out.get(k), dict) else v
  return out


def load_manifest() -> Dict:
  with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    return json.load(f)


def load_cell(manifest: Dict, workload: str):
  """(cell entry, configuration, traffic) of ``workload``."""
  cells = {w['name']: w for w in manifest['workloads']}
  if workload not in cells:
    raise SystemExit(f'unknown workload {workload!r}; BENCHMARK.json has '
                     f'{sorted(cells)}')
  cell = cells[workload]
  conf = {c['name']: c for c in manifest['configs']}[cell['config']]
  with open(os.path.join(ROOT, conf['file'])) as f:
    config = json.load(f)
  with open(os.path.join(HERE, 'traffic', cell['traffic'] + '.json')) as f:
    traffic = json.load(f)
  return cell, config, traffic


def metrics_of(manifest: Dict, kind: str, workload: str):
  """The ``kind`` ('end_to_end' or 'per_layer') metrics that ``workload``
  reports: those without ``workloads`` and those that list it."""
  return [m for m in manifest[kind]
          if workload in m.get('workloads', [workload])]


def read_metric(name: str, traced) -> Optional[float]:
  """The per-layer metric ``name`` by its reader ``metrics/<name>.py``."""
  path = os.path.join(HERE, 'metrics', name + '.py')
  spec = importlib.util.spec_from_file_location(
      'benchmark.metrics.' + name.replace('.', '_'), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read(traced)


def loaded_forbidden():
  return sorted({m.split('.')[0] for m in list(sys.modules)} &
                set(FORBIDDEN))


def power_limit() -> Optional[str]:
  try:
    smi = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
  except (OSError, subprocess.TimeoutExpired):
    return None
  return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and \
      smi.stdout.strip() else None


class Traced:
  """What a traced run hands the per-layer readers: the cell, the span
  seconds of the timed steps, the time per step, the profiled slice and
  K1's count over it."""

  def __init__(self, cell, spans, timed_steps, step_s, profile, k1):
    self.cell, self.spans, self.timed_steps = cell, spans, timed_steps
    self.step_s, self.profile, self.k1 = step_s, profile, k1


def _k1_work(captured, profile):
  from .counts import k1
  from .readers import K1_KERNEL
  if not captured:
    return None
  ops = nbytes = 0.0
  for coeffs, tile in captured:
    o, b = k1.launch_work(coeffs, tile)
    ops, nbytes = ops + o, nbytes + b
  return {'ops': ops, 'bytes': nbytes, 'launches': len(captured),
          'seconds': profile.kernel_seconds(lambda n: K1_KERNEL in n)}


def main(argv=None, device=None, config_overrides: Optional[Dict] = None,
         traffic_overrides: Optional[Dict] = None,
         fault: Optional[str] = None) -> Dict:
  """Run the cell; returns the result it printed.  ``device`` (tests
  only) skips the look for a card and runs there; the overrides shrink the
  cell and ``fault`` breaks its timed path, for the tests that check the
  comparison."""
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seed', type=int, required=True)
  ap.add_argument('--seconds', type=float, required=True)
  ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)

  manifest = load_manifest()
  entry, config, traffic = load_cell(manifest, args.workload)
  config = _merge(config, config_overrides)
  traffic = _merge(traffic, traffic_overrides)

  # every cache at a fixed path inside the checkout (the program builds its
  # CUDA kernels into build/kernels/ there by itself)
  for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = os.path.join(ROOT, 'build', sub)
  import torch
  from . import trace as T
  if device is None:
    if not torch.cuda.is_available():
      raise SystemExit('no CUDA device: the benchmark runs on the card only')
    if torch.cuda.device_count() < entry['chips']:
      raise SystemExit(f'{args.workload} needs {entry["chips"]} card(s); '
                       f'{torch.cuda.device_count()} found')
    device = torch.device('cuda', 0)
  device = torch.device(device)
  on_card = device.type == 'cuda'

  kind = importlib.import_module(f'.kinds.{traffic["kind"]}', __package__)
  cell = kind.build(config, traffic, args.seed, device, bool(args.trace),
                    fault)
  cell.setup()
  T._sync(device)
  setup_s = since_start()
  log(f'set-up {setup_s:.3f} s')

  # ------------------------------------------------------------ window
  spans = T.Spans('timed' if args.trace else 'off', device)
  steps = units = 0
  t0 = time.perf_counter()
  while steps == 0 or time.perf_counter() - t0 < args.seconds:
    units += cell.step(spans)
    steps += 1
  T._sync(device)
  window_s = time.perf_counter() - t0
  log(f'window: {steps} steps, {units} units in {window_s:.3f} s')

  traced = None
  if args.trace:
    captured = []
    n_prof = int(traffic['profile_steps'])

    def profiled():
      annotate = T.Spans('annotate', device)
      with T.capture_k1(captured):
        for _ in range(n_prof):
          cell.step(annotate)
      return n_prof

    # one capturing step first, its captures dropped: the allocator then
    # holds the blocks that the profiled step's captures keep, so keeping
    # them adds no device allocation to the slice
    with T.capture_k1([]):
      cell.step(T.Spans())
    prof = T.profile(profiled, cell.span_names, device)
    k1 = _k1_work(captured, prof)
    del captured
    traced = Traced(cell, dict(spans.seconds), steps, window_s / steps,
                    prof, k1)

  found = loaded_forbidden()
  if found:
    raise SystemExit(f'loaded once the window closed: {", ".join(found)}')
  peak = torch.cuda.max_memory_allocated(device) if on_card else 0

  metrics = {}
  if args.trace:
    for m in metrics_of(manifest, 'per_layer', args.workload):
      value = read_metric(m['name'], traced)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
  else:
    for m in metrics_of(manifest, 'end_to_end', args.workload):
      if m['name'] == 'setup_s':
        value = setup_s
      elif m['name'] == cell.rate_metric:
        value = units / window_s
      else:
        continue
      metrics[m['name']] = {'value': value, 'unit': m['unit']}

  cell.release()
  checks = cell.check()
  failed = [n for n, (v, lim) in checks.items() if not v <= lim]
  found = loaded_forbidden()
  if found:
    raise SystemExit(f'loaded by the run: {", ".join(found)}')

  dev = {'platform': 'gpu' if on_card else device.type,
         'kind': torch.cuda.get_device_name(device) if on_card else 'cpu',
         'count': 1 if on_card else 0,
         'memory_peak_bytes': peak}
  if on_card:
    dev['power_limit'] = power_limit()
  result = {'correct': not failed, 'attempted': units, 'failed': len(failed),
            'metrics': metrics, 'device': dev}
  if traced is not None:
    dev['busy_s'] = traced.profile.busy_s
    dev['window_s'] = traced.profile.window_s
    result['breakdown'] = {'device_ops': traced.profile.top_ops(),
                           'idle_gaps': traced.profile.top_gaps()}
  result['checks'] = {n: {'value': v, 'limit': lim}
                      for n, (v, lim) in checks.items()}
  for n, (v, lim) in checks.items():
    print(f'check {n}: {v!r} (limit {lim!r})'
          + ('' if v <= lim else ' OVER'), file=sys.stderr, flush=True)
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
