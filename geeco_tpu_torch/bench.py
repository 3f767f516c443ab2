"""Benchmark of the port: batched env stepping + rendering on one card.

  python -m geeco_tpu_torch.bench [--device cpu]

The port of the JAX package's ``bench.py`` (the repo root), with its knobs,
defaults and output.  Prints ONE JSON line on stdout:

  {"metric": ..., "value": N, "unit": "env_steps/sec/chip",
   "vs_baseline": N, "train_steps_per_sec": N}

``value`` is control-rate env steps per second (20 physics substeps of 2 ms
and one 256x256 RGB render each) of ``GeecoEnv('pad2-cube2')``: a batched
``reset_random``, then ``step`` + ``render`` over the env axis, the best
batch size of the sweep.  ``vs_baseline`` is the fraction of BASELINE.json's
north-star goal of 1e6 env-steps/s (a target, not a measurement).
``train_steps_per_sec`` is the episode trainer (``models/train.py``) at the
bench point: B=8 state-only episodes of T=99 steps, re-rendered at 256x256
through ``env.render_from_qpos``.  ``truncated`` marks a run cut short by
SIGTERM or the BENCH_BUDGET_S alarm, which prints the best result so far
and exits 0 (124 when nothing was measured).  Lines before it go to stderr
and start with ``#``: the card's name and power limit, the rate at each B,
the raster kernel's launches and the render paths of the timed steps, the
train rate and its launches per step, and each half's peak device memory.

Environment knobs, as in the JAX file: BENCH_NUM_ENVS (one B), BENCH_SWEEP
(comma list, default 256), BENCH_STEPS (timed control steps, default 10),
BENCH_SOLVER_ITERS, BENCH_SOLVER_METHOD, BENCH_SELECT_K,
BENCH_COLLIDE_EVERY (default 2), BENCH_SUBSTEP_UNROLL, BENCH_MASS_INVERSE,
BENCH_SOLVER_UNROLL, BENCH_RK (binning caps 'coarse,mid', default 192,96;
'' for the renderer's own), BENCH_SCAN=1, BENCH_TRAIN (0 skips the train
half), BENCH_TRAIN_B, BENCH_TRAIN_T, BENCH_BUDGET_S (default 1500).
``GeecoEnv``'s production settings are ``BENCH_COLLIDE_EVERY=1
BENCH_RK=512,192``.

Where it differs from the JAX file:
  * No failure is swallowed: a batch size or a train half that raises ends
    the run with that exception and no JSON line.
  * Timed regions end in ``torch.cuda.synchronize()``, not in a forced host
    readback: a CUDA stream has no dispatch cache to defeat.  The actions
    still differ every step, so the work per step is the JAX file's.
  * BENCH_SCAN=1 makes the JAX file run its timed steps as one lax.scan,
    with no host dispatch between them.  A Python loop has nothing to fuse,
    so here it runs the plain loop and sums each frame, as the scan body
    does, and the metric says so: the number is not the JAX scan's.
  * On the card the raster kernel must run once per timed control step and
    ceil(B*T/100) + 1 times per train step; the run fails otherwise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

NORTH_STAR = 1_000_000.0
TIMING = 'synchronize timing'
RENDER_CHUNK = 100      # frames a render of the trainer (its default)
SCAN_NOTE = ' + a sum of the frame (BENCH_SCAN=1: the plain loop, no scan)'


def env_kwargs(environ: Mapping[str, str]):
  """The env's kwargs, the batch sizes, the timed steps and the config note
  from BENCH_* variables: (kwargs, sweep, n_iters, config_note)."""
  n_iters = int(environ.get('BENCH_STEPS', '10'))
  if 'BENCH_NUM_ENVS' in environ:
    sweep = [int(environ['BENCH_NUM_ENVS'])]
  else:
    sweep = [int(b) for b in environ.get('BENCH_SWEEP', '256').split(',')]
  # the JAX package's round-5 defaults: contacts reused for 2 substeps,
  # binning caps 192/96 (its replay and binning fidelity gates)
  kw = {'collide_every': 2}
  for var, key, cast in (
      ('BENCH_SOLVER_ITERS', 'solver_iterations', int),
      ('BENCH_SOLVER_METHOD', 'solver_method', str),
      ('BENCH_SELECT_K', 'contact_select_k', int),
      ('BENCH_COLLIDE_EVERY', 'collide_every', int),
      ('BENCH_SUBSTEP_UNROLL', 'substep_unroll', int),
      ('BENCH_MASS_INVERSE', 'mass_inverse', str),
      ('BENCH_SOLVER_UNROLL', 'solver_unroll', int)):
    if var in environ:
      kw[key] = cast(environ[var])
  rk = environ.get('BENCH_RK', '192,96')
  if rk:
    k1, k2 = (int(v) for v in rk.split(','))
    kw['renderer_kwargs'] = {'coarse_k': k1, 'mid_k': k2}
  note = (f"ce={kw['collide_every']}"
          + (f' binning {rk.replace(",", "/")}' if rk else '')
          + ', fidelity-gated')
  return {'shapes': 'pad2-cube2', 'settle_steps': 2, **kw}, sweep, n_iters, \
      note


class Results:
  """What has been measured so far, readable from a signal handler."""

  def __init__(self, config_note: str):
    self.rates: Dict[int, float] = {}      # B -> env-steps/s
    self.train_steps: Optional[float] = None
    self.config_note = config_note
    self.step_note = '20 substeps + 256x256 render'   # set from the env
    self.emitted = False

  def line(self, note: str = '') -> str:
    """The result JSON line from the best batch size."""
    best_b = max(self.rates, key=self.rates.get)
    rate = self.rates[best_b]
    out = {
        'metric': (f'pad2-cube2 env steps/sec/chip (B={best_b} of '
                   f'{sorted(self.rates)}; {self.step_note} per step; '
                   f'{self.config_note}; {TIMING}{note})'),
        'value': round(rate, 2),
        'unit': 'env_steps/sec/chip',
        'vs_baseline': round(rate / NORTH_STAR, 6),
    }
    if note:
      out['truncated'] = True
    if self.train_steps is not None:
      out['train_steps_per_sec'] = round(self.train_steps, 3)
    return json.dumps(out)

  def emit(self, note: str = '') -> bool:
    """Print the line once; False when nothing was measured."""
    if self.emitted or not self.rates:
      return self.emitted
    self.emitted = True
    print(self.line(note), flush=True)
    return True


def log(msg: str):
  print(f'# {msg}', file=sys.stderr, flush=True)


def train_launches(B: int, T: int) -> int:
  """Raster-kernel launches of one train step at the default options: the
  B*T episode frames in renders of RENDER_CHUNK (the last one padded), then
  one of the B goal frames."""
  return math.ceil(B * T / RENDER_CHUNK) + 1


def _sync(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _reset_peak(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.reset_peak_memory_stats(device)


def _peak(device: torch.device) -> str:
  if device.type != 'cuda':
    return 'not measured (cpu)'
  return f'{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB'


def bench_env(env, num_envs: int, n_iters: int, scan: bool = False) -> float:
  """env-steps/s of control steps of step + render at B=num_envs."""
  from .render import raster_kernel as rk
  dev = env.device
  _reset_peak(dev)
  # a CPU generator: the same resets on the card and on the CPU
  es = env.reset_random(num_envs, torch.Generator().manual_seed(0))
  base = torch.tensor([0.1, 0.0, 0.2, 1.0], device=dev).expand(num_envs, 4)
  n_iters = max(2, n_iters)
  # distinct actions every step, staged on the device before the timing
  deltas = [0.01 * torch.sin(0.7 * i + torch.arange(4, device=dev))
            for i in range(n_iters)]

  def steps(es, deltas):
    sums = []
    for d in deltas:
      es = env.step(es, base + d)
      rgb, _ = env.render(es)
      if scan:     # every pixel feeds a result, as in the JAX scan body
        sums.append(rgb.float().sum())
    return es

  es = steps(es, deltas[:2])                   # two warm-up steps
  _sync(dev)
  paths0 = dict(env.renderer.path_counts)
  launches0 = rk.raster_tiles.launches
  t0 = time.perf_counter()
  steps(es, deltas)
  _sync(dev)
  dt = time.perf_counter() - t0
  launches = rk.raster_tiles.launches - launches0
  paths = {k: v - paths0.get(k, 0) for k, v in
           env.renderer.path_counts.items() if v != paths0.get(k, 0)}
  log(f'B={num_envs}: raster kernel launches {launches} in {n_iters} timed '
      f'control steps; render paths {json.dumps(paths)}; peak device memory '
      f'{_peak(dev)}')
  if dev.type == 'cuda' and launches != n_iters:
    raise RuntimeError(f'the raster kernel ran {launches} times in '
                       f'{n_iters} control steps, not once a step')
  return num_envs * n_iters / dt


def bench_config(overrides: Optional[dict] = None):
  """The trainer's config at the bench point (bench.py:190-196)."""
  from .models.params import create_e2evmc_config
  return create_e2evmc_config({
      'control_mode': 'cartesian', 'proc_obs': 'dynimg',
      'proc_tgt': 'dyndiff', 'img_channels': 3, 'window_size': 4,
      'batch_size': 32, 'lr': 2e-4, 'lambda_aux': 1.0,
      'loss_weighting': 'cmd_mag', 'start_boost': 6.0,
      'start_boost_windows': 13, **(overrides or {})})


def train_batch(env, B: int, T: int, device, config=None
                ) -> Dict[str, torch.Tensor]:
  """The bench's state-only episode batch on ``device``: B episodes of T
  steps around the env's settled state, drawn from RandomState(0) in the
  JAX file's order (bench.py:205-231), so both packages train on the same
  numbers.  Index arrays are int64."""
  from .data.dataset import window_indices
  from .utils.device import to_device
  config = config or bench_config()
  K, J = config.window_size, config.dim_jnt_state
  phys = env.setup()
  q0 = phys.qpos[0].cpu().numpy()
  widx = window_indices(T, K, pad_start=True).astype(np.int32)
  N = widx.shape[0]
  rng = np.random.RandomState(0)
  qpos = (q0[None, None, :] + 0.01 * rng.randn(B, T, q0.shape[0])).astype(
      np.float32)
  mocap = np.concatenate([phys.mocap_pos[0, 0].cpu().numpy(),
                          phys.mocap_quat[0, 0].cpu().numpy()]).astype(
                              np.float32)
  mocap = np.broadcast_to(mocap, (B, T, 7)).copy()
  rgba0 = np.asarray(env.rgba0, np.float32)
  batch = {
      'widx': widx, 'valid': np.ones((N,), bool),
      'jnt_state': rng.randn(B, T, J).astype(np.float32),
      'cmd': rng.uniform(-1, 1, (B, N, 4)).astype(np.float32),
      'vel_target': rng.randn(B, N, J).astype(np.float32),
      'ee_target': rng.randn(B, N, 7).astype(np.float32),
      'grp_target': rng.rand(B, N, 2).astype(np.float32),
      'pos_ee': rng.randn(B, N, 3).astype(np.float32),
      'pos_obj': rng.randn(B, N, 3).astype(np.float32),
      'step': np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy(),
      'qpos': qpos, 'mocap': mocap,
      'rgba': np.broadcast_to(rgba0, (B,) + rgba0.shape).copy(),
      'tgt_qpos': qpos[:, -1], 'tgt_mocap': mocap[:, -1],
      'aug_shift': rng.randint(-10, 11, (B, 2)).astype(np.int32),
  }
  return to_device(batch, device)


def bench_train(env, B: int, T: int, n_iters: int = 5, config=None) -> float:
  """Train steps/s of the episode trainer at the bench point."""
  from .models.train import make_episode_train_fns
  from .render import raster_kernel as rk
  dev = env.device
  config = config or bench_config()
  init_fn, train_step, _, _ = make_episode_train_fns(
      config, True, chunk_windows=8, render_fn=env.render_from_qpos,
      aug_pad=10, render_chunk=RENDER_CHUNK, device=dev)
  ts = init_fn(torch.Generator().manual_seed(0), config.batch_size)
  batch = train_batch(env, B, T, dev, config)
  _reset_peak(dev)
  for _ in range(2):                           # warm-up
    ts, m = train_step(ts, batch)
  _sync(dev)
  launches0 = rk.raster_tiles.launches
  t0 = time.perf_counter()
  for _ in range(n_iters):
    ts, m = train_step(ts, batch)
  _sync(dev)
  dt = time.perf_counter() - t0
  launches = rk.raster_tiles.launches - launches0
  per_step = launches / n_iters
  want = train_launches(B, T)
  log(f'train: raster kernel launches {launches} in {n_iters} timed train '
      f'steps ({per_step:g} a step, B={B}, T={T}); peak device memory '
      f'{_peak(dev)}')
  if dev.type == 'cuda' and per_step != want:
    raise RuntimeError(f'the raster kernel ran {per_step:g} times a train '
                       f'step, not ceil({B}*{T}/{RENDER_CHUNK}) + 1 = {want}')
  if not bool(torch.isfinite(m['loss'])):
    raise RuntimeError('the train loss is not finite')
  return n_iters / dt


def run(results: Results, environ: Mapping[str, str], device, *,
        frame_res=(256, 256), env_overrides: Optional[dict] = None,
        train_config=None, train_iters: int = 5):
  """Both halves into ``results``.  ``frame_res``, ``env_overrides``,
  ``train_config`` and ``train_iters`` shrink the run for tests."""
  from .envs.base import GeecoEnv
  kwargs, sweep, n_iters, _ = env_kwargs(environ)
  env = GeecoEnv(**{**kwargs, 'frame_res': frame_res, 'device': device,
                    **(env_overrides or {})})
  env.setup()
  h, w = frame_res
  scan = environ.get('BENCH_SCAN', '0') == '1'
  results.step_note = (f'{env.n_substeps} substeps + {w}x{h} render'
                       + (SCAN_NOTE if scan else ''))
  for b in sweep:
    results.rates[b] = bench_env(env, b, n_iters, scan=scan)
    log(f'B={b}: {results.rates[b]:.2f} env-steps/s')
  if environ.get('BENCH_TRAIN', '1') == '1':
    results.train_steps = bench_train(
        env, int(environ.get('BENCH_TRAIN_B', '8')),
        int(environ.get('BENCH_TRAIN_T', '99')), train_iters, train_config)
    log(f'train: {results.train_steps:.3f} steps/s')


def main(argv=None, **sizes):
  """Run the bench and print its JSON line; ``sizes`` go to ``run``."""
  from .utils.device import card_name, resolve_device
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--device', default=None,
                  help='torch device (default: the card, cuda)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)
  environ = os.environ
  results = Results(env_kwargs(environ)[3])

  def on_signal(signum, frame):
    # a caller's timeout (SIGTERM) or the budget's alarm: report what we have
    if results.emit(note=f'; cut short by signal {signum}'):
      os._exit(0)
    os._exit(124)

  prev = {s: signal.signal(s, on_signal)
          for s in (signal.SIGTERM, signal.SIGALRM)}
  signal.alarm(int(environ.get('BENCH_BUDGET_S', '1500')))
  try:
    log(f'device: {card_name(device)}')
    run(results, environ, device, **sizes)
  finally:
    signal.alarm(0)
    for s, handler in prev.items():
      signal.signal(s, handler)
  results.emit()


if __name__ == '__main__':
  main()
