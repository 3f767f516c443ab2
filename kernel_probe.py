#!/usr/bin/env python3
"""The port's two CUDA kernels timed alone on the card.

  python3 kernel_probe.py [--psd-phases | --raster-phases]

What the benchmark's cells cannot show: each kernel's own device time,
against its plain PyTorch twin's and against the least time the card
could take.  The checks that the kernels are right are the card tests
(``tests/test_torch_card_kernels.py``); this script only times.

  K1, the tile rasterizer: the planes pad2-cube2's reset frames bin at
      B=64 at tile 16 (production), random planes of the same shapes, and
      the frame planes at tiles 8, 32 (256 px) and 10 (320 px).  Bound:
      ``benchmark/counts/k1.py`` ``launch_work``, the count that the
      benchmark's ``k1_roofline`` metrics divide by.
  K2, the fused PSD solve: the operands of a substep 5 control steps into
      the expert's episode on the fused-solve env at B=64, in the plan's
      cluster and in 1, 2 and 4 blocks an env, at B=64 and at B=1 (env
      0's); then clutter4's and nut-cone's at rolling=False.  In the
      'psd' form (``solver.solve``'s own iteration with the eager loop's
      summation orders, 6 row groups), the production env's: a substep 5
      control steps into the expert's episode at B=64 and B=256, one block
      an env.  Bound: each operand read once, the forces written once,
      and the operations of 60 iterations (``psd_work``).

Both kernels run in well under a Python launch's host time, so each is
timed queued behind a spin kernel (``cuda_ms(queued=True)``).  Bounds are
at the H100 SXM's published peaks (3.35 TB/s, 67 TFLOP/s float32 outside
the tensor cores, at 700 W); the card's name and power limit are printed
first.  The last line is a JSON object of every timing.

--psd-phases builds ``csrc/psd_solve.cu`` once more with -DPSD_PROFILE and
prints the cycles thread 0 spends in each phase of an iteration of the
TPU kernel's form, per cluster size.
--raster-phases builds ``csrc/raster_tiles.cu`` once more with
-DRASTER_PROFILE and prints, per tile side, how K1's warps share the SMs.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, 'tests'))

from benchmark.counts.k1 import launch_work  # noqa: E402
from geeco_tpu_torch.envs.base import make_env  # noqa: E402
from geeco_tpu_torch.expert import policies as EP  # noqa: E402
from geeco_tpu_torch.physics import solver_pallas as SP  # noqa: E402
from geeco_tpu_torch.render import raster_kernel as rk  # noqa: E402
from geeco_tpu_torch.render import rasterizer as R  # noqa: E402
from geeco_tpu_torch.utils import build  # noqa: E402
from geeco_tpu_torch.utils.device import card_name  # noqa: E402
from test_torch_card_kernels import (ENVS, SKY, build_kernels,  # noqa: E402
                                     capture_solve, launches_of_k1,
                                     option_renderer, production_env,
                                     random_planes, random_psd_operands)
from test_torch_card_psd_rolling import production_operands  # noqa: E402

HBM_RATE = 3.35e12      # bytes/s
FP32_RATE = 67e12       # float32 operations/s outside the tensor cores
# K1's tiles timed besides production's 16: (tile, frame side)
OTHER_TILES = ((8, 256), (32, 256), (10, 320))
K2_SCENES = ('pad2-cube2-clutter4', 'nut-cone')
# the batches the 'psd' form is timed at: the closed loop's and collect's
PSD_BATCHES = (64, 256)


def cuda_ms(fn, repeats: int, queued: bool = False) -> float:
  """Milliseconds of one fn() on the device (CUDA events), after one
  warm-up run: the median of `repeats` runs timed one by one, or, `queued`,
  the mean of `repeats` runs enqueued back to back behind a spin kernel of
  ~50 ms.  A launch through a Python wrapper costs the host ~0.1 ms; timed
  one by one, a kernel shorter than that reads as the host's time, since
  the device waits for the launch with the clock running.  Behind the spin
  the host runs ahead and the device never waits."""
  fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  if queued:
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(repeats):
      fn()
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    if host >= 0.04:
      raise RuntimeError(f'{repeats} launches took the host {host:.3f} s, '
                         'longer than the spin kernel they were to queue '
                         'behind')
    return start.elapsed_time(end) / repeats
  times = []
  for _ in range(repeats):
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def bound(ops: float, nbytes: float):
  """The least time the card could take: (ms, 'bytes' or 'operations')."""
  t_bytes, t_ops = nbytes / HBM_RATE, ops / FP32_RATE
  return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                     else 'operations')


def psd_work(ops):
  """(operations, bytes) of one fused PSD solve: each operand read once
  and the forces written once; per iteration two operator applications
  (u, w, z, the rows: w = A_IEᵀ v, or in the 'psd' form w = J_E u), g, d,
  the two dot products, the update and the projection (two more groups
  with the rolling rows)."""
  B, nI, nv = ops['J'].shape
  nE, K, nlim = ops['A_IE'].shape[2], ops['K'], ops['nlim']
  nbytes = 4 * (sum(t.numel() for t in ops.values()
                    if isinstance(t, torch.Tensor)) + B * nI)
  w = 2 * nE * nv if 'J_E' in ops else 2 * nE * nI
  op = 4 * nv * nI + 2 * nE * nI + w + 2 * nE * nE + 3 * nI
  per_iter = 2 * op + 8 * nI + (26 if 'mu_roll' in ops else 18) * K + \
      4 * nlim
  return float(B) * ops['iterations'] * per_iter, nbytes


def time_k1(coeffs, tile, label):
  """K1's time and its twin's on ``coeffs``, against launch_work's bound;
  the kernel under its bound means the count is at fault."""
  ms = cuda_ms(lambda: rk.raster_tiles(coeffs, tile, SKY), 30, queued=True)
  plain_ms = cuda_ms(lambda: rk.raster_tiles_reference(coeffs, tile, SKY), 3)
  ops, nbytes = launch_work(coeffs, tile)
  b_ms, by = bound(ops, nbytes)
  print(f'[k1] {label}: coeffs {tuple(coeffs.shape)}, plan '
        f'{rk.subtile_plan(tile)}: kernel {ms:.4f} ms, twin {plain_ms:.4f} '
        f'ms; bound {b_ms:.4f} ms by {by} ({ops:.4g} operations, '
        f'{nbytes:.4g} bytes), {b_ms / ms:.3f} of it', flush=True)
  if ms < b_ms:
    raise RuntimeError(f'K1 at {label}: {ms} ms under its bound {b_ms} ms')
  return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
              shape=list(coeffs.shape))


def time_k2(ops, label, clusters=()):
  """K2's time in the plan's cluster (and in each of ``clusters``) and its
  twin's on ``ops``, against psd_work's bound."""
  B, nI, nv = ops['J'].shape
  if 'orders' in ops:
    lay = SP._exact_layout(nI, nv, ops['A_IE'].shape[2], ops['K'],
                           ops['nlim'], ops['orders']['gu'],
                           ops['orders']['rw'])
  else:
    lay = SP.plan(B, nI, nv, ops['A_IE'].shape[2], ops['K'])
  ms = cuda_ms(lambda: SP.psd_solve(**ops), 30, queued=True)
  per_c = {C: cuda_ms(lambda: SP.psd_solve(**ops, cluster=C), 30,
                      queued=True) for C in clusters}
  twin = {k: v for k, v in ops.items() if k != 'orders'}
  plain_ms = cuda_ms(lambda: SP.psd_solve_reference(**twin), 3)
  b_ms, by = bound(*psd_work(ops))
  print(f'[k2] {label}: B={ops["J"].shape[0]}, nI={ops["J"].shape[1]}, '
        f'nv={ops["J"].shape[2]}, nE={ops["A_IE"].shape[2]}, K={ops["K"]}; '
        f'plan cluster {lay["cluster"]}: kernel {ms:.4f} ms; per cluster '
        f'size {per_c}; twin {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {by}',
        flush=True)
  if ms < b_ms:
    raise RuntimeError(f'K2 at {label}: {ms} ms under its bound {b_ms} ms')
  return dict(ms=ms, per_cluster=per_c, cluster=lay['cluster'],
              plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)


def frame_coeffs(env, es, am, tile, res):
  """The coefficients of K1's launch for one render of the reset frames
  at ``tile`` and ``res`` px a side."""
  r = option_renderer(env, am, tile=tile, width=res, height=res)
  with launches_of_k1() as seen:
    r.render(env.kin(es), es.rgba)
  return seen[0][0]


def probe(card):
  out = {'card': card_name(card), 'k1': {}, 'k2': {}}
  build_kernels()
  env, es, am = production_env(card)
  out['k1']['frames, tile 16'] = time_k1(
      frame_coeffs(env, es, am, 16, 256), 16, 'frames, tile 16')
  gen = torch.Generator(device=card).manual_seed(0)
  rnd = R._coeff_planes(random_planes(ENVS, 256, 192, 16, gen), 16, 2)
  out['k1']['random, tile 16'] = time_k1(rnd, 16, 'random, tile 16')
  for tile, res in OTHER_TILES:
    label = f'frames, tile {tile} at {res} px'
    out['k1'][label] = time_k1(frame_coeffs(env, es, am, tile, res), tile,
                               label)
  del env, es, rnd

  k2env = make_env('pad2-cube2', device=card, rolling=False,
                   solver_method='pallas')
  es = k2env.reset_random(ENVS, torch.Generator(device=card).manual_seed(2))
  es, _ = EP.rollout(k2env, es, EP.make_expert(k2env), length=5)
  ops = capture_solve(k2env, es.phys)
  ops1 = {k: v[:1].contiguous() if isinstance(v, torch.Tensor) else v
          for k, v in ops.items()}
  out['k2'][f'pad2-cube2 B={ENVS}'] = time_k2(ops, f'pad2-cube2 B={ENVS}',
                                               (1, 2, 4))
  out['k2']['pad2-cube2 B=1'] = time_k2(ops1, 'pad2-cube2 B=1', (1, 2, 4))
  del k2env, es, ops, ops1
  for shapes in K2_SCENES:
    env = make_env(shapes, device=card, rolling=False,
                   solver_method='pallas', settle_steps=2)
    es = env.reset_random(ENVS, torch.Generator(device=card).manual_seed(4))
    es = env.step(es, torch.zeros(ENVS, 4, device=card))
    out['k2'][shapes] = time_k2(capture_solve(env, es.phys), shapes)
    del env, es
  env = make_env('pad2-cube2', device=card)
  env.setup()
  for B in PSD_BATCHES:
    es = env.reset_random(B, torch.Generator(device=card).manual_seed(2))
    es, _ = EP.rollout(env, es, EP.make_expert(env), length=5)
    label = f"pad2-cube2 'psd' form B={B}"
    out['k2'][label] = time_k2(production_operands(env, es.phys), label)
    del es
  print(json.dumps(out))


def psd_phases(card):
  """The cycles thread 0 of block 0 spends in each phase of one iteration
  of K2, per cluster size, at pad2-cube2's shapes (B=64, random operands),
  from a build with -DPSD_PROFILE (the kernel writes its counts instead of
  the forces)."""
  gen = torch.Generator(device=card).manual_seed(0)
  ops = random_psd_operands(ENVS, 128, 9, 39, 6, gen)
  names = ['u,w of f', 'barrier', 'rows g,d', 'barrier', 'u,w of d',
           'barrier', 'rows Ad, dots', 'barrier', 'alpha, project, barrier',
           'loop head']
  order = ('J', 'X', 'A_IE', 'EEinv', 'R', 'b', 'precond', 'f0', 'mu_t',
           'mu_tor', 'con_act', 'lim_act')
  specs = [SP.build_spec(ENVS, 530, 39, 6, 128, 9, C) for C in (1, 2, 4)]
  libs = [build.psd_library(s, ('PSD_PROFILE=1',)) for s in specs]
  build.build_all(libs)
  for spec, (so, _) in zip(specs, libs):
    lib = ctypes.CDLL(so)
    lib.psd_solve_f32.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.psd_solve_f32.restype = ctypes.c_int
    res = torch.zeros((ENVS, 530), device=card)
    for _ in range(2):
      err = lib.psd_solve_f32(
          *(ctypes.c_void_p(ops[k].data_ptr()) for k in order), None, None,
          ctypes.c_void_p(res.data_ptr()), ENVS, ops['iterations'],
          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
      if err:
        raise RuntimeError(f'the profile launch failed: {err}')
      torch.cuda.synchronize()
    cyc = (res[0, :len(names)] / ops['iterations']).tolist()
    print(f'[k2:phases] {spec}, cycles per iteration, thread 0 of block 0, '
          f'B={ENVS}: ' + ', '.join(f'{n} {c:.0f}' for n, c in
                                    zip(names, cyc)) +
          f'; sum {sum(cyc):.0f}', flush=True)


def raster_phases(card):
  """K1's time and how its warps share the SMs on the reset frames at
  tiles 8, 16, 32 (256 px) and 10 (320 px), from a build with
  -DRASTER_PROFILE, whose lane 0 of every warp records its SM and its start
  and end on the SM's clock.  Per SM: its span (first start to last end),
  the warps resident over it and its tail (the cycles after its last warp
  started); per warp: its life, beside the slots its band keeps
  (``raster_kernel.live_slots``)."""
  so, args = build.raster_library(('RASTER_PROFILE=1',))
  build.build_all([build.raster_library(), (so, args)])
  for line in build.last_build_log.splitlines():
    if line.startswith('$'):
      line = ' '.join(a for a in line.split()
                      if a.startswith('-D') or a.endswith('.cu'))
    if '.cu' in line or 'registers' in line or 'spill' in line:
      print(f'[k1:phases] {line.strip()}', flush=True)
  lib = ctypes.CDLL(so)
  vp, ci = ctypes.c_void_p, ctypes.c_int
  lib.raster_tiles_f32.argtypes = [vp, vp, vp] + [ci] * 6 + [
      ctypes.c_float, vp]
  lib.raster_tiles_f32.restype = ci
  lib.raster_profile_read.argtypes = [vp, ci]
  lib.raster_profile_read.restype = ci
  env, es, am = production_env(card)
  for tile, res in ((8, 256), (16, 256), (32, 256), (10, 320)):
    coeffs = frame_coeffs(env, es, am, tile, res)
    iz_r, c_r = rk.raster_tiles_reference(coeffs, tile, SKY)
    time_k1(coeffs, tile, f'phases, tile {tile} at {res} px')
    plan = rk.subtile_plan(tile)
    B, n_tiles, _, K = coeffs.shape
    warps = B * n_tiles * plan[2]
    iz = torch.full_like(iz_r, float('nan'))
    c = torch.full_like(c_r, float('nan'))
    for _ in range(2):
      err = lib.raster_tiles_f32(
          ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_void_p(iz.data_ptr()),
          ctypes.c_void_p(c.data_ptr()), B * n_tiles, K, tile, *plan,
          ctypes.c_float(SKY),
          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
      if err:
        raise RuntimeError(f'the profile launch failed: {err}')
      torch.cuda.synchronize()
    rec = np.zeros((warps, 3), dtype=np.uint32)
    if lib.raster_profile_read(rec.ctypes.data, warps):
      raise RuntimeError('raster_profile_read failed')
    if not (torch.equal(iz, iz_r) and torch.equal(c, c_r)):
      raise RuntimeError(f'the profile build differs from the twin at tile '
                         f'{tile}')
    sm, start, end = rec.astype(np.int64).T
    kept = rk.live_slots(coeffs, tile, plan).sum(-1).flatten().cpu().numpy()
    life = (end - start) % 2 ** 32
    spans, tails, resident = [], [], []
    for s in np.unique(sm):
      on = sm == s
      # the low 32 bits of the SM's clock, which may wrap once
      t0 = (start[on] - start[on][0] + 2 ** 31) % 2 ** 32 - 2 ** 31
      t0 -= t0.min()
      t1 = t0 + life[on]
      spans.append(t1.max())
      tails.append(t1.max() - t0.max())
      resident.append(life[on].sum() / t1.max())
    spans, tails, resident = map(np.asarray, (spans, tails, resident))
    heavy = kept >= np.percentile(kept, 99)
    pct = lambda a: (f'mean {a.mean():.0f}, p50 {np.median(a):.0f}, p99 '
                     f'{np.percentile(a, 99):.0f}, max {a.max():.0f}')
    print(f'[k1:phases] tile {tile} at {res}x{res}, plan {plan} (band w, h, '
          f'bands), {warps} warps on {len(spans)} SMs, B={B}, K={K}: SM span '
          f'(cycles) {pct(spans)}; warps resident over the span '
          f'{pct(resident)}; tail after the SM\'s last warp start '
          f'{pct(tails)} ({tails.sum() / spans.sum():.3f} of the spans); '
          f'warp life {pct(life)}; slots kept a warp {pct(kept)}; the 1% of '
          f'warps that keep most: life {life[heavy].mean():.0f}', flush=True)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  which = ap.add_mutually_exclusive_group()
  which.add_argument('--psd-phases', action='store_true',
                     help="only K2's cycles per phase of an iteration, per "
                     'cluster size (a build with phase counters)')
  which.add_argument('--raster-phases', action='store_true',
                     help="only K1's time on frame planes at tiles 8, 16, "
                     '32 and 10, and how its warps share the SMs there (a '
                     'build with per-warp records)')
  args = ap.parse_args()
  if not torch.cuda.is_available():
    sys.exit('kernel_probe.py needs a CUDA card')
  card = torch.device('cuda')
  print(f'[device] {card_name(card)} | torch {torch.__version__} cuda '
        f'{torch.version.cuda}', flush=True)
  if args.psd_phases:
    psd_phases(card)
  elif args.raster_phases:
    raster_phases(card)
  else:
    probe(card)


if __name__ == '__main__':
  main()
