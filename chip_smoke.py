#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (geeco_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py [--profile OUT.txt]

Drives the port's main path at production settings: GeecoEnv('pad2-cube2')
on the card (256x256 frames, 20 substeps of 2 ms, 60 PSD iterations,
top-128 contacts, rolling rows, binning caps 512/192, shadows), then
reset_random and control steps of env.step + env.render.  Phases, in order;
any failure exits non-zero:

  1. a CUDA device is required; print its name and power limit
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and time the build
  3. the raster kernel against its plain PyTorch twin, on random planes at
     the production shapes and on planes binned from real frames
  4. the slice: reset_random, then control steps of step + render, with
     sanity checks and the count of raster-kernel launches; env-steps/s
  5. fidelity: replay the recorded MuJoCo pick episode
     (tests/fixtures/mujoco_pickplace_pad2cube2.npz) through reset_to + step
     and require task success with the task object within 30 mm

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, 'tests', 'fixtures',
                       'mujoco_pickplace_pad2cube2.npz')
# kernel vs twin: both evaluate (a*px + b*py) + c with rounded ops and no
# FMA, so they must agree exactly; allow at most 1 pixel in 10^4 to differ
MISMATCH_TOL = 1e-4
IZ_ATOL = 1e-6          # inverse-depth agreement on matching pixels
CPU_FRAME_TOL = 5e-3    # CUDA vs CPU full frame: edge pixels only
ENVS = 64               # batch of the slice
STEPS = 5               # control steps of step + render


def fail(msg: str):
  print(f'FAIL: {msg}', flush=True)
  sys.exit(1)


def check(cond: bool, msg: str):
  if not cond:
    fail(msg)


def cuda_ms(fn, repeats: int) -> float:
  """Median milliseconds of fn() over `repeats` timed runs (CUDA events),
  after one warm-up run."""
  fn()
  times = []
  for _ in range(repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def compare_raster(coeffs, tile, sky, rk, label):
  """Kernel vs twin on the same coefficients; returns (max_abs_err, ms,
  plain_ms)."""
  iz_k, c_k = rk.raster_tiles(coeffs, tile, sky)
  iz_r, c_r = rk.raster_tiles_reference(coeffs, tile, sky)
  torch.cuda.synchronize()
  mism = (c_k != c_r) | ((iz_k - iz_r).abs() > IZ_ATOL)
  n_mism = int(mism.sum())
  frac = n_mism / mism.numel()
  err = max(float((iz_k - iz_r).abs().max()), float((c_k - c_r).abs().max()))
  print(f'[raster:{label}] coeffs {tuple(coeffs.shape)}: {n_mism} of '
        f'{mism.numel()} pixels differ (tolerance {MISMATCH_TOL:g}), '
        f'max_abs_err {err}', flush=True)
  check(frac <= MISMATCH_TOL, f'raster kernel disagrees with its twin on '
        f'{label} planes ({n_mism} pixels)')
  check(bool(torch.isfinite(iz_k).all()) and bool(torch.isfinite(c_k).all()),
        'raster kernel output is not finite')
  ms = cuda_ms(lambda: rk.raster_tiles(coeffs, tile, sky), 20)
  plain_ms = cuda_ms(lambda: rk.raster_tiles_reference(coeffs, tile, sky), 3)
  print(f'[raster:{label}] kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms '
        '(CUDA events, median)', flush=True)
  return err, ms, plain_ms


def random_planes(B, n_tiles, K, tile, gen):
  """Random vertex planes [B, n_tiles, K] as _bin_hierarchical emits them."""
  dev = gen.device
  MTS = 2 * tile
  u = lambda lo, hi: lo + (hi - lo) * torch.rand(
      (B, n_tiles, K), generator=gen, device=dev)
  x0, y0, x1, y1, x2, y2 = (u(-6.0, MTS + 6.0) for _ in range(6))
  iz0, iz1, iz2 = (1.0 / u(0.5, 5.0) for _ in range(3))
  ok = (u(0.0, 1.0) > 0.25).float()
  colp = torch.floor(u(0.0, 256.0 ** 3 - 1))
  return [x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp]


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--profile', default='',
                  help='write a torch.profiler table of one control step')
  args = ap.parse_args()

  # ---- 1. the card
  if not torch.cuda.is_available():
    fail('torch.cuda.is_available() is false: this smoke test needs a GPU')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
      f'nvidia-smi failed: {smi.stderr.strip()}'
  print(f'[device] {torch.cuda.get_device_name(0)} | {card} | torch '
        f'{torch.__version__} cuda {torch.version.cuda}', flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  from geeco_tpu_torch.envs.base import ResetSpec, make_env
  from geeco_tpu_torch.render import raster_kernel as rk
  from geeco_tpu_torch.render import rasterizer as R
  from geeco_tpu_torch.utils import build

  # ---- 2. build
  t0 = time.perf_counter()
  build.load_kernels()
  print(f'[build] kernels ready in {time.perf_counter() - t0:.2f} s '
        f'(nvcc {build.last_build_seconds:.2f} s) -> '
        f'{os.path.relpath(build.library_path(), ROOT)}', flush=True)

  # ---- 3a. raster kernel vs twin on random planes at production shapes
  dev = torch.device('cuda')
  gen = torch.Generator(device=dev).manual_seed(0)
  TS, K, n_tiles = 16, 192, 256
  sky = R._pack_sky((0.45, 0.86, 0.57))
  coeffs = R._coeff_planes(random_planes(ENVS, n_tiles, K, TS, gen),
                           TS, 2)
  err_rand, _, _ = compare_raster(coeffs, TS, sky, rk, 'random')

  # ---- 4. the slice
  t0 = time.perf_counter()
  env = make_env('pad2-cube2', device='cuda')
  env.setup()
  torch.cuda.synchronize()
  print(f'[slice] env built + setup settle in {time.perf_counter() - t0:.1f}'
        ' s', flush=True)
  t0 = time.perf_counter()
  es = env.reset_random(ENVS, torch.Generator(device=dev).manual_seed(1))
  torch.cuda.synchronize()
  print(f'[slice] reset_random(B={ENVS}) in '
        f'{time.perf_counter() - t0:.1f} s', flush=True)

  # ---- 3b. raster kernel vs twin on planes binned from these frames
  kin = env.kin(es)
  tp = R._project_and_shade(env.renderer, kin, es.rgba)
  coeffs = R._coeff_planes(R._bin_hierarchical(env.renderer, tp), TS, 2)
  err_real, ms, plain_ms = compare_raster(coeffs, TS, sky, rk, 'frame')

  base = torch.tensor([0.1, 0.0, 0.2, 1.0], device=dev).expand(ENVS, 4)
  rk.raster_tiles.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  renders = 0
  for i in range(STEPS):
    delta = 0.01 * torch.sin(0.7 * i + torch.arange(4, device=dev))
    es = env.step(es, base + delta)
    rgb, depth = env.render(es)
    renders += 1
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = rk.raster_tiles.launches
  rate = ENVS * STEPS / dt
  print(f'[slice] {STEPS} control steps (step + render) at '
        f'B={ENVS}: {dt:.3f} s -> {rate:.2f} env-steps/s on {card}',
        flush=True)
  qpos = es.phys.qpos
  check(bool(torch.isfinite(qpos).all()), 'non-finite qpos')
  zs = torch.stack([qpos[:, env.model.jnt_qposadr[env.model.joint(j)] + 2]
                    for j in ('object0:joint', 'object1:joint')], -1)
  print(f'[slice] cube heights: min {float(zs.min()):.4f} max '
        f'{float(zs.max()):.4f}', flush=True)
  check(bool(((zs >= 0.28) & (zs <= 0.32)).all()),
        'cubes are not resting on the table')
  check(rgb.shape == (ENVS, 256, 256, 3) and rgb.dtype == torch.uint8,
        f'rgb {tuple(rgb.shape)} {rgb.dtype}')
  check(bool(torch.isfinite(depth).all()), 'non-finite depth')
  flat = rgb.reshape(ENVS, -1, 3).float()
  check(bool((flat.std(dim=1).mean(-1) > 10).all()), 'a frame is constant')
  print(f'[slice] raster kernel launches: {launches} for {renders} renders',
        flush=True)
  check(launches == renders, 'the raster kernel did not run once per render')

  # env 0's state rendered by the CPU path (the plain twin)
  cpu_env = make_env('pad2-cube2', device='cpu')
  kin = env.kin(es)
  kin0 = kin.replace(**{f.name: getattr(kin, f.name)[:1].cpu()
                        for f in dataclasses.fields(kin)})
  rgb_cpu, _ = cpu_env.renderer.render(kin0, es.rgba[:1].cpu())
  diff = float((rgb_cpu[0] != rgb[0].cpu()).any(-1).float().mean())
  print(f'[slice] frame 0, CUDA vs CPU path: {diff:.5f} of pixels differ '
        f'(tolerance {CPU_FRAME_TOL:g})', flush=True)
  check(diff <= CPU_FRAME_TOL, 'CUDA frame disagrees with the CPU path')

  if args.profile:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      es = env.step(es, base)
      env.render(es)
      torch.cuda.synchronize()
    with open(args.profile, 'w') as f:
      f.write(f'# one control step + render, B={ENVS}, {card}\n')
      f.write(prof.key_averages().table(sort_by='cuda_time_total',
                                        row_limit=40))
      f.write('\n' + prof.key_averages().table(sort_by='cpu_time_total',
                                               row_limit=25))
    print(f'[profile] written to {args.profile}', flush=True)

  # ---- 5. fidelity: the recorded MuJoCo pick episode
  fx = np.load(FIXTURE)
  obj = fx['init_obj_qpos'].copy()
  obj[:, 2] -= 0.025   # reset_to re-adds the table-height adjust
  spec = ResetSpec(obj_qpos=torch.as_tensor(obj)[None],
                   mocap_qpos=torch.as_tensor(fx['init_mocap_qpos'])[None],
                   task_goal=torch.tensor([0]), task_object=torch.tensor([0]))
  t0 = time.perf_counter()
  es = env.reset_to(spec)
  adrs = [env.model.jnt_qposadr[env.model.joint(str(j))]
          for j in fx['obj_joint_names']]
  trace = []
  for cmd in fx['cmds']:
    es = env.step(es, torch.as_tensor(cmd)[None])
    trace.append(torch.stack([es.phys.qpos[0, a:a + 3] for a in adrs]))
  trace = torch.stack(trace).cpu().numpy()
  m = {k: float(v[0]) for k, v in env.eval_metrics(es).items()}
  drift = np.linalg.norm(trace - fx['obj_pos_trace'], axis=-1).max(axis=0)
  print(f'[fidelity] {len(fx["cmds"])} replayed steps in '
        f'{time.perf_counter() - t0:.1f} s: task_success '
        f'{m["task_success"]}, goal_dist {m["goal_dist"]:.4f} (MuJoCo '
        f'{float(fx["final_goal_dist"]):.4f}), task-object drift '
        f'{drift[0] * 1000:.2f} mm', flush=True)
  check(bool(np.isfinite(trace).all()), 'non-finite replay trace')
  check(m['task_success'] == 1.0, 'the replayed pick did not succeed')
  check(drift[0] < 0.03, f'task-object drift {drift[0]:.4f} m >= 0.03 m')

  kernels = [{
      'name': 'raster_tiles', 'route': 'cuda',
      'source': 'geeco_tpu_torch/csrc/raster_tiles.cu',
      'replaces': 'geeco_tpu/render/rasterizer.py:778',
      'launches': launches, 'max_abs_err': max(err_rand, err_real),
      'ms': ms, 'plain_ms': plain_ms,
  }]
  print(json.dumps({'kernels': kernels}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
