#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (geeco_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py [--profile OUT.txt] [--psd-phases] [--raster-phases]
                        [--replay-only slice1|slice2|nutcone|clutter4]
                        [--cli-only frames|chain] [--scenes-only]
                        [--bench-only]

Drives the port's two paths at production settings on the card:

  slice 1: GeecoEnv('pad2-cube2') (256x256 frames, 20 substeps of 2 ms, 60
           PSD iterations, top-128 contacts, rolling rows, binning caps
           512/192, shadows): reset_random and control steps of env.step +
           env.render;
  slice 2: GeecoEnv('pad2-cube2', rolling=False, solver_method='pallas'),
           whose solve is the fused PSD kernel: the scripted pick-and-place
           expert's 100-step state-only episodes (expert.policies.rollout);
  slice 3: the goal-conditioned E2E-VMC model at its production width
           (dynimg/dyndiff, 256x256, bf16 convolutions, 7.56 M parameters):
           the episode trainer on B=8 state-only episodes of T=99 steps,
           re-rendered through slice 1's env.render_from_qpos, and
           closed-loop evaluation of 64 envs on slice 1's env.
  slice 4: the command-line workflow (run/gym_pickplace.py collect and
           controller, run/dataset_tools.py, run/train_e2evmc.py, the
           predictor) on datasets it writes to build/cli_smoke/.
  slice 5: every other GEECO scene on its production env: the clutter
           scenes (the primitive pair kernels; psd with the top-K) and the
           mesh scenes (the convex-hull narrowphase; psd_block with quota
           selection), and slice 1's render with a background frame per
           env (VideoCycler over a GIF, the texture override).

Phases; any failure exits non-zero:

  1. a CUDA device is required; print its name and power limit
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and time the build
  3. the raster kernel against its plain PyTorch twin, on random planes at
     the production shapes (also with no slot valid, with every slot valid
     and with a slot count that is no multiple of 4), bit for bit on random
     planes at tile sides 1, 2, 6, 10, 18, 20, 24, 32 and 40 (B=3), and on
     planes binned from real frames; how many slots per tile those frames
     fill, and how many of them can touch the tile; the kernel's time on
     both, its bound counted at what the kernel's own cull reads and
     tests (raster_kernel.live_slots, loaded_chunks)
  4. the slice: reset_random, then control steps of step + render, with
     sanity checks and the count of raster-kernel launches; env-steps/s;
     one profiled control step (kernel launches, device time); env 0's
     frame against the CPU path's
  5. fidelity: replay the first 50 control steps of the recorded MuJoCo pick
     episode (tests/fixtures/mujoco_pickplace_pad2cube2.npz) through
     reset_to + step and require the task object within 30 mm
  6. the PSD kernel against its plain twin: on random operands at the real
     shapes (with and without weld rows) at B=64, 3 and 1 in clusters of 1,
     2 and 4 blocks per env, at a larger scene's shapes, and at shapes that
     stay in device memory; then at B=64 on the operands of
     a real substep 5 control steps into the expert episode, where the
     substep through the kernel is also held against the substep through
     the twin; on the first substep after reset_random, where the solve is
     unstable to float32 rounding, the kernel, the twin and the twin with
     its sums in other orders are each held against the float64 twin,
     env by env
  7. slice 2: the expert's 100-step episodes at B=64, with the count of
     PSD-kernel launches (one per substep: the episode replays the chains
     of CUDA graphs a shorter episode captured, so the wrapper launches
     nothing itself, and a control step's device trace holds one kernel a
     substep), env-steps/s and task success;
     the PSD kernel's time, also per cluster size at B=64 and B=1; one
     profiled control step
  8. fidelity of slice 2: the whole MuJoCo pick replay through the slice-2
     env at B=1, to task success with the task object within 30 mm
  9. the model: the flagship forward (n=4, 256x256, bf16) finite and held
     against the same weights' float32 forward on the card (no TF32); a
     small float32 train step on the card held against the same step on the
     CPU (loss, every gradient, the parameters after the step), and the same
     step with cuDNN's TF32 on as a control the comparison must reject
  10. the trainer at the bench point (bench.py's batch around slice 1's
     settled state, chunk_windows=8, aug_pad=10, renders of 100 frames):
     one warm-up step, whose raster-kernel launches (8 of 100 frames, one of
     the 8 goal frames) are each held against the twin on their own
     coefficients, then timed steps with the raster-kernel launches
     (ceil(B*T/100) + 1 per step), the loss (finite, falling on the fixed
     batch), train steps/s, peak device memory, one profiled step
     (launches, device time, idle share) and one profiled render of 100
     frames (the renders' share of the step)
  11. closed loop: evaluate_batched of the flagship (its heads perturbed, so
     that it acts) on 64 envs of slice 1 from the state phase 4 left, a few
     control steps: finite metrics, one raster launch per step plus one for
     the goal frames, env-steps/s
  12. slice 4, the command-line workflow through the CLIs' main(args) at
     full width (256x256, the flagship at the bench point), small depth:
     (frames) a frame-mode collect of 8 episodes, one raster launch a
     recorded step, npz + pickle + TFRecord; (chain) a state-only collect
     of 40 episodes, the balanced split, 2 train steps and an eval pass, a
     third step resumed from state-*.pt (step count and Adam moments
     continue), the predictor restored from the checkpoint (weights equal
     bit for bit, predict against the trainer model's forward), the
     batched controller on the test split (the CSVs' rows); the raster
     kernel held against its twin on the first launch of each new size,
     its launches counted per path; episodes/s, train steps/s and
     controller env-steps/s

  13. slice 5, every scene: (nutcone, clutter4) the MuJoCo replays of
     tests/fixtures/mujoco_pickplace_{nutcone,pad2cube2clutter4}.npz at B=1
     through reset_to + step of the production envs: the task object
     within 30 mm, the objects MuJoCo shows moving within 30 mm (clutter4:
     55 mm, its brushed piece), the static ones within 5 mm, the nut-cone
     pick at task success; the solves counted by method; (scenes)
     clutter12, bridge-pad and diamond-pad at 8 envs and ball-cup at 64,
     two settle steps, one reset_random, a control step and a render:
     finite, the objects above the table, the raster kernel against its
     twin on the render, peak device memory; (this process) a render of
     slice 1 with a background frame per env from a GIF: one raster launch
     held against the twin, every env's wall changed and its table front
     not; the PSD kernel on a substep's operands of clutter4 and nut-cone
     at rolling=False, solver_method='pallas' (B=64, K=192 and K=224) held
     against its twin, and the substep through each; alone, clutter4 and
     nut-cone at B=64: control steps of step + render (env-steps/s, one
     raster launch a render), one profiled control step (launches per
     substep, device time), a control step of each pallas env (one PSD
     kernel a substep in its device trace) and the PSD kernel's time at
     those shapes
  14. the renderer's options on slice 1's settled state at B=64, in this
     process beside the replays: the production render takes the
     hierarchical path and launches the raster kernel once; backend='jnp'
     (flat binning, plain PyTorch) launches it not at all; flat, and
     analytic rects with textures, shadows and depth_gl, each equal to the
     CPU port's frame in env 0 (depth_gl in [0, 1]); tiles 8 and 32 (256
     px) and 10 (320 px) launch the kernel once each, bit-equal to its twin
     on their coefficients; the gripper camera's frame finite; the MuJoCo
     ray-cast depth bounds of tests/test_render_golden.py on pad2cube2's
     three fixture frames for the auto, jnp and jnp+analytic variants; a
     control step under mass_inverse='blockgj' against 'chol' (at the CPU
     test's 2 substeps of 8 iterations, to its tolerance; at the production
     physics, the per-env median to 1e-6, the largest env printed beside
     chol's own spread under a 1e-7 change of qvel); a 2-substep
     control step profiled through utils/profiling.trace (non-empty file);
     --num_devices above the card count raises.  Alone at the end with
     phase 3c: the raster kernel's time at each of those tile sides
  15. the port's bench through its entry point (geeco_tpu_torch.bench's
     main, as python -m geeco_tpu_torch.bench runs it) at its defaults:
     B=256 control steps of step + render at collide_every=2 and binning
     caps 192/96 (96 slots a tile), then the trainer at B=8 x T=99, its
     renders at the same caps; a process beside the replays.  The first
     raster launch of each batch size (256 frames; 100 and 8 in the
     trainer) is held against the twin on its own coefficients.  The
     bench fails itself unless the raster kernel ran once a timed control
     step and ceil(B*T/100) + 1 times a train step; here it must exit 0
     with one JSON line of the JAX bench's keys and rates above 0.  Its
     rates are taken beside the other processes: not a measurement

Phases 5 and 8, the two replays at B=1, the two replays of phase 13, the
two parts of phase 12, phase 13's other scenes and phase 15 run in a
process each (this script with --replay-only slice1|slice2|nutcone|clutter4,
--cli-only frames|chain, --scenes-only or --bench-only) from the build on:
everything is
host-bound and the card idles most of the time.  Meanwhile this process
does what times nothing: the set-up of both slices, the kernel checks of
phases 3 and 6, the CPU frame, phase 9, the trainer's set-up and its
warm-up step, and phase 13's textured render, PSD checks and set-ups.  The
timed parts of phases 3, 4, 7, 10, 11 and 13 wait for those processes to
end and run alone; phase 12's rates are taken beside them, on a shared
host.

The kernels line holds the raster kernel (phases 3, 4, 10-15), the PSD
solve (phases 6, 7, 13) and the raster kernel at tiles 8, 32 and 10
(phase 14).

The line before the last two is a JSON object describing each kernel; then
the card's name and power limit; the last line is {"ok": true, "device":
{...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()   # this process's start: the [t=...] stamps
FIXTURE = os.path.join(ROOT, 'tests', 'fixtures',
                       'mujoco_pickplace_pad2cube2.npz')
# kernel vs twin: both evaluate (a*px + b*py) + c with rounded ops and no
# FMA, so they must agree exactly; allow at most 1 pixel in 10^4 to differ
MISMATCH_TOL = 1e-4
IZ_ATOL = 1e-6          # inverse-depth agreement on matching pixels
CPU_FRAME_TOL = 5e-3    # CUDA vs CPU full frame: edge pixels only
ENVS = 64               # batch of both slices
STEPS = 5               # control steps of step + render
# PSD kernel vs twin: the JAX package's pallas-vs-psd tolerances
# (tests/test_solver_pallas.py:87-91); sums run in another order
FORCE_TOL = dict(rtol=1e-2, atol=2e-3)
QVEL_TOL = dict(rtol=1e-3, atol=1e-4)
EPISODE = 100           # control steps of an expert episode (run/sim.py:36)
MIN_SUCCESS = 0.80      # expert task success over the B envs
DRIFT_LIMIT = 0.03      # replay: task-object drift from the MuJoCo trace
# the slice-1 replay runs the first half of the 100-step episode (approach,
# grasp, lift): at full depth it was the longest phase, and a whole run has
# passed 1100 of its 1200 s on a slow host.  The slice-2 replay runs whole
REPLAY1_STEPS = 50
# PSD kernel at the reset substep: at most this share of envs where it is
# > 2x farther from the float64 solve than every float32 twin
WITNESS_MAX_FRAC = 0.125
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s,
# float32 operations/s outside the tensor cores
# the PSD solve's shapes (nI, nv, nE, K, nlim) and the cluster sizes they
# are run in (None: the plan's own at B=3): pad2-cube2 with and without weld
# rows, then one shape for each other way through the kernel (phase 6a;
# the K=192 one is also clutter4's at rolling=False), then nut-cone's at
# rolling=False, its K the sum of its quotas (phase 13)
PSD_BUILDS = (((530, 39, 6, 128, 9), (1, 2, 4)),
              ((530, 39, 0, 128, 9), (1, 2, 4)),
              ((274, 45, 6, 64, 9), (1,)),
              ((786, 63, 6, 192, 9), (None,)),
              ((1298, 87, 6, 320, 9), (None,)),
              ((914, 39, 6, 224, 9), (None,)))
HBM_RATE = 3.35e12
FP32_RATE = 67e12
# slice 3: the trainer at bench.py's point (bench.py:190-203): B episodes of
# T steps, windows encoded in chunks of 8, state re-rendered
# geeco_tpu_torch.bench.RENDER_CHUNK frames a call
TRAIN_B, TRAIN_T = 8, 99
TRAIN_STEPS = 5         # timed train steps, after one warm-up step
CL_STEPS = 5            # closed-loop control steps of the ENVS envs
# the flagship's heads in bf16 against float32 convolutions (8 bits of
# mantissa through 8 layers; 0.37-1.19% on the H100, 1-3.3% on the CPU at
# 256x256): within this share of their largest value
BF16_REL = 0.03
# phase 12, the command-line workflow (two processes of their own):
# frame-mode collection of CLI_FRAME_ENVS episodes; state-only collection
# of one chunk of CLI_ENVS (its balanced split leaves 2 train batches and
# an eval batch), CLI_STEPS recorded steps each (cut from 100); the trainer
# at the bench point on CLI_BATCH episodes a batch; the batched controller
# on the test split, CLI_CTRL_ENVS envs, CLI_CL_STEPS control steps (cut
# from 200)
CLI_DIR = os.path.join(ROOT, 'build', 'cli_smoke')
CLI_PARTS = ('frames', 'chain')
CLI_FRAME_ENVS, CLI_ENVS, CLI_STEPS = 8, 40, 10
CLI_BATCH, CLI_CTRL_ENVS, CLI_CL_STEPS = 8, 16, 5
# a small float32 train step on the card against the CPU: the same float32
# graph, other convolution algorithms (no TF32).  Gradients per tensor, as
# the norm of the difference over the norm of the CPU's: the largest, and
# the median over the tensors
SMALL_LOSS_RTOL = 1e-4
SMALL_GRAD_REL = 3e-3
SMALL_GRAD_MEDIAN = 1e-4
# phase 13, every scene.  The MuJoCo replays of nut-cone and clutter4 on
# their production envs at B=1 (a process each): the task object within
# DRIFT_LIMIT, the objects MuJoCo shows moving (more than 5 mm) within
# their scene's limit (one brushed clutter piece rolls near-chaotically:
# 55 mm, tests/test_replay_parity.py:96-103), the others within
# STATIC_LIMIT; REPLAY_STEPS cuts a replay (None: whole).  clutter4 runs
# its first 50 steps (approach, grasp, lift), held to the drift limits
# alone: whole, beside the nut-cone replay, the script took 1182 s of its
# 1200 (its replay 387 s; PERF.md)
REPLAYS = {'nutcone': ('nut-cone', 'mujoco_pickplace_nutcone.npz', 0.03),
           'clutter4': ('pad2-cube2-clutter4',
                        'mujoco_pickplace_pad2cube2clutter4.npz', 0.055)}
REPLAY_STEPS = {'nutcone': None, 'clutter4': 50}
STATIC_LIMIT = 0.005
# the other four new scenes, a process: SCENE_ENVS envs, SCENE_SETTLE
# settle steps, one reset_random, one control step and a render each
SCENES_ONLY = ('pad2-cube2-clutter12', 'ball-cup', 'bridge-pad',
               'diamond-pad')
SCENE_ENVS, SCENE_SETTLE = 8, 2
SCENE_BATCH = {'ball-cup': ENVS}   # its peak memory at the full batch
SCENES_SUMMARY = os.path.join(ROOT, 'build', 'scenes_smoke.json')
# phase 15: the port's bench at its defaults, a process beside the
# replays; its stdout and stderr go to BENCH_LOG.out and .err, its raster
# launches and their check against the twin to BENCH_LOG.json
BENCH_LOG = os.path.join(ROOT, 'build', 'bench_smoke')
BENCH_KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'train_steps_per_sec')
# in this process: clutter4 and nut-cone at ENVS envs (settle steps cut to
# SCENE_SETTLE: the set-ups run beside the replays), SCENE_STEPS timed
# control steps of step + render; their K2 operands at rolling=False,
# solver_method='pallas'; a textured render of slice 1 with a background
# frame per env from a GIF written here
TIMED_SCENES = ('pad2-cube2-clutter4', 'nut-cone')
SCENE_STEPS = 3
BACKGROUND_GIF = os.path.join(ROOT, 'build', 'chip_smoke_background.gif')
# phase 14: one control step under mass_inverse='blockgj' against 'chol'
# at tests/test_torch_levers.py's physics and tolerance
BLOCKGJ_PHYSICS = dict(n_substeps=2, solver_iterations=8)
BLOCKGJ_QPOS_ATOL = 1e-4
# and at the production physics (20 substeps of 60 iterations) the per-env
# median within BLOCKGJ_PROD_MEDIAN.  The largest env is printed beside the
# spread that a relative change of qvel by 1e-7 gives the chol step, not
# gated: a few envs amplify rounding without bound (one reached a state a
# substep before a 32 kN contact impulse, which the JAX package's substep
# reproduces from that state; even one substep from a common state moved
# qvel 1.5e-2 apart on the card: PERF.md)
BLOCKGJ_PROD_MEDIAN = 1e-6
# K1's other tile sides, timed alone: (tile, frame side)
OPTION_TILES = ((8, 256), (32, 256), (10, 320))
# K1 held bit for bit against its twin on random planes at a side of each
# class of band plan (raster_kernel.subtile_plan): one band with masked
# pixels (1, 2, 6, 10), two to seven bands (18, 20, 24, 32, 40)
RANDOM_SIDES = (1, 2, 6, 10, 18, 20, 24, 32, 40)
RANDOM_SIDES_SHAPE = (3, 16, 192)   # B, n_tiles, K


def fail(msg: str):
  print(f'FAIL: {msg}', flush=True)
  sys.exit(1)


def check(cond: bool, msg: str):
  if not cond:
    fail(msg)


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
    check(host < 0.04, f'{repeats} launches took the host {host:.3f} s, '
          'longer than the spin kernel they were to queue behind')
    return start.elapsed_time(end) / repeats
  times = []
  for _ in range(repeats):
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def compare_raster(coeffs, tile, sky, rk, label, out=None):
  """Kernel vs twin on the same coefficients; returns max_abs_err.  ``out``:
  the kernel's (izbuf, cbuf) of a launch the caller made on ``coeffs``."""
  iz_k, c_k = rk.raster_tiles(coeffs, tile, sky) if out is None else out
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
  return err


def slot_counts(coeffs, tile):
  """Per tile [B, n_tiles]: the slots that are filled (C0 is not the empty
  marker -1e30) and the slots that can touch the tile (no edge function
  negative at all four corner pixels of the tile: the kernel's cull, were
  the tile one band)."""
  from geeco_tpu_torch.render import raster_kernel as rk
  whole = rk.live_slots(coeffs, tile, (tile, tile, 1))[:, :, 0]
  return (coeffs[:, :, 2] > -1e29).sum(-1), whole.sum(-1)


def raster_work(coeffs, tile, plan, keep, loaded=None):
  """(bytes, operations) of one raster launch that culls the slots against
  each band of `plan` and tests the slots `keep` ([B, n_tiles, bands, K]
  bool, ``raster_kernel.live_slots``) against every pixel of their band:
  both buffers written once; per pixel and tested slot 4 affine forms (2
  multiplies, 2 adds each) and 4 compares.  With `loaded` ([B, n_tiles,
  bands, chunks] bool, ``raster_kernel.loaded_chunks``), what the kernel's
  own cull needs: the first edge (3 rows) of every slot read once and the
  other 10 rows of each chunk that a band of its tile loads; per slot and
  band the first edge at 4 corners (5 operations and a compare each), and
  the other two edges for the slots of the chunks that band loads.
  Without: every coefficient read once, and all three edges of every slot
  culled against every band."""
  from geeco_tpu_torch.render import raster_kernel as rk
  B, n_tiles, _, K = coeffs.shape
  band_px = torch.tensor([(x1 - x0) * (y1 - y0)
                          for x0, x1, y0, y1 in rk.band_rects(tile, plan)],
                         dtype=torch.float64, device=coeffs.device)
  tested = float((keep.sum(-1).double() * band_px).sum())
  out_bytes = 4 * 2 * B * n_tiles * tile * tile
  if loaded is None:
    return (4 * coeffs.numel() + out_bytes,
            20.0 * tested + 72.0 * B * n_tiles * K * plan[2])
  chunk = torch.arange(loaded.shape[-1], device=coeffs.device)
  per_chunk = torch.clamp(K - 32 * chunk, max=32).double()
  band_slots = float((loaded.double() * per_chunk).sum())
  tile_slots = float((loaded.any(2).double() * per_chunk).sum())
  return (4 * (3 * B * n_tiles * K + 10 * tile_slots) + out_bytes,
          20.0 * tested + 24.0 * B * n_tiles * K * plan[2] +
          48.0 * band_slots)


def describe_slots(coeffs, tile, label):
  """Print the distribution of filled and of touching slots per tile."""
  filled, live = slot_counts(coeffs, tile)
  edges = torch.tensor([0, 1, 2, 4, 8, 16, 32, 64, 128, 10 ** 6],
                       device=coeffs.device)
  for name, n in (('filled', filled), ('touching', live)):
    n = n.flatten()
    hist = torch.histc(torch.bucketize(n, edges, right=True).float() - 1,
                       bins=len(edges) - 1, min=0, max=len(edges) - 1)
    q = torch.quantile(n.float(), torch.tensor([0.5, 0.9, 0.99],
                                               device=n.device))
    print(f'[raster:{label}] {name} slots per tile of {coeffs.shape[3]}: '
          f'mean {float(n.float().mean()):.2f}, median {float(q[0]):.0f}, '
          f'p90 {float(q[1]):.0f}, p99 {float(q[2]):.0f}, max {int(n.max())}; '
          f'tiles with [0, 1, 2-3, 4-7, 8-15, 16-31, 32-63, 64-127, 128+] '
          f'slots: {[int(h) for h in hist]}', flush=True)


def time_raster(coeffs, tile, sky, rk, card, label):
  """The raster kernel's and its twin's time on `coeffs`, with the bound
  for what the kernel's own cull needs (``raster_kernel.live_slots`` and
  ``loaded_chunks`` on its plan), and beside it the bound for the same
  slots with every coefficient read, the bound for the slots that can
  touch their tile (one band a tile, every coefficient read: the earlier
  count), for the filled slots and for all slots.  Returns (ms, plain_ms,
  band bound, tile bound)."""
  ms = cuda_ms(lambda: rk.raster_tiles(coeffs, tile, sky), 30, queued=True)
  plain_ms = cuda_ms(lambda: rk.raster_tiles_reference(coeffs, tile, sky), 3)
  plan = rk.subtile_plan(tile)
  whole = (tile, tile, 1)
  keep = rk.live_slots(coeffs, tile, plan)
  loaded = rk.loaded_chunks(coeffs, tile, plan)
  keep_tile = rk.live_slots(coeffs, tile, whole)
  filled = (coeffs[:, :, 2] > -1e29)[:, :, None]
  B, n_tiles, _, K = coeffs.shape
  b_band = bound(*raster_work(coeffs, tile, plan, keep, loaded))
  b_read_all = bound(*raster_work(coeffs, tile, plan, keep))
  b_live, b_filled, b_all = (
      bound(*raster_work(coeffs, tile, whole, k))
      for k in (keep_tile, filled, torch.ones_like(filled)))
  print(f'[raster:{label}] kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms '
        f'(CUDA events: the kernel queued, the twin one by one); bound '
        f'{b_band[0]:.4f} ms by {b_band[1]} counting the {int(keep.sum())} '
        f'slots the {plan[2]} band(s) of {plan[0]}x{plan[1]} px a tile keep '
        f'(plan {plan}) and the first edge of every slot plus the '
        f'{int(loaded.any(2).sum())} chunks of 32 slots the bands load '
        f'({int(loaded.sum())} band-chunks), {b_read_all[0]:.4f} ms by '
        f'{b_read_all[1]} reading every coefficient; {b_live[0]:.4f} ms by '
        f'{b_live[1]} counting the {int(keep_tile.sum())} slots that can '
        f'touch their tile (of {int(filled.sum())} filled, '
        f'{B * n_tiles * K} in all) and every coefficient; counting every '
        f'filled slot {b_filled[0]:.4f} ms by {b_filled[1]}, every slot '
        f'{b_all[0]:.4f} ms by {b_all[1]}, on {card}', flush=True)
  check(ms >= b_band[0], f'raster kernel time {ms} ms under its bound '
        f'{b_band[0]} ms on {label} planes: the count is at fault')
  return ms, plain_ms, b_band, b_live


# profile_step reads a profile of fewer raw records through the profiler's
# event objects as well
CROSS_CHECK_RECORDS = 20000


def _hidden_record(e) -> bool:
  """A raw record the profiler's own event list leaves out (memory
  records, hidden events), by the test it applies."""
  from torch.autograd.profiler_util import _filter_name
  return (_filter_name(e.name()) or
          getattr(e, 'is_hidden_event', lambda: False)())


def read_records(records):
  """(kernel launches, device spans [(start, end) us]) of profiler records
  given as (device type, name, start us, end us)."""
  from torch.autograd import DeviceType
  launches, spans = 0, []
  for dev_type, name, start, end in records:
    if dev_type == DeviceType.CUDA:
      spans.append((start, end))
    elif name.startswith(('cudaLaunchKernel', 'cuLaunchKernel')):
      launches += 1
  return launches, spans


def union_ms(spans) -> float:
  """The time the union of [(start, end) us] intervals covers, in ms."""
  device_us, reach = 0.0, float('-inf')
  for start, end in sorted(spans):
    device_us += max(0.0, end - max(start, reach))
    reach = max(reach, end)
  return device_us / 1e3


def profile_step(fn, label, card, path='', top=0):
  """One call of fn under torch.profiler: the CUDA kernel launches it made
  and the device time they took (profiled, so the host is slower than
  unprofiled); with ``path``, the profiler's tables are written there, with
  ``top``, the kernels that took the most device time are printed.

  The device time is the union of the device events' intervals (kernels,
  copies, sets).  (Summing every event's self device time would count a
  kernel twice, once as its own event and once under the operator that
  launched it.)  Both are read from the profiler's raw records
  (``read_records``): building its event objects (``prof.events()``) took
  a control step's 125k records 33-65 s on the H100's host.  A profile of
  fewer than CROSS_CHECK_RECORDS records is also read through
  ``prof.events()``, and the two readings must agree."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  results = prof.profiler.kineto_results
  records, t_ns = results.events(), results.trace_start_ns()
  # times from the trace's start, as the event objects take them (the
  # epoch's nanoseconds as a float64 of microseconds lose a quarter of one)
  launches, spans = read_records(
      (e.device_type(), e.name(), (e.start_ns() - t_ns) / 1e3,
       (e.end_ns() - t_ns) / 1e3)
      for e in records if not _hidden_record(e))
  device_ms = union_ms(spans)
  if len(records) < CROSS_CHECK_RECORDS:
    # the same through the profiler's event objects (the tree it builds)
    e_launches, e_spans = read_records(
        (e.device_type, e.name, e.time_range.start, e.time_range.end)
        for e in prof.events())
    check(e_launches == launches and len(e_spans) == len(spans) and
          abs(union_ms(e_spans) - device_ms) <= 1e-3 * device_ms + 1e-3,
          f'{label}: the raw records give {launches} launches, '
          f'{len(spans)} device events, {device_ms} ms; the event objects '
          f'{e_launches}, {len(e_spans)}, {union_ms(e_spans)} ms')
  print(f'[profile] {label}: {launches} kernel launches, device time '
        f'{device_ms:.1f} ms ({len(spans)} device events), wall {wall:.2f} s '
        f'(profiled; then {time.perf_counter() - t0 - wall:.1f} s to read '
        f'the events) on {card}', flush=True)
  events = prof.key_averages() if top or path else None
  if top:
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:top]
    for e in kernels:
      print(f'[profile]   {e.self_device_time_total / 1e3:8.1f} ms '
            f'{e.count:6d}x {e.key[:90]}', flush=True)
  if path:
    with open(path, 'w') as f:
      f.write(f'# {label}, {card}\n')
      f.write(events.table(sort_by='cuda_time_total', row_limit=40))
      f.write('\n' + events.table(sort_by='cpu_time_total', row_limit=25))
    print(f'[profile] written to {path}', flush=True)
  return launches, device_ms, wall


def model_checks(card):
  """Phase 9.  Returns (config, flagship model with its heads perturbed):
  the flagship E2E-VMC (__graft_entry__.py: goal-conditioned,
  dynimg/dyndiff, 256x256, bf16 convolutions) with the bench's trainer
  settings."""
  from geeco_tpu_torch.bench import bench_config
  from geeco_tpu_torch.models import e2evmc as TE
  cfg = bench_config()
  model = TE.make_model(cfg, True, device='cuda',
                        generator=torch.Generator().manual_seed(0))
  # zero-initialised heads predict exactly 0: give them seeded weights so
  # the outputs see the whole network (and the closed loop acts)
  gen = torch.Generator().manual_seed(1)
  with torch.no_grad():
    for name, _ in model.decoder.heads:
      w = getattr(model.decoder, name).weight
      w.copy_(0.05 * torch.randn(w.shape, generator=gen))
  f32 = TE.make_model(dataclasses.replace(cfg, compute_dtype='float32'),
                      True, device='cuda')
  f32.load_state_dict(model.state_dict())
  n, K, H, W = 4, cfg.window_size, cfg.img_height, cfg.img_width
  g = torch.Generator(device='cuda').manual_seed(3)
  frames = torch.rand((n, K, H, W, 3), generator=g, device='cuda')
  jnt = torch.randn((n, K, 7), generator=g, device='cuda')
  tgt = torch.rand((n, H, W, 3), generator=g, device='cuda')
  carry = tuple(torch.randn((n, cfg.dim_h_lstm), generator=g, device='cuda')
                for _ in range(2))
  with torch.no_grad():
    ep, c = model(frames, jnt, tgt, carry, False)
    ref, rc = f32(frames, jnt, tgt, carry, False)
  torch.cuda.synchronize()
  err = 0.0
  for k, _ in model.decoder.heads:
    check(bool(torch.isfinite(ep[k]).all()), f'flagship {k} not finite')
    rel = float((ep[k] - ref[k]).abs().max() / ref[k].abs().max())
    err = max(err, rel)
    print(f'[model] flagship {k}: |bf16 - float32| max {rel:.4g} of the '
          f'largest |value| {float(ref[k].abs().max()):.4g} (tolerance '
          f'{BF16_REL:g})', flush=True)
    check(rel <= BF16_REL, f'flagship bf16 {k} disagrees with float32')
  cerr = max(float((a - b).abs().max()) for a, b in zip(c, rc))
  print(f'[model] flagship (n={n}, {K}x{H}x{W}x3, '
        f'{TE.count_parameters(model)} parameters): carry |bf16 - float32| '
        f'max {cerr:.4g} (tolerance {BF16_REL:g}); dynbuff '
        f'{tuple(ep["dynbuff"].shape)}, dyndiff {tuple(ep["dyndiff"].shape)}',
        flush=True)
  check(cerr <= BF16_REL, 'flagship bf16 carry disagrees with float32')
  del f32, frames, tgt
  small_train_check()
  return cfg, model


def small_train_check():
  """Phase 9b: one float32 per-window train step (64x64, encoders 20 wide:
  their last GroupNorm is one group) on the CPU and on the card from the
  same weights and batch; then the same step on the card with cuDNN's TF32
  on in every convolution (the model's float32 scope replaced), a control
  that the same comparison must reject."""
  from geeco_tpu_torch.models import e2evmc as TE
  from geeco_tpu_torch.models import train as TT
  from geeco_tpu_torch.models.params import create_e2evmc_config
  cfg = create_e2evmc_config(dict(
      img_height=64, img_width=64, window_size=4, dim_s_obs=20, dim_s_dyn=20,
      dim_s_diff=20, dim_h_lstm=16, dim_h_fc=16, proc_obs='dynimg',
      proc_tgt='dyndiff', compute_dtype='float32', lr=1e-3))
  rng = np.random.RandomState(1)
  n = 4
  feature = {'step': np.ones((n, 4), np.int64),
             'rgb': rng.rand(n, 4, 64, 64, 3),
             'jnt_state': rng.randn(n, 4, 7),
             'ee_state': rng.randn(n, 4, 7), 'obj_state': rng.randn(n, 4, 7),
             'target_rgb': rng.rand(n, 64, 64, 3)}
  label = {'cmd': rng.uniform(-1, 1, (n, 4))}

  def step_on(dev):
    t = lambda x: torch.as_tensor(x if x.dtype == np.int64 else
                                  x.astype(np.float32), device=dev)
    init_fn, train_step, _, _ = TT.make_train_fns(cfg, True, device=dev)
    ts = init_fn(torch.Generator().manual_seed(0), n)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
      for p in ts.model.parameters():
        p.add_(0.05 * torch.randn(p.shape, generator=gen).to(dev))
    ts, m = train_step(ts, {k: t(v) for k, v in feature.items()},
                       {k: t(v) for k, v in label.items()})
    return ({k: float(v) for k, v in m.items()},
            {k: (p.grad.cpu(), p.detach().cpu())
             for k, p in ts.model.named_parameters()})

  @contextlib.contextmanager
  def tf32_on(_dtype):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
      yield
    finally:
      torch.backends.cudnn.allow_tf32 = before

  def failures(run, label):
    """The comparison with the CPU's step: what it finds out of tolerance."""
    (m_c, p_c), (m_g, p_g) = cpu, run
    out = [k for k, v in m_c.items()
           if abs(m_g[k] - v) > SMALL_LOSS_RTOL * abs(v) + 1e-6]
    rel = {k: float((p_g[k][0] - g).norm() / (g.norm() + 1e-12))
           for k, (g, _) in p_c.items()}
    worst = max(rel, key=rel.get)
    median = float(np.median(list(rel.values())))
    perr = max(float((p_g[k][1] - p).abs().max()) for k, (_, p) in p_c.items())
    print(f'[model:small] {label}: loss {m_g["loss"]:.8g} (CPU '
          f'{m_c["loss"]:.8g}); gradients |card - CPU| / |CPU| per tensor '
          f'at most {rel[worst]:.3g} ({worst}; tolerance {SMALL_GRAD_REL:g}), '
          f'median {median:.3g} (tolerance {SMALL_GRAD_MEDIAN:g}); '
          f'parameters after the step {perr:.3g} apart (Adam\'s first step '
          f'is about lr * sign(g): tolerance 2 lr = {2 * cfg.lr:g}); metrics '
          f'out of tolerance: {out}', flush=True)
    if rel[worst] > SMALL_GRAD_REL:
      out.append('gradient (largest)')
    if median > SMALL_GRAD_MEDIAN:
      out.append('gradient (median)')
    if perr > 2 * cfg.lr + 1e-6:
      out.append('parameters')
    return out

  cpu = step_on('cpu')
  bad = failures(step_on('cuda'), 'card')
  check(not bad, f'small train step differs between card and CPU: {bad}')
  scopes = TE.conv_precision, TT.conv_precision
  TE.conv_precision = TT.conv_precision = tf32_on
  try:
    control = step_on('cuda')
  finally:
    TE.conv_precision, TT.conv_precision = scopes
  bad = failures(control, 'control, TF32 on')
  check(bool(bad), 'the card-vs-CPU comparison passes a step with TF32 on: '
        'it cannot see TF32')


@contextlib.contextmanager
def checked_raster(rk, label, first_of_each_size=False, stream=None):
  """Hold the raster kernel against its twin inside the block, on the
  coefficients its callers gave it and on the output they went on with:
  every launch, or the first launch of each batch size.  Yields a dict
  with the frames of every launch ('sizes'), the coefficient shapes held
  ('checked') and the largest max_abs_err ('err').  The comparisons launch
  nothing: the counts stay the path's.  ``stream``: where the comparisons
  print (default stdout)."""
  launch = rk.raster_tiles
  out = {'sizes': [], 'checked': [], 'err': 0.0}

  def checked_launch(coeffs, tile, sky):
    res = launch(coeffs, tile, sky)
    size = coeffs.shape[0]
    if not (first_of_each_size and size in out['sizes']):
      with contextlib.redirect_stdout(stream or sys.stdout):
        out['err'] = max(out['err'], compare_raster(
            coeffs, tile, sky, rk,
            f'{label} render {len(out["sizes"]) + 1}', res))
      out['checked'].append(list(coeffs.shape))
    out['sizes'].append(size)
    return res

  # the kernel's wrapper counts its launch under the module's name
  checked_launch.launches = launch.launches
  rk.raster_tiles = checked_launch
  try:
    yield out
  finally:
    rk.raster_tiles = launch
    launch.launches = checked_launch.launches


def trainer_setup(env, card):
  """Phase 10a: the episode trainer at the bench point on slice 1's env,
  the bench's batch around the env's settled state (bench.train_batch), and
  one warm-up step, in which every raster-kernel launch is held against the
  twin on its own coefficients.  Returns (train_step, state, batch, warm-up
  loss, the kernel's max_abs_err)."""
  from geeco_tpu_torch.bench import RENDER_CHUNK, bench_config, train_batch
  from geeco_tpu_torch.models import train as TT
  from geeco_tpu_torch.render import raster_kernel as rk
  cfg = bench_config()
  t0 = time.perf_counter()
  init_fn, train_step, _, _ = TT.make_episode_train_fns(
      cfg, True, chunk_windows=8, render_fn=env.render_from_qpos,
      aug_pad=10, render_chunk=RENDER_CHUNK, device='cuda')
  ts = init_fn(torch.Generator().manual_seed(0), cfg.batch_size)
  B, T = TRAIN_B, TRAIN_T
  batch = train_batch(env, B, T, 'cuda', cfg)
  N = batch['widx'].shape[0]
  # the warm-up step's renders (chunks of RENDER_CHUNK frames, the last one
  # padded, then the goal frames): the kernel against its twin on the
  # coefficients the trainer gave it, the output the trainer went on with
  with checked_raster(rk, 'trainer') as chk:
    ts, m = train_step(ts, batch)
  sizes, err = chk['sizes'], chk['err']
  loss0 = float(m['loss'])
  want = [RENDER_CHUNK] * -(-B * T // RENDER_CHUNK) + [B]
  print(f'[train] episode trainer (B={B}, T={T}, {N} windows, '
        f'chunk_windows=8, render_chunk={RENDER_CHUNK}, aug_pad=10): set-up '
        f'and warm-up step {time.perf_counter() - t0:.1f} s (beside the '
        f'replay processes, its renders checked against the twin), loss '
        f'{loss0:.5f}; frames per raster launch {sizes}', flush=True)
  check(sizes == want, f'the warm-up step\'s raster launches took {sizes} '
        f'frames, expected {want}')
  check(np.isfinite(loss0), 'warm-up loss not finite')
  return train_step, ts, batch, loss0, err


def trainer_run(train_step, ts, batch, loss0, card, rk, env):
  """Phase 10b: timed train steps on the fixed batch, alone, then one
  profiled step and one profiled render of RENDER_CHUNK frames (the
  renders' share of the step).  Returns the raster-kernel launches the
  timed steps made."""
  from geeco_tpu_torch.bench import RENDER_CHUNK, train_launches
  rk.raster_tiles.launches = 0
  torch.cuda.reset_peak_memory_stats()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  losses = []
  for _ in range(TRAIN_STEPS):
    ts, m = train_step(ts, batch)
    losses.append(m['loss'])
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = rk.raster_tiles.launches
  peak = torch.cuda.max_memory_allocated()
  losses = [loss0] + torch.stack(losses).tolist()
  per_step = train_launches(TRAIN_B, TRAIN_T)
  print(f'[train] {TRAIN_STEPS} train steps in {dt:.3f} s -> '
        f'{TRAIN_STEPS / dt:.4f} train steps/s (B={TRAIN_B} x T={TRAIN_T}, '
        f'256x256, bf16) on {card}; peak device memory '
        f'{peak / 2 ** 30:.2f} GiB; loss over the warm-up and timed steps '
        f'{[round(x, 5) for x in losses]}', flush=True)
  print(f'[train] raster kernel launches: {launches} for {TRAIN_STEPS} '
        f'steps ({per_step} a step: ceil({TRAIN_B}*{TRAIN_T}/{RENDER_CHUNK}) '
        f'+ 1)', flush=True)
  check(launches == per_step * TRAIN_STEPS,
        'the raster kernel did not run ceil(B*T/render_chunk) + 1 times a '
        'train step')
  check(all(np.isfinite(losses)), 'a train loss is not finite')
  check(losses[-1] < losses[0], 'the loss did not fall on the fixed batch')
  n, dev_ms, wall = profile_step(lambda: train_step(ts, batch),
                                 f'one train step, B={TRAIN_B} x '
                                 f'T={TRAIN_T}', card, top=12)
  step_ms = 1e3 * dt / TRAIN_STEPS
  print(f'[train] device idle share of a train step: '
        f'{1 - dev_ms / step_ms:.4f} of the unprofiled {step_ms:.1f} ms '
        f'({1 - dev_ms / (1e3 * wall):.4f} of the profiled {1e3 * wall:.1f} '
        f'ms); {n} launches', flush=True)
  flat = lambda k: batch[k].reshape((-1,) + batch[k].shape[2:])
  q, m = flat('qpos')[:RENDER_CHUNK], flat('mocap')[:RENDER_CHUNK]
  rgba = batch['rgba'].repeat_interleave(TRAIN_T, 0)[:RENDER_CHUNK]
  rn, r_ms, _ = profile_step(lambda: env.render_from_qpos(q, m, rgba),
                             f'one render of {RENDER_CHUNK} frames', card)
  chunks = TRAIN_B * TRAIN_T // RENDER_CHUNK
  print(f'[train] the step\'s {chunks} full renders: ~{chunks * r_ms:.1f} ms '
        f'of its {dev_ms:.1f} ms device time, ~{chunks * rn} of its {n} '
        'launches (and one render of the padded chunk, one of the goal '
        'frames)', flush=True)
  return launches


def start_bench():
  """Phase 15's process: this script with --bench-only, at the bench's
  defaults (no BENCH_* variable), one CPU thread as the other children."""
  env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
  env['OMP_NUM_THREADS'] = '1'
  os.makedirs(os.path.dirname(BENCH_LOG), exist_ok=True)
  with open(BENCH_LOG + '.out', 'w') as out, \
      open(BENCH_LOG + '.err', 'w') as err:
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             '--bench-only'], cwd=ROOT, env=env, stdout=out,
                            stderr=err)


def bench_child():
  """Phase 15 (``--bench-only``): the bench's entry point with no arguments,
  the first raster launch of each batch size held against the twin (its
  lines on stderr: stdout holds the bench's JSON line alone); the
  launches and the check go to BENCH_LOG.json."""
  from geeco_tpu_torch import bench
  from geeco_tpu_torch.render import raster_kernel as rk
  with checked_raster(rk, 'bench', first_of_each_size=True,
                      stream=sys.stderr) as chk:
    bench.main([])
  os.makedirs(os.path.dirname(BENCH_LOG), exist_ok=True)
  with open(BENCH_LOG + '.json', 'w') as f:
    json.dump({'launches': len(chk['sizes']), 'checked': chk['checked'],
               'max_abs_err': chk['err']}, f)


def bench_phase(child):
  """Phase 15: the bench's process ended with exit 0 (the bench fails
  itself when the raster kernel's launches break its rule), printed one
  JSON line with the JAX bench's keys and rates above 0, and held the
  kernel against its twin at the shapes of both halves.  Returns
  ({'bench': launches}, the kernel's max_abs_err)."""
  from geeco_tpu_torch import bench
  rc = child.wait()
  print(f'[children] the bench (phase 15) ended by t='
        f'{time.perf_counter() - T_START:.0f} s', flush=True)
  with open(BENCH_LOG + '.out') as f:
    out = f.read().splitlines()
  with open(BENCH_LOG + '.err') as f:
    err = f.read().splitlines()
  for line in err[-40:]:
    print(f'[bench] {line}', flush=True)
  check(rc == 0, f'the bench failed with exit code {rc}')
  check(len(out) == 1, f'the bench printed {len(out)} lines on stdout, not '
        'one JSON line')
  res = json.loads(out[0])
  check(all(k in res for k in BENCH_KEYS) and 'truncated' not in res,
        f'the bench\'s line lacks a key of {BENCH_KEYS} or was cut: {res}')
  check(res['value'] > 0 and res['train_steps_per_sec'] > 0,
        f'a rate of the bench is not above 0: {res}')
  with open(BENCH_LOG + '.json') as f:
    held = json.load(f)
  kwargs, sweep, _, _ = bench.env_kwargs({})
  slots = kwargs['renderer_kwargs']['mid_k']
  want = [[n, 256, 13, slots] for n in (*sweep, bench.RENDER_CHUNK, 8)]
  check(held['checked'] == want, f'the bench\'s raster launches held '
        f'against the twin had shapes {held["checked"]}, not {want}')
  print(f'[bench] {res["value"]} env-steps/s, {res["train_steps_per_sec"]} '
        'train steps/s (beside other processes: not a measurement); '
        f'{held["launches"]} raster kernel launches, those of shapes '
        f'{held["checked"]} held against the twin: max_abs_err '
        f'{held["max_abs_err"]}', flush=True)
  return {'bench': held['launches']}, held['max_abs_err']


def closed_loop_run(env, es, cfg, model, card, rk):
  """Phase 11: evaluate_batched of ``model`` on the ENVS envs of slice 1
  from ``es``, timed alone.  Returns the raster-kernel launches."""
  from geeco_tpu_torch.models import closed_loop as CL
  rk.raster_tiles.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  agg = CL.evaluate_batched(env, cfg, model, True, ENVS, es0=es,
                            n_steps=CL_STEPS)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = rk.raster_tiles.launches
  print(f'[closed_loop] {CL_STEPS} control steps of {ENVS} envs (goal '
        f'frames, render, policy, step) in {dt:.3f} s -> '
        f'{ENVS * CL_STEPS / dt:.2f} env-steps/s on {card}; raster kernel '
        f'launches {launches} (one a step + one for the goal frames)',
        flush=True)
  print('[closed_loop] ' + ', '.join(
      f'{k} {float(v.float().mean()):.4f}' for k, v in agg.items()),
      flush=True)
  check(all(bool(torch.isfinite(v).all()) for v in agg.values()),
        'closed-loop metrics not finite')
  check(launches == CL_STEPS + 1,
        'the raster kernel did not run once per control step + once')
  return launches


def _rows(path):
  """(header, rows) of a ';'-delimited CSV."""
  with open(path, newline='') as f:
    rows = list(csv.reader(f, delimiter=';'))
  return rows[0], rows[1:]


def _timed(fn, spans):
  """fn, with the seconds of each call (between two device synchronizes)
  appended to ``spans``."""
  def run(*a, **k):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    spans.append(time.perf_counter() - t0)
    return out
  return run


def cli_summary(part: str) -> str:
  return os.path.join(CLI_DIR, f'{part}.json')


def cli_phase(card, part, summary_path):
  """Phase 12, the command-line workflow through the CLIs' main(args) on
  the card at full width, small depth, in CLI_DIR; ``part`` 'frames' or
  'chain' (``--cli-only``: each a process of its own beside the replays).
  'frames': a frame-mode collect (npz, pickle, TFRecord per episode).
  'chain': a state-only collect, the split, train at the bench point,
  resume, the predictor restored from the checkpoint, the batched
  controller on the test split.  Checks the files, the resume, the
  predictor's weights and the controller's rows; holds the raster kernel
  against its twin on the first launch of each new size and counts its
  launches per path.  Writes the launches, the kernel's max_abs_err and the
  rates to ``summary_path``."""
  from geeco_tpu_torch.models import closed_loop as CL
  from geeco_tpu_torch.models import train as TT
  from geeco_tpu_torch.physics import solver_pallas as SP
  from geeco_tpu_torch.render import raster_kernel as rk
  from geeco_tpu_torch.run import sim
  t_phase = time.perf_counter()
  work = os.path.join(CLI_DIR, part)
  shutil.rmtree(work, ignore_errors=True)
  # the rollouts, train steps and closed loops the CLIs run, timed between
  # two synchronizes; the controller's raster launches before its closed
  # loop (the goal frames) read at the loop's start
  spans = {'rollout': [], 'train_step': [], 'closed_loop': []}
  goal_launches = []
  sim.rollout = _timed(sim.rollout, spans['rollout'])
  make_fns = TT.make_episode_train_fns

  def timed_fns(*a, **k):
    init_fn, train_step, eval_step, opt = make_fns(*a, **k)
    return init_fn, _timed(train_step, spans['train_step']), eval_step, opt
  TT.make_episode_train_fns = timed_fns
  evaluate = _timed(CL.evaluate_batched, spans['closed_loop'])

  def evaluate_batched(*a, **k):
    goal_launches.append(rk.raster_tiles.launches)
    return evaluate(*a, **k)
  CL.evaluate_batched = evaluate_batched
  out = {'launches': {}, 'max_abs_err': 0.0, 'rates': {}}

  def run(path, label, cli, argv):
    """One CLI call with the raster-kernel and PSD-kernel counts set to 0
    just before and read just after; the first launch of each batch size
    held against the twin.  Returns (its result, wall seconds)."""
    rk.raster_tiles.launches = 0
    SP.psd_solve.launches = 0
    t0 = time.perf_counter()
    with checked_raster(rk, label, first_of_each_size=True) as chk:
      res = cli.main(cli.parse(argv + ['--device', 'cuda', '--seed', '0']))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out['launches'][path] = rk.raster_tiles.launches
    out['max_abs_err'] = max(out['max_abs_err'], chk['err'])
    print(f'[cli] {label}: {wall:.1f} s, raster kernel launches '
          f'{out["launches"][path]} (frames each: '
          f'{sorted(set(chk["sizes"]))}), PSD kernel launches '
          f'{SP.psd_solve.launches}', flush=True)
    check(SP.psd_solve.launches == 0, f'{label}: the PSD kernel ran '
          '(the CLIs build rolling-row envs: plain psd)')
    return res, wall

  if part == 'frames':
    _cli_frames(run, out, spans, work)
  else:
    _cli_chain(run, out, spans, goal_launches, work)
  total = time.perf_counter() - t_phase
  print(f'[cli:{part}] rates on {card}, in a process of its own (in a full '
        'run beside the replays, the other part of phase 12 and the main '
        'process\'s untimed phases: a shared host): ' + ', '.join(
            f'{k} {v:.4f}' for k, v in out['rates'].items()), flush=True)
  print(f'[cli:{part}] took {total:.1f} s; raster launches by path '
        f'{out["launches"]}', flush=True)
  out['seconds'] = total
  with open(summary_path, 'w') as f:
    json.dump(out, f)


def _cli_frames(run, out, spans, work):
  """Phase 12, frame mode: CLI_FRAME_ENVS episodes of CLI_STEPS recorded
  steps, one render a step; npz + pickle + TFRecord per episode."""
  from geeco_tpu_torch.data.episode import load_episode
  from geeco_tpu_torch.run import gym_pickplace
  _, wall = run('collect_frames', 'collect (frames)', gym_pickplace, [
      '--wrk_dir', work, '--sim_mode', 'collect',
      '--dataset_formats', 'all', '--num_envs', str(CLI_FRAME_ENVS),
      '--end_idx', str(CLI_FRAME_ENVS),
      '--max_episode_steps', str(CLI_STEPS)])
  n = out['launches']['collect_frames']
  check(n == CLI_STEPS, f'frame collection launched the raster kernel {n} '
        f'times, expected one a recorded step ({CLI_STEPS})')
  out['rates'] = {'collect_frames_episodes_per_s': CLI_FRAME_ENVS / wall,
                  'collect_frames_rollout_episodes_per_s':
                  CLI_FRAME_ENVS / spans['rollout'][-1]}
  coll = os.path.join(work, 'collect')
  for i in range(1, CLI_FRAME_ENVS + 1):
    name = f'replay_buffer_{i:04d}'
    for f in (f'data/{name}.npz', f'data/{name}.json',
              f'data/{name}.tfrecord.zlib', f'{name}.pkl'):
      check(os.path.isfile(os.path.join(coll, f)), f'collect (frames) did '
            f'not write {f}')
  ep, ctx = load_episode(os.path.join(coll, 'data', 'replay_buffer_0001.npz'))
  tf, tctx = load_episode(os.path.join(coll, 'data',
                                       'replay_buffer_0001.tfrecord.zlib'))
  check(ep['rgb'].shape == (CLI_STEPS, 256, 256, 3) and
        ep['rgb'].dtype == np.uint8 and ep['step'].dtype == np.int32 and
        ep['depth'].dtype == np.float32, 'frame episode keys: rgb '
        f'{ep["rgb"].shape} {ep["rgb"].dtype}, step {ep["step"].dtype}')
  check(all(np.array_equal(tf[k], ep[k]) for k in ('rgb', 'step', 'cmd')),
        'the TFRecord and the npz of an episode disagree')
  check(ctx['renderer_kwargs'] == tctx['renderer_kwargs'] == {} and
        ctx['shapes'] == 'pad2-cube2', f'episode context {ctx}')


def _cli_chain(run, out, spans, goal_launches, work):
  """Phase 12, the chain: a state-only collect of CLI_ENVS episodes (one
  chunk), the balanced split, 2 train steps at the bench point and an eval
  pass, a resumed third step, the predictor, the batched controller."""
  from geeco_tpu_torch.data.episode import load_episode
  from geeco_tpu_torch.models import snapshots
  from geeco_tpu_torch.models.params import load_model_config
  from geeco_tpu_torch.models.predictor import GoalE2EVMCPredictor
  from geeco_tpu_torch.models import train as TT
  from geeco_tpu_torch.run import (dataset_tools, gym_pickplace, sim,
                                   train_e2evmc)
  rates = out['rates']
  launches = out['launches']
  # ---- collect, state only: the training set
  _, wall = run('collect_states', 'collect (states)', gym_pickplace, [
      '--wrk_dir', work, '--sim_mode', 'collect',
      '--dataset_formats', 'states', '--rendering_mode', 'none',
      '--num_envs', str(CLI_ENVS), '--end_idx', str(CLI_ENVS),
      '--max_episode_steps', str(CLI_STEPS)])
  check(launches.pop('collect_states') == 0, 'state-only collection '
        'rendered')
  rates['collect_states_episodes_per_s'] = CLI_ENVS / wall
  rates['collect_states_rollout_episodes_per_s'] = (
      CLI_ENVS / spans['rollout'][-1])
  ds = os.path.join(work, 'collect')
  ep, _ = load_episode(os.path.join(ds, 'data',
                                    f'replay_buffer_{CLI_ENVS:04d}.npz'))
  check('rgb' not in ep and ep['full_qpos'].shape[0] == CLI_STEPS and
        ep['rgba'].dtype == np.float32, 'state-only episode keys')
  # ---- split
  dataset_tools.main(dataset_tools.parse(
      ['create_splits', '--dataset_dir', ds, '--split_name', 'balanced']))
  split = {}
  for m in ('train', 'eval', 'test'):
    with open(os.path.join(ds, 'splits', 'balanced', f'{m}.txt')) as f:
      split[m] = f.read().split()
  print(f'[cli] split: {", ".join(f"{m} {len(v)}" for m, v in split.items())}'
        f' of {CLI_ENVS} episodes', flush=True)
  check(len(split['train']) >= 2 * CLI_BATCH and
        len(split['eval']) >= CLI_BATCH and len(split['test']) > 0,
        'the split leaves too few episodes for 2 train steps and an eval '
        'batch')
  # ---- train at the bench point, 2 steps and an eval pass
  model_dir = os.path.join(work, 'model')
  targs = [
      '--dataset_dir', ds, '--split_name', 'balanced', '--model_dir',
      model_dir, '--goal_condition', 'target', '--proc_obs', 'dynimg',
      '--proc_tgt', 'dyndiff', '--loss_weighting', 'cmd_mag',
      '--start_boost', '6', '--lr', '2e-4', '--aug_shift', '10',
      '--chunk_windows', '8', '--episodes_per_batch', str(CLI_BATCH),
      '--num_epochs', '1', '--max_steps_per_epoch', '2', '--log_steps', '1']
  ts1, _ = run('trainer_cli', 'train', train_e2evmc, targs)
  n_eval = min(2, len(split['eval']) // CLI_BATCH)
  per_step = 2   # one render of the B*T <= 100 frames, one of the goals
  check(ts1.step == 2 and launches['trainer_cli'] == per_step * (2 + n_eval),
        f'train: step {ts1.step}, {launches["trainer_cli"]} raster launches '
        f'(expected 2 steps, {per_step * (2 + n_eval)} launches)')
  rates['train_steps_per_s'] = 2 / sum(spans['train_step'])
  for f in ('e2evmc_config.json', 'metrics.jsonl', 'ckpt-00000002.pt',
            'state-00000002.pt', 'snapshots/snapshot_index.json',
            'snapshots/snapshot-00000002/ckpt-00000002.pt',
            'snapshots/snapshot-00000002/e2evmc_config.json'):
    check(os.path.isfile(os.path.join(model_dir, f)),
          f'train did not write {f}')
  # ---- resume from state-00000002.pt for one more step
  p0 = next(ts1.model.parameters())
  m1 = {k: v.clone() for k, v in ts1.optimizer.state[p0].items()}
  cfg = load_model_config(os.path.join(model_dir, 'e2evmc_config.json'))
  saved = snapshots.restore_train_state(
      os.path.join(model_dir, 'state-00000002.pt'),
      TT.make_episode_train_fns(cfg, True, device='cuda')[0]())
  check(all(torch.equal(a, b) for a, b in zip(
      saved.model.state_dict().values(), ts1.model.state_dict().values())),
      'state-00000002.pt does not restore the trainer\'s weights')
  m_saved = saved.optimizer.state[next(saved.model.parameters())]
  check(torch.equal(m_saved['exp_avg'], m1['exp_avg']) and
        torch.equal(m_saved['exp_avg_sq'], m1['exp_avg_sq']) and
        m_saved['exp_avg'].device == p0.device, 'state-00000002.pt does '
        'not restore the Adam moments on the card')
  del saved, m_saved
  ts2, _ = run('trainer_cli_resume', 'train (resume)', train_e2evmc,
               targs + ['--max_total_steps', '3'])
  launches['trainer_cli'] += launches.pop('trainer_cli_resume')
  m2 = ts2.optimizer.state[next(ts2.model.parameters())]
  # Adam's moments continued: m2 = b1 m1 + (1 - b1) g and
  # v2 = b2 v1 + (1 - b2) g^2 for the one gradient g of step 3
  g = (m2['exp_avg'] - 0.9 * m1['exp_avg']) / 0.1
  v_want = 0.999 * m1['exp_avg_sq'] + 0.001 * g * g
  v_err = float((m2['exp_avg_sq'] - v_want).norm() /
                m2['exp_avg_sq'].norm())
  print(f'[cli] resume: step {ts1.step} -> {ts2.step}, Adam step '
        f'{float(m1["step"]):.0f} -> {float(m2["step"]):.0f}; second moment '
        f'of {tuple(p0.shape)} against its continuation: relative error '
        f'{v_err:.3g} (tolerance 1e-3)', flush=True)
  check(ts2.step == 3 and float(m2['step']) == 3.0,
        'the resumed trainer did not continue at step 3')
  check(v_err <= 1e-3, 'the resumed Adam moments do not continue the '
        'first run\'s')
  # ---- restore the checkpoint into the predictor
  pred = GoalE2EVMCPredictor(model_dir, device='cuda')
  check(all(torch.equal(a, b) for a, b in zip(
      pred.model.state_dict().values(), ts2.model.state_dict().values())),
      'the predictor\'s weights differ from the trainer\'s')
  K, S = pred.cfg.window_size, pred.cfg.img_height
  rng = np.random.RandomState(0)
  frames = rng.rand(K, S, S, 3).astype(np.float32)
  jnt = rng.randn(K, 7).astype(np.float32)
  tgt = rng.rand(S, S, 3).astype(np.float32)
  pred.set_goal(tgt)
  for k in range(K):
    res = pred.predict(frames[k], jnt[k])
  as_t = lambda a: torch.as_tensor(a, device='cuda')[None]
  with torch.no_grad():
    ref, _ = ts2.model(as_t(frames), as_t(jnt), as_t(tgt), None, True)
  rel = max(float(np.abs(res[k] - ref[h][0].float().cpu().numpy()).max() /
                  max(float(ref[h].abs().max()), 1e-12))
            for k, h in (('cmd_ee', 'pred_cmd_ee'), ('pos_ee', 'pred_aux_ee'),
                         ('pos_obj', 'pred_aux_obj')))
  print(f'[cli] predictor: weights equal to the trainer\'s bit for bit; '
        f'predict on one window against the trainer model\'s forward: '
        f'{rel:.3g} of the largest |value| (tolerance {BF16_REL:g})',
        flush=True)
  check(rel <= BF16_REL, 'the predictor disagrees with the trainer model')
  del pred, ts1, ts2
  # ---- the batched controller on the test split
  ctrl_dir = os.path.join(work, 'controller')
  n_test = len(split['test'])
  run('controller', 'controller', gym_pickplace, [
      '--wrk_dir', ctrl_dir, '--sim_mode', 'controller',
      '--goal_condition', 'target', '--model_dir', model_dir,
      '--dataset_dir', ds, '--split_name', 'balanced',
      '--num_envs', str(CLI_CTRL_ENVS), '--max_episode_steps',
      str(CLI_CL_STEPS)])
  chunks = -(-n_test // CLI_CTRL_ENVS)
  launches['controller_goal'] = goal_launches[0]
  launches['controller_loop'] = launches.pop('controller') - goal_launches[0]
  check(launches['controller_goal'] == -(-n_test // 64) and
        launches['controller_loop'] == chunks * CLI_CL_STEPS,
        f'controller: {launches["controller_goal"]} goal-frame and '
        f'{launches["controller_loop"]} closed-loop raster launches, '
        f'expected {-(-n_test // 64)} and {chunks * CLI_CL_STEPS}')
  rates['controller_env_steps_per_s'] = (
      chunks * CLI_CTRL_ENVS * CLI_CL_STEPS / sum(spans['closed_loop']))
  out_dir = os.path.join(ctrl_dir, 'controller')
  header, rows = _rows(os.path.join(out_dir, 'eval_results.csv'))
  check(tuple(header) == sim.EVAL_FIELDS and len(rows) == n_test,
        f'eval_results.csv: header {header}, {len(rows)} rows for {n_test} '
        'test episodes')
  header, rows = _rows(os.path.join(out_dir, 'triage_results.csv'))
  check(tuple(header) == sim.TRIAGE_FIELDS and len(rows) == n_test,
        f'triage_results.csv: {len(rows)} rows')
  with open(os.path.join(out_dir, 'final_results.txt')) as f:
    final = f.read().split('\n')
  check([l.split('\t')[0] for l in final if l] ==
        ['obj_vicinity', 'grasp_success', 'task_success'],
        f'final_results.txt: {final}')
  check(os.path.isfile(os.path.join(out_dir, 'triage_summary.txt')),
        'no triage_summary.txt')


def bound(nbytes: float, ops: float):
  """The least time the card could take: (ms, 'bytes' or 'operations')."""
  t_bytes, t_ops = nbytes / HBM_RATE, ops / FP32_RATE
  return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                     else 'operations')


def within(got, ref, rtol, atol, label):
  """Check |got - ref| <= atol + rtol |ref| everywhere; (max_abs, max_rel)."""
  diff = (got - ref).abs()
  bad = int((diff > atol + rtol * ref.abs()).sum())
  big = ref.abs() > atol
  max_rel = float((diff[big] / ref.abs()[big]).max()) if bool(big.any()) \
      else 0.0
  print(f'[{label}] max_abs_err {float(diff.max()):.6g}, max_rel_err '
        f'{max_rel:.6g} (|ref| > {atol:g}), {bad} of {diff.numel()} outside '
        f'rtol={rtol:g} atol={atol:g}', flush=True)
  check(bad == 0, f'{label}: {bad} values outside the tolerance')
  return float(diff.max()), max_rel


def replay(env, label, steps=None, fixture=FIXTURE, moved_limit=None):
  """The recorded MuJoCo pick episode through reset_to + step at B=1: task
  success and the task object within DRIFT_LIMIT.  With `steps`, only that
  many control steps of it, held to the drift limits alone (success shows
  at the episode's end).  With `moved_limit`, the other objects too: those
  the MuJoCo trace shows moving (more than 5 mm) within it, the rest
  within STATIC_LIMIT.  Returns the task object's drift (m)."""
  from geeco_tpu_torch.envs.base import ResetSpec
  fx = np.load(fixture)
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
  cmds = fx['cmds'][:steps]
  for cmd in cmds:
    es = env.step(es, torch.as_tensor(cmd)[None])
    trace.append(torch.stack([es.phys.qpos[0, a:a + 3] for a in adrs]))
  trace = torch.stack(trace).cpu().numpy()
  m = {k: float(v[0]) for k, v in env.eval_metrics(es).items()}
  drift = np.linalg.norm(trace - fx['obj_pos_trace'][:len(cmds)],
                         axis=-1).max(axis=0)
  print(f'[{label}] {len(cmds)} of {len(fx["cmds"])} steps replayed in '
        f'{time.perf_counter() - t0:.1f} s (beside the other processes; '
        f'[t={time.perf_counter() - T_START:.0f} s]): '
        f'task_success {m["task_success"]}, goal_dist {m["goal_dist"]:.4f} '
        f'(MuJoCo {float(fx["final_goal_dist"]):.4f}), task-object drift '
        f'{drift[0] * 1000:.2f} mm', flush=True)
  check(bool(np.isfinite(trace).all()), f'{label}: non-finite replay trace')
  check(len(cmds) < len(fx['cmds']) or m['task_success'] == 1.0,
        f'{label}: the replayed pick did not succeed')
  check(drift[0] < DRIFT_LIMIT, f'{label}: task-object drift '
        f'{drift[0]:.4f} m >= {DRIFT_LIMIT} m')
  if moved_limit is not None:
    mj = fx['obj_pos_trace'][:len(cmds)]
    moved = np.linalg.norm(mj - mj[:1], axis=-1).max(axis=0) > 0.005
    moved[0] = False                      # the task object, held above
    static = ~moved
    static[0] = False
    print(f'[{label}] drift per object (mm): ' + ', '.join(
        f'{str(j).split(":")[0]} {d * 1000:.2f}'
        f'{" (moved)" if mv else ""}' for j, d, mv in
        zip(fx['obj_joint_names'], drift, moved)), flush=True)
    worst_moved = float(drift[moved].max(initial=0.0))
    worst_static = float(drift[static].max(initial=0.0))
    check(worst_moved < moved_limit, f'{label}: a moved object drifted '
          f'{worst_moved:.4f} m >= {moved_limit} m')
    check(worst_static < STATIC_LIMIT, f'{label}: a static object drifted '
          f'{worst_static:.4f} m >= {STATIC_LIMIT} m')
  return float(drift[0])


def scene_replay(which):
  """Phase 13's replays (``--replay-only nutcone|clutter4``): the MuJoCo
  fixture through the scene's production env (nut-cone: psd_block with
  quota selection; clutter4: psd with the top-192) at B=1, counting the
  calls of solve by method (on the card a chain's warm-up and capture
  call it; its replays run what was captured)."""
  from geeco_tpu_torch.envs.base import make_env
  from geeco_tpu_torch.physics import solver as S
  shapes, fixture, moved_limit = REPLAYS[which]
  env = make_env(shapes, device='cuda')
  solves = {}
  solve = S.solve

  def counted(*a, method='psd', **k):
    solves[method] = solves.get(method, 0) + 1
    return solve(*a, method=method, **k)
  S.solve = counted
  try:
    replay(env, f'fidelity:{which}', steps=REPLAY_STEPS[which],
           fixture=os.path.join(ROOT, 'tests', 'fixtures', fixture),
           moved_limit=moved_limit)
  finally:
    S.solve = solve
  print(f'[fidelity:{which}] {shapes}: solver {env.solver_method}, '
        f'{"quota" if env.stepper.cs.quota_sel else "top-K"} selection of '
        f'K={env.stepper.cs.ncon_sel}; solves by method {solves}',
        flush=True)
  check(solves.get(env.solver_method, 0) > 0 and len(solves) == 1,
        f'{which}: the replay ran solves {solves}, expected '
        f'{env.solver_method} only')


def scenes_phase(card):
  """Phase 13's other scenes (``--scenes-only``): SCENE_ENVS envs (ball-cup:
  ENVS) of each of SCENES_ONLY on its production env (settle steps cut to
  SCENE_SETTLE),
  one reset_random, one control step and a render: a finite state, the
  objects above the floor, the raster kernel against its twin on the
  render, the peak device memory.  Writes the launches, the kernel's
  max_abs_err and the peaks to SCENES_SUMMARY."""
  from geeco_tpu_torch.envs.base import make_env
  from geeco_tpu_torch.render import raster_kernel as rk
  dev = torch.device('cuda')
  out = {'launches': {}, 'max_abs_err': 0.0, 'peak_gib': {}}
  for shapes in SCENES_ONLY:
    B = SCENE_BATCH.get(shapes, SCENE_ENVS)
    action = torch.tensor([0.2, -0.1, -0.3, 1.0], device=dev).expand(B, 4)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    env = make_env(shapes, device='cuda', settle_steps=SCENE_SETTLE)
    es = env.reset_random(B, torch.Generator(device=dev).manual_seed(3))
    rk.raster_tiles.launches = 0
    with checked_raster(rk, shapes) as chk:
      es = env.step(es, action)
      rgb, depth = env.render(es)
    torch.cuda.synchronize()
    launches = rk.raster_tiles.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = env.model
    z = torch.stack([es.phys.qpos[:, m.jnt_qposadr[m.joint(j)] + 2]
                     for j in env.obj_joint_names], -1)
    print(f'[scenes] {shapes}: {env.solver_method}, K='
          f'{env.stepper.cs.ncon_sel} of {env.stepper.cs.ncon} candidates, '
          f'B={B}: set-up, reset, a control step and a render in '
          f'{time.perf_counter() - t0:.1f} s; object heights '
          f'{float(z.min()):.4f}..{float(z.max()):.4f} m; raster launches '
          f'{launches}; peak device memory {peak:.2f} GiB on {card}',
          flush=True)
    check(bool(torch.isfinite(es.phys.qpos).all() and
               torch.isfinite(es.phys.qvel).all()),
          f'{shapes}: non-finite state')
    check(bool(((z > 0.2) & (z < 0.4)).all()),
          f'{shapes}: an object is not above the table')
    check(rgb.shape == (B, 256, 256, 3) and
          bool(torch.isfinite(depth).all()), f'{shapes}: bad frame')
    check(launches == 1, f'{shapes}: {launches} raster launches for one '
          'render')
    out['launches'][shapes] = launches
    out['max_abs_err'] = max(out['max_abs_err'], chk['err'])
    out['peak_gib'][shapes] = peak
    del env, es, rgb, depth
    torch.cuda.empty_cache()
  with open(SCENES_SUMMARY, 'w') as f:
    json.dump(out, f)


def capture_solve(env, es, SP):
  """The fused-solve operands of one substep of env from es."""
  with SP.capture() as calls:
    env.stepper.substep(es.phys, env.solver_iterations, 'pallas')
  check(len(calls) == 1, f'{len(calls)} fused solves in one substep')
  return calls[0]


def twin_substep(env, phys, SP):
  """One substep of env from phys with the PSD kernel's plain twin in its
  place: eager, since an open SP.capture() block keeps the substep off its
  chain of CUDA graphs, whose replay would run the kernel captured."""
  real = SP.psd_solve
  SP.psd_solve = SP.psd_solve_reference
  try:
    with SP.capture():
      return env.stepper.substep(phys, env.solver_iterations, 'pallas')
  finally:
    SP.psd_solve = real


def psd_kernels(fn, want: int) -> int:
  """The PSD kernels fn() runs on the card, counted in a device trace (which
  holds each kernel of a CUDA graph's replay; SP.psd_solve.launches counts
  only the wrapper's calls).  A trace now and then loses records (152 of a
  replayed control step's 54,431 device events in 1 of 10 traces, torch
  2.11 on the H100), which lowers a count and never raises it: the count
  is the largest of up to three traces of fn(), stopping at ``want``."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  best = -1
  for _ in range(3):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    best = max(best, sum(e.device_type() == DeviceType.CUDA and
                         'psd_solve_kernel' in e.name()
                         for e in prof.profiler.kineto_results.events()))
    if best == want:
      break
  return best


def reordered(ops, gen=None):
  """The same solve with its contacts, limit rows and dofs in a random
  order (with no `gen`, only the dofs, reversed): the same float32 math,
  its sums taken in another order.  Returns the operands and the row order
  (forces[:, rows] = solve(operands))."""
  B, nI, nv = ops['J'].shape
  K, nlim, dev = ops['K'], ops['nlim'], ops['J'].device
  if gen is None:
    pk = torch.arange(K, device=dev)
    pl = torch.arange(2 * nlim, device=dev)
    pv = torch.arange(nv - 1, -1, -1, device=dev)
  else:
    pk = torch.randperm(K, generator=gen, device=dev)
    pl = torch.randperm(2 * nlim, generator=gen, device=dev)
    pv = torch.randperm(nv, generator=gen, device=dev)
  rows = torch.cat([pk + g * K for g in range(4)] + [
      4 * K + pl, torch.arange(4 * K + 2 * nlim, nI, device=dev)])
  out = dict(ops, J=ops['J'][:, rows][:, :, pv], X=ops['X'][:, pv][:, :, rows],
             A_IE=ops['A_IE'][:, rows], mu_t=ops['mu_t'][:, pk],
             mu_tor=ops['mu_tor'][:, pk], con_act=ops['con_act'][:, pk],
             lim_act=ops['lim_act'][:, pl],
             **{k: ops[k][:, rows] for k in ('R', 'b', 'precond', 'f0')})
  return {k: v.contiguous() if isinstance(v, torch.Tensor) else v
          for k, v in out.items()}, rows


def rounding_witness(ops, SP, gen, orders=4):
  """The kernel, the twin, and the twin with its sums in `orders` other
  orders (the dofs reversed, then random orders), each against the float64
  twin on the same operands, env by env.

  Where the solve amplifies float32 rounding, every float32 solve is far
  from the float64 one.  A kernel that computes the twin's function is one
  more summation order: per env, its rank by distance among the float32
  solves is spread evenly, and it is not far beyond all of them.  A fault
  puts it last in most envs.  Returns a summary, printed."""
  f64 = SP.psd_solve_reference(**{
      k: v.double() if isinstance(v, torch.Tensor) else v
      for k, v in ops.items()})
  f_t = SP.psd_solve_reference(**ops)
  solves = [SP.psd_solve(**ops), f_t]
  for i in range(orders):
    o, rows = reordered(ops, gen if i else None)
    f = torch.empty_like(f_t)
    f[:, rows] = SP.psd_solve_reference(**o)
    solves.append(f)
  tol = lambda f, ref: ((f - ref).abs() > FORCE_TOL['atol'] +
                        FORCE_TOL['rtol'] * ref.abs()).any(1)
  # [n_solves, B]: max abs distance from float64; outside FORCE_TOL of it
  D = torch.stack([(f.double() - f64).abs().amax(1) for f in solves])
  out64 = torch.stack([tol(f.double(), f64) for f in solves]).sum(1)
  per_order = torch.stack([(f - f_t).abs().amax(1) for f in solves[2:]])
  spread = per_order.amax(0)
  k_vs_t = (solves[0] - f_t).abs().amax(1)
  beyond = lambda d: (k_vs_t > 2 * d) & (k_vs_t > FORCE_TOL['atol'])
  rank = (D[1:] < D[0]).sum(0)          # 0: the kernel is the closest
  s = {
      'max_abs_vs_f64': [float(d.max()) for d in D],
      'median_env_vs_f64': [float(d.median()) for d in D],
      'envs_outside_tol_vs_f64': [int(n) for n in out64],
      'kernel_rank_hist': torch.bincount(rank, minlength=len(solves))
                               .tolist(),
      'envs_kernel_gt_2x_every_f32': int(
          ((D[0] > 2 * D[1:].amax(0)) & (D[0] > FORCE_TOL['atol'])).sum()),
      'envs_kernel_vs_twin_outside_tol': int(tol(solves[0], f_t).sum()),
      'envs_kernel_vs_twin_gt_2x_spread': int(beyond(spread).sum()),
      'max_ratio_kernel_vs_twin_over_spread': float(
          (k_vs_t / spread.clamp(min=1e-12)).max()),
      'envs_kernel_vs_twin_gt_2x_each_order': [
          int(beyond(d).sum()) for d in per_order],
      'max_ratio_kernel_vs_twin_over_each_order': [
          float((k_vs_t / d.clamp(min=1e-12)).max()) for d in per_order],
  }
  print(f'[psd:reset] solves: kernel, twin, twin in {orders} other orders; '
        f'per-env distance from the float64 twin (max, median env), envs '
        f'outside rtol={FORCE_TOL["rtol"]:g} atol={FORCE_TOL["atol"]:g} of '
        f'it: {s["max_abs_vs_f64"]}, {s["median_env_vs_f64"]}, '
        f'{s["envs_outside_tol_vs_f64"]} of {ops["J"].shape[0]}', flush=True)
  print(f'[psd:reset] kernel rank among the {len(solves)} float32 solves '
        f'(0 = closest to float64), histogram over envs: '
        f'{s["kernel_rank_hist"]}; envs where the kernel is > 2x farther than '
        f'every other: {s["envs_kernel_gt_2x_every_f32"]}; kernel vs twin: '
        f'{s["envs_kernel_vs_twin_outside_tol"]} envs outside the tolerance, '
        f'{s["envs_kernel_vs_twin_gt_2x_spread"]} beyond 2x the twin\'s own '
        f'spread over orders (largest ratio '
        f'{s["max_ratio_kernel_vs_twin_over_spread"]:.3g}); beyond 2x one '
        f'order\'s distance from the twin, order by order: '
        f'{s["envs_kernel_vs_twin_gt_2x_each_order"]} envs (largest ratios '
        f'{[round(r, 3) for r in s["max_ratio_kernel_vs_twin_over_each_order"]]})',
        flush=True)
  return s


def random_psd_operands(B, K, nlim, nv, nE, gen):
  """Random well-posed operands of the fused PSD solve on the card."""
  dev = gen.device
  nI = 4 * K + 2 * nlim
  r = lambda *s: torch.randn(*s, generator=gen, device=dev)
  u = lambda *s: torch.rand(*s, generator=gen, device=dev)
  J = r(B, nI, nv) / nv ** 0.5
  A = r(B, nv, nv) / nv ** 0.5
  M = torch.eye(nv, device=dev) + A @ A.transpose(1, 2)
  X = torch.linalg.solve(M, J.transpose(1, 2)).contiguous()
  R = 0.1 + u(B, nI)
  if nE:
    JE = r(B, nE, nv) / nv ** 0.5
    XE = torch.linalg.solve(M, JE.transpose(1, 2))
    AIE = (J @ XE).contiguous()
    EEinv = torch.linalg.inv(JE @ XE + torch.diag_embed(
        0.1 + u(B, nE))).contiguous()
  else:
    AIE = J.new_zeros((B, nI, 0))
    EEinv = J.new_zeros((B, 0, 0))
  diag = (J * X.transpose(1, 2)).sum(-1) + R
  return dict(J=J, X=X, A_IE=AIE, EEinv=EEinv, R=R, b=r(B, nI),
              precond=1.0 / diag, f0=r(B, nI), mu_t=0.5 + 0.5 * u(B, K),
              mu_tor=0.005 + 0.01 * u(B, K),
              con_act=(u(B, K) > 0.3).float(),
              lim_act=(u(B, 2 * nlim) > 0.5).float(), K=K, nlim=nlim,
              iterations=60)


def psd_work(ops):
  """(bytes, operations) of one fused PSD solve: each operand read once and
  the forces written once; per iteration two operator applications (u, w,
  z, the rows), g, d, the two dot products, the update and the
  projection."""
  B, nI, nv = ops['J'].shape
  nE, K, nlim = ops['A_IE'].shape[2], ops['K'], ops['nlim']
  nbytes = 4 * (sum(t.numel() for t in ops.values()
                    if isinstance(t, torch.Tensor)) + B * nI)
  op = 4 * (nv + nE) * nI + 2 * nE * nE + 3 * nI
  per_iter = 2 * op + 8 * nI + 18 * K + 4 * nlim
  return nbytes, float(B) * ops['iterations'] * per_iter


def psd_phases(card):
  """--psd-phases: the cycles thread 0 spends in each phase of one
  iteration of the PSD kernel, per cluster size, at the pad2-cube2 shapes
  (B=64, random operands).  Builds csrc/psd_solve.cu once more with
  -DPSD_PROFILE, which makes the kernel write its counts instead of the
  forces."""
  import ctypes
  from geeco_tpu_torch.physics import solver_pallas as SP
  from geeco_tpu_torch.utils import build
  gen = torch.Generator(device='cuda').manual_seed(0)
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
    lib.psd_solve_f32.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros((ENVS, 530), device='cuda')
    for _ in range(2):
      err = lib.psd_solve_f32(
          *(ctypes.c_void_p(ops[k].data_ptr()) for k in order),
          ctypes.c_void_p(out.data_ptr()), ENVS, ops['iterations'],
          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
      check(err == 0, f'profile launch failed: {err}')
      torch.cuda.synchronize()
    cyc = (out[0, :len(names)] / ops['iterations']).tolist()
    print(f'[psd:phases] {spec}, cycles per iteration, thread 0 of block 0, '
          f'B={ENVS}: ' + ', '.join(
              f'{n} {c:.0f}' for n, c in zip(names, cyc)) +
          f'; sum {sum(cyc):.0f} on {card}', flush=True)


def check_sides(rk, sky, gen):
  """K1 against its twin, bit for bit, on random planes at every class of
  band plan (RANDOM_SIDES)."""
  from geeco_tpu_torch.render import rasterizer as R
  B_, n_, K_ = RANDOM_SIDES_SHAPE
  for tile in RANDOM_SIDES:
    planes = R._coeff_planes(random_planes(B_, n_, K_, tile, gen), tile, 2)
    iz_k, c_k = rk.raster_tiles(planes, tile, sky)
    iz_r, c_r = rk.raster_tiles_reference(planes, tile, sky)
    torch.cuda.synchronize()
    n_diff = int(((iz_k != iz_r) | (c_k != c_r)).sum())
    print(f'[raster:sides] tile {tile}, plan {rk.subtile_plan(tile)} (band '
          f'w, h, bands), coeffs {tuple(planes.shape)}: {n_diff} of '
          f'{iz_k.numel()} pixels differ from the twin', flush=True)
    check(n_diff == 0, f'K1 at tile {tile} is not bit-equal to its twin on '
          'random planes')


def raster_phases(card):
  """--raster-phases: K1's time and how its warps share the SMs, on slice
  1's reset state at B=64 rendered at tiles 8, 16, 32 (256x256) and 10
  (320x320).  Times each launch as phase 14b does (``time_raster``), then
  builds csrc/raster_tiles.cu once more with -DRASTER_PROFILE, whose lane
  0 of every warp records its SM and its start and end on the SM's clock.
  Per SM: its span (first start to last end), the warps resident over it
  and its tail (the cycles after its last warp started); per warp: its
  life, beside the slots its band keeps (``raster_kernel.live_slots``)."""
  import ctypes
  from geeco_tpu_torch.core import mjcf
  from geeco_tpu_torch.envs.base import ASSET_ROOT, MODEL_XML, make_env
  from geeco_tpu_torch.render import raster_kernel as rk
  from geeco_tpu_torch.render import rasterizer as R
  from geeco_tpu_torch.utils import build
  so, args = build.raster_library(('RASTER_PROFILE=1',))
  build.build_all([build.raster_library(), (so, args)])
  for line in build.last_build_log.splitlines():
    if line.startswith('$'):
      line = ' '.join(a for a in line.split()
                      if a.startswith('-D') or a.endswith('.cu'))
    if '.cu' in line or 'registers' in line or 'spill' in line:
      print(f'[raster:phases] {line.strip()}', flush=True)
  lib = ctypes.CDLL(so)
  vp, ci = ctypes.c_void_p, ctypes.c_int
  lib.raster_tiles_f32.argtypes = [vp, vp, vp] + [ci] * 6 + [
      ctypes.c_float, vp]
  lib.raster_profile_read.argtypes = [vp, ci]
  env = make_env('pad2-cube2', device='cuda')
  env.setup()
  es = env.reset_random(ENVS, torch.Generator(device='cuda').manual_seed(1))
  am = mjcf.load_model(os.path.join(ASSET_ROOT, 'envs',
                                    MODEL_XML['pad2-cube2']))
  kin = env.kin(es)
  sky = R._pack_sky((0.45, 0.86, 0.57))
  check_sides(rk, sky, torch.Generator(device='cuda').manual_seed(0))
  for tile, res in ((8, 256), (16, 256), (32, 256), (10, 320)):
    r = _option_renderer(env, am, tile=tile, width=res, height=res)
    with captured_raster(rk) as seen:
      r.render(kin, es.rgba)
    coeffs = seen[0][0]
    iz_r, c_r = rk.raster_tiles_reference(coeffs, tile, sky)
    iz, c = rk.raster_tiles(coeffs, tile, sky)
    check(torch.equal(iz, iz_r) and torch.equal(c, c_r),
          f'K1 is not bit-equal to the twin at tile {tile}')
    time_raster(coeffs, tile, sky, rk, card, f'phases tile {tile}')
    plan = rk.subtile_plan(tile)
    B, n_tiles, _, K = coeffs.shape
    warps = B * n_tiles * plan[2]
    iz.fill_(float('nan'))
    c.fill_(float('nan'))
    for _ in range(2):
      err = lib.raster_tiles_f32(
          ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_void_p(iz.data_ptr()),
          ctypes.c_void_p(c.data_ptr()), B * n_tiles, K, tile, *plan,
          ctypes.c_float(sky),
          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
      check(err == 0, f'profile launch failed: {err}')
      torch.cuda.synchronize()
    rec = np.zeros((warps, 3), dtype=np.uint32)
    check(lib.raster_profile_read(rec.ctypes.data, warps) == 0,
          'raster_profile_read failed')
    check(torch.equal(iz, iz_r) and torch.equal(c, c_r),
          f'the profile build is not bit-equal to the twin at tile {tile}')
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
    print(f'[raster:phases] tile {tile} at {res}x{res}, plan {plan} (band '
          f'w, h, bands), {warps} warps on {len(spans)} SMs, B={B}, K={K}: '
          f'SM span (cycles) {pct(spans)}; warps resident over the span '
          f'{pct(resident)}; tail after the SM\'s last warp start '
          f'{pct(tails)} ({tails.sum() / spans.sum():.3f} of the spans); '
          f'warp life {pct(life)}; slots kept a warp {pct(kept)}; the 1% of '
          f'warps that keep most: life {life[heavy].mean():.0f}, on {card}',
          flush=True)


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


def k2_scene_checks(SP, dev):
  """Phase 13, untimed: the PSD kernel on clutter4's and nut-cone's real
  operands.  Each scene's env at rolling=False, solver_method='pallas'
  (ngrp=4, nut-cone's K the sum of its quotas), ENVS envs one control step
  past reset_random; the kernel against its twin on one substep's
  operands, and the substep through each.  Returns {scene: (env, state,
  operands, max_abs_err)}."""
  from geeco_tpu_torch.envs.base import make_env
  out = {}
  for shapes in TIMED_SCENES:
    t0 = time.perf_counter()
    env = make_env(shapes, device='cuda', rolling=False,
                   solver_method='pallas', settle_steps=SCENE_SETTLE)
    check(env.stepper.cs.ngrp == 4, f'{shapes}: ngrp '
          f'{env.stepper.cs.ngrp} at rolling=False')
    es = env.reset_random(ENVS, torch.Generator(device=dev).manual_seed(4))
    es = env.step(es, torch.zeros(ENVS, 4, device=dev))
    ops = capture_solve(env, es, SP)
    lay = SP.plan(*ops['J'].shape, ops['A_IE'].shape[2], ops['K'])
    print(f'[psd:{shapes}] operands of one substep: B={ops["J"].shape[0]}, '
          f'nI={ops["J"].shape[1]}, nv={ops["J"].shape[2]}, nE='
          f'{ops["A_IE"].shape[2]}, K={ops["K"]}, nlim={ops["nlim"]}; plan '
          f'{lay}; set up in {time.perf_counter() - t0:.1f} s (beside the '
          'replay processes)', flush=True)
    f_k = SP.psd_solve(**ops)
    check(bool(torch.isfinite(f_k).all()), f'{shapes}: PSD forces not '
          'finite')
    err, _ = within(f_k, SP.psd_solve_reference(**ops),
                    label=f'psd:{shapes} forces', **FORCE_TOL)
    sub_k = env.stepper.substep(es.phys, env.solver_iterations, 'pallas')
    sub_r = twin_substep(env, es.phys, SP)
    within(sub_k.qvel, sub_r.qvel, label=f'psd:{shapes} substep qvel',
           **QVEL_TOL)
    out[shapes] = (env, es, ops, err)
  return out


def scene_envs_setup(rk, dev):
  """Phase 13, untimed: clutter4 and nut-cone on their production envs at
  ENVS envs, reset_random, the first render held against the twin.
  Returns ({scene: (env, state)}, the kernel's max_abs_err)."""
  from geeco_tpu_torch.envs.base import make_env
  out, err = {}, 0.0
  for shapes in TIMED_SCENES:
    t0 = time.perf_counter()
    env = make_env(shapes, device='cuda', settle_steps=SCENE_SETTLE)
    es = env.reset_random(ENVS, torch.Generator(device=dev).manual_seed(5))
    with checked_raster(rk, shapes) as chk:
      env.render(es)
    err = max(err, chk['err'])
    print(f'[scenes] {shapes}: {env.solver_method}, '
          f'{"quota" if env.stepper.cs.quota_sel else "top-K"} selection of '
          f'K={env.stepper.cs.ncon_sel}, set up and reset at B={ENVS} in '
          f'{time.perf_counter() - t0:.1f} s (beside the replay processes)',
          flush=True)
    out[shapes] = (env, es)
  return out, err


def write_background_gif(path):
  """A 12-frame GIF of moving colour bands, written with Pillow."""
  from PIL import Image
  os.makedirs(os.path.dirname(path), exist_ok=True)
  yy, xx = np.mgrid[0:48, 0:64]
  frames = []
  for i in range(12):
    band = ((xx + 4 * i) // 8 + yy // 12) % 3
    img = np.zeros((48, 64, 3), np.uint8)
    img[..., 0] = np.where(band == 0, 230, 20)
    img[..., 1] = np.where(band == 1, 200, 30 + 15 * i)
    img[..., 2] = np.where(band == 2, 240, 10)
    frames.append(Image.fromarray(img))
  frames[0].save(path, save_all=True, append_images=frames[1:])


def textured_render(env, es, rk, card):
  """Phase 13, untimed: slice 1's frames with a background frame per env
  from a VideoCycler over a GIF: one raster launch, held against the twin;
  every env's wall changes and the table front does not.  Returns
  (launches, max_abs_err)."""
  from geeco_tpu_torch.data.videos import VideoCycler
  write_background_gif(BACKGROUND_GIF)
  cycler = VideoCycler(BACKGROUND_GIF)
  frames = cycler.texel_steps(ENVS, env.renderer.scene.tex_res)
  tex = env.background_textures(frames)           # [B, S, R, R, 3]
  plain, _ = env.render(es)
  rk.raster_tiles.launches = 0
  with checked_raster(rk, 'textured') as chk:
    rgb, _ = env.render(es, textures=tex)
  torch.cuda.synchronize()
  launches = rk.raster_tiles.launches
  changed = (plain != rgb).any(-1)                # [B, H, W]
  share = changed.float().mean((1, 2))
  print(f'[textured] B={ENVS}, a background frame per env from a GIF '
        f'through VideoCycler: {launches} raster launch; '
        f'pixels changed per env {float(share.min()):.4f}..'
        f'{float(share.max()):.4f}; bottom 32 rows changed '
        f'{int(changed[:, -32:].sum())} on {card}', flush=True)
  check(launches == 1, f'{launches} raster launches for one render')
  check(bool((share > 0.05).all()), 'a textured frame shows no wall')
  check(not bool(changed[:, -32:].any()), 'the background texture reached '
        'the table front')
  return launches, chk['err']


def time_scenes(scene_envs, rk, SP, card, dev):
  """Phase 13b, alone: SCENE_STEPS control steps of step + render of each
  timed scene at ENVS envs (env-steps/s, the raster launches, a finite
  state, the objects above the floor), then one profiled substep and one
  profiled render (launches per substep, device time per control step).
  Returns the raster launches by scene."""
  out = {}
  action = torch.tensor([0.1, 0.0, -0.2, 1.0], device=dev).expand(ENVS, 4)
  for shapes, (env, es) in scene_envs.items():
    rk.raster_tiles.launches = 0
    SP.psd_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SCENE_STEPS):
      es = env.step(es, action)
      rgb, depth = env.render(es)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out[shapes] = rk.raster_tiles.launches
    m = env.model
    z = torch.stack([es.phys.qpos[:, m.jnt_qposadr[m.joint(j)] + 2]
                     for j in env.obj_joint_names], -1)
    print(f'[scenes] {shapes}: {SCENE_STEPS} control steps (step + render) '
          f'at B={ENVS}: {dt:.3f} s -> {ENVS * SCENE_STEPS / dt:.2f} '
          f'env-steps/s on {card}; raster launches {out[shapes]}, PSD '
          f'kernel launches {SP.psd_solve.launches}; object heights '
          f'{float(z.min()):.4f}..{float(z.max()):.4f} m', flush=True)
    check(out[shapes] == SCENE_STEPS, f'{shapes}: the raster kernel did '
          'not run once per render')
    check(SP.psd_solve.launches == 0, f'{shapes}: the PSD kernel ran on '
          'the production (rolling-row) env')
    check(bool(torch.isfinite(es.phys.qpos).all()) and
          bool(torch.isfinite(depth).all()), f'{shapes}: non-finite state '
          'or frame')
    check(bool(((z > 0.2) & (z < 0.4)).all()),
          f'{shapes}: an object is not above the table')
    # a substep and a render profiled apart: a whole control step is ~20x
    # the events, and the profiler's processing of them outlasts the step
    n, sub_ms, _ = profile_step(
        lambda: env.stepper.substep(es.phys, env.solver_iterations,
                                    env.solver_method, env.hysteresis),
        f'{shapes}, one substep, B={ENVS}', card)
    n_r, render_ms, _ = profile_step(lambda: env.render(es),
                                     f'{shapes}, one render, B={ENVS}', card)
    print(f'[scenes] {shapes}: {n} launches per substep, device time '
          f'{sub_ms:.1f} ms a substep, {render_ms:.1f} ms a render '
          f'({n_r} launches): ~{env.n_substeps * sub_ms + render_ms:.1f} ms '
          f'per control step on {card}', flush=True)
    del rgb, depth
  return out


def time_k2_scenes(k2_scenes, SP, card, dev):
  """Phase 13b, alone: one control step of each pallas scene env (one
  PSD-kernel launch per substep), then the kernel's time on the captured
  operands against its twin and its bound.  Returns (launches by path,
  times by shape)."""
  paths, shapes_out = {}, {}
  zeros = torch.zeros(ENVS, 4, device=dev)
  for shapes, (env, es, ops, _) in k2_scenes.items():
    es = env.step(es, zeros)           # its chains captured
    paths[f'{shapes} pallas'] = psd_kernels(lambda: env.step(es, zeros),
                                            env.n_substeps)
    check(paths[f'{shapes} pallas'] == env.n_substeps,
          f'{shapes}: {paths[f"{shapes} pallas"]} PSD kernels in the device '
          f'trace of a control step of {env.n_substeps} substeps')
    ms = cuda_ms(lambda: SP.psd_solve(**ops), 30, queued=True)
    plain_ms = cuda_ms(lambda: SP.psd_solve_reference(**ops), 3)
    bnd = bound(*psd_work(ops))
    lay = SP.plan(*ops['J'].shape, ops['A_IE'].shape[2], ops['K'])
    print(f'[psd:{shapes}] kernel {ms:.4f} ms ({lay}), plain twin '
          f'{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}; '
          f'{paths[f"{shapes} pallas"]} launches in a control step on '
          f'{card}', flush=True)
    check(ms >= bnd[0], f'{shapes}: PSD kernel time under its bound')
    shapes_out[shapes] = {
        'nI': ops['J'].shape[1], 'nv': ops['J'].shape[2], 'K': ops['K'],
        'cluster': lay['cluster'], 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bnd[0], 'bound_by': bnd[1]}
  return paths, shapes_out


def _option_renderer(env, assets_model, **options):
  """A renderer of slice 1's scene with ``options`` (compiled from the
  model on the CPU, then on the card's model, as GeecoEnv builds its)."""
  from geeco_tpu_torch.render import rasterizer as R
  m, assets = assets_model
  return R.build_renderer(m, assets, **options).replace(model=env.model)


def _cpu_frame(assets_model, kin, rgba, textures=None, **options):
  """Env 0's frame through the port on the CPU with ``options``."""
  from geeco_tpu_torch.render import rasterizer as R
  m, assets = assets_model
  kin0 = kin.replace(**{f.name: getattr(kin, f.name)[:1].cpu()
                        for f in dataclasses.fields(kin)})
  tex = None if textures is None else textures[:1].cpu()
  return R.build_renderer(m, assets, **options).render(
      kin0, rgba[:1].cpu(), tex)


def _frame_vs_cpu(rgb, depth, ref, label):
  """Env 0 of a card frame against the CPU port's frame: the share of
  pixels that differ within CPU_FRAME_TOL, depth on the others within
  1e-4."""
  rgb_c, depth_c = ref
  mism = (rgb_c[0] != rgb[0].cpu()).any(-1)
  diff = float(mism.float().mean())
  derr = float((depth_c[0] - depth[0].cpu())[~mism].abs().max())
  print(f'[options] {label}: env 0, card vs CPU port: {diff:.5f} of pixels '
        f'differ (tolerance {CPU_FRAME_TOL:g}), depth max_abs_err {derr:.3g} '
        'on the others', flush=True)
  check(diff <= CPU_FRAME_TOL, f'{label}: card frame disagrees with the CPU')
  check(derr <= 1e-4 + 1e-4 * float(depth_c.abs().max()),
        f'{label}: card depth disagrees with the CPU')


@contextlib.contextmanager
def captured_raster(rk):
  """Inside the block, every raster launch's (coeffs, tile, sky, output)
  is kept (the launch itself is the path's: the counts stay its)."""
  launch = rk.raster_tiles
  seen = []

  def capture(coeffs, tile, sky):
    out = launch(coeffs, tile, sky)
    seen.append((coeffs, tile, sky, out))
    return out

  capture.launches = launch.launches
  rk.raster_tiles = capture
  try:
    yield seen
  finally:
    rk.raster_tiles = launch
    launch.launches = capture.launches


def option_phase(env, es, rk, card, dev):
  """Phase 14, untimed (beside the replay processes): the renderer's
  options, the block Gauss-Jordan mass inverse, a profiled control step
  and the --num_devices check.  Returns (K1 launches of the production
  render, {tile: (coeffs, launches, max_abs_err)} for the timed part, the
  largest max_abs_err of the kernel on the option frames)."""
  from geeco_tpu_torch.core import mjcf
  from geeco_tpu_torch.envs.base import ASSET_ROOT, MODEL_XML, make_env
  from geeco_tpu_torch.render import raster_kernel
  from geeco_tpu_torch.utils import profiling
  t_phase = time.perf_counter()
  am = mjcf.load_model(os.path.join(ASSET_ROOT, 'envs',
                                    MODEL_XML['pad2-cube2']))
  kin = env.kin(es)
  err = 0.0

  # the production render (backend 'auto', 256x256): hierarchical, K1 once
  before = dict(env.renderer.path_counts)
  rk.raster_tiles.launches = 0
  rgb, depth = env.render(es)
  torch.cuda.synchronize()
  prod_launches = rk.raster_tiles.launches
  took = {k: v - before.get(k, 0) for k, v in env.renderer.path_counts.items()
          if v != before.get(k, 0)}
  print(f'[options] production render (auto, 256x256, B={ENVS}): paths '
        f'{took}, {prod_launches} K1 launch', flush=True)
  check(took == {'hierarchical': 1} and prod_launches == 1,
        'the production render did not take the hierarchical path through '
        'K1')

  # flat binning (backend 'jnp'): plain PyTorch, no K1
  r = _option_renderer(env, am, backend='jnp')
  rk.raster_tiles.launches = 0
  rgb, depth = r.render(kin, es.rgba)
  torch.cuda.synchronize()
  check(rk.raster_tiles.launches == 0 and r.path_counts == {'flat': 1},
        f'backend=jnp: {rk.raster_tiles.launches} K1 launches, paths '
        f'{r.path_counts}')
  _frame_vs_cpu(rgb, depth, _cpu_frame(am, kin, es.rgba, backend='jnp'),
                'flat (jnp)')

  # analytic rects, textured (a background frame per env), shadows on,
  # depth_gl
  from geeco_tpu_torch.data.videos import VideoCycler
  write_background_gif(BACKGROUND_GIF)
  frames = VideoCycler(BACKGROUND_GIF).texel_steps(ENVS,
                                                   env.renderer.scene.tex_res)
  tex = env.background_textures(frames)
  opts = dict(analytic_rects=True, depth_gl=True)
  r = _option_renderer(env, am, **opts)
  with captured_raster(rk) as seen:
    rgb, depth = r.render(kin, es.rgba, tex)
  torch.cuda.synchronize()
  check(r.scene.rect_geom.size > 0 and r.shadows, 'no analytic rects')
  check(bool(torch.isfinite(depth).all()) and float(depth.min()) >= 0.0 and
        float(depth.max()) <= 1.0, 'depth_gl outside [0, 1]')
  check(len(seen) == 1, f'{len(seen)} K1 launches for the rect render')
  _frame_vs_cpu(rgb, depth, _cpu_frame(am, kin, es.rgba, tex, **opts),
                'analytic rects + textures + shadows + depth_gl')

  # K1 at other tile sides: launched once each, bit-equal to its twin
  tiles = {}
  for tile, res in OPTION_TILES:
    r = _option_renderer(env, am, tile=tile, width=res, height=res)
    rk.raster_tiles.launches = 0
    with captured_raster(rk) as seen:
      rgb, depth = r.render(kin, es.rgba)
    torch.cuda.synchronize()
    launches = rk.raster_tiles.launches
    check(launches == 1 and len(seen) == 1 and
          r.path_counts == {'hierarchical': 1},
          f'tile {tile}: {launches} K1 launches, paths {r.path_counts}')
    coeffs, t, sky, (iz_k, c_k) = seen[0]
    iz_r, c_r = rk.raster_tiles_reference(coeffs, t, sky)
    n_diff = int(((iz_k != iz_r) | (c_k != c_r)).sum())
    e = max(float((iz_k - iz_r).abs().max()), float((c_k - c_r).abs().max()))
    path = raster_kernel.kernel_limits(tile)
    print(f'[options] tile {tile} at {res}x{res} (K1 {path} path): coeffs '
          f'{tuple(coeffs.shape)}, {n_diff} pixels differ from the twin, '
          f'max_abs_err {e}', flush=True)
    check(n_diff == 0, f'K1 at tile {tile} is not bit-equal to its twin')
    check(bool(torch.isfinite(depth).all()) and rgb.shape == (ENVS, res,
                                                              res, 3),
          f'tile {tile}: frame {tuple(rgb.shape)} not finite')
    tiles[tile] = (coeffs, launches, e)
    err = max(err, e)

  # the gripper camera (it rides on the gripper link)
  r = _option_renderer(env, am, camera='gripper_camera_rgb')
  rgb, depth = r.render(kin, es.rgba)
  torch.cuda.synchronize()
  check(bool(torch.isfinite(depth).all()), 'gripper camera depth not finite')
  print(f'[options] gripper_camera_rgb: finite, mean depth '
        f'{float(depth.mean()):.3f} m', flush=True)

  # the MuJoCo ray-cast depth of pad2cube2's fixture frames
  # (tests/test_render_golden.py's bounds)
  raycast_check(am, env)

  # mass_inverse='blockgj' against 'chol', from the state a first control
  # step left: a control step at the CPU test's physics (2 substeps of 8
  # PSD iterations) to its tolerance, and at the production physics
  base = torch.tensor([0.1, 0.0, 0.2, 1.0], device=dev).expand(ENVS, 4)
  es1 = env.step(es, base)
  chol_env = make_env('pad2-cube2', device='cuda', **BLOCKGJ_PHYSICS)
  bgj_env = make_env('pad2-cube2', device='cuda', mass_inverse='blockgj',
                     **BLOCKGJ_PHYSICS)
  d = (chol_env.step(es1, base).phys.qpos -
       bgj_env.step(es1, base).phys.qpos).abs().amax(-1)
  print(f"[options] one control step at B={ENVS} (the CPU test's physics), "
        f'blockgj vs chol: qpos max_abs_err per env: median '
        f'{float(d.median()):.3g}, max {float(d.max()):.3g}', flush=True)
  check(bool(torch.isfinite(d).all()) and float(d.max()) <= BLOCKGJ_QPOS_ATOL,
        f'the blockgj control step disagrees with chol: {float(d.max())} > '
        f'{BLOCKGJ_QPOS_ATOL}')
  del chol_env, bgj_env
  bgj_env = make_env('pad2-cube2', device='cuda', mass_inverse='blockgj')
  chol_q = env.step(es1, base).phys.qpos
  d = (chol_q - bgj_env.step(es1, base).phys.qpos).abs().amax(-1)
  w = torch.zeros(ENVS, device=dev)
  for sign in (1, -1):
    pert = es1.replace(phys=es1.phys.replace(
        qvel=es1.phys.qvel * (1 + sign * 1e-7)))
    w = torch.maximum(w, (chol_q - env.step(pert, base).phys.qpos)
                      .abs().amax(-1))
  print(f'[options] one control step at B={ENVS} (production physics), '
        f'blockgj vs chol: qpos max_abs_err per env: median '
        f'{float(d.median()):.3g}, max {float(d.max()):.3g} (env '
        f'{int(d.argmax())}); chol vs chol from qvel * (1 +- 1e-7): median '
        f'{float(w.median()):.3g}, max {float(w.max()):.3g}', flush=True)
  check(bool(torch.isfinite(d).all()) and
        float(d.median()) <= BLOCKGJ_PROD_MEDIAN,
        f'the blockgj control step at the production physics disagrees with '
        f'chol: median {float(d.median())} > {BLOCKGJ_PROD_MEDIAN}')
  del es1, pert, chol_q, bgj_env

  # one control step profiled through utils/profiling.trace (a 2-substep
  # env: a 20-substep step has ~125k events, whose export takes a minute)
  penv = make_env('pad2-cube2', device='cuda', n_substeps=2)
  trace_dir = os.path.join(ROOT, 'build', 'trace')
  shutil.rmtree(trace_dir, ignore_errors=True)
  with profiling.trace(trace_dir):
    penv.step(es, base)
    torch.cuda.synchronize()
  files = os.listdir(trace_dir)
  size = sum(os.path.getsize(os.path.join(trace_dir, f)) for f in files)
  print(f'[options] profiling.trace of a 2-substep control step: {files}, '
        f'{size} bytes', flush=True)
  check(len(files) == 1 and size > 0, 'profiling.trace wrote no trace')
  del penv

  # --num_devices 2 on a machine with one card raises before any rank
  from geeco_tpu_torch.run import gym_pickplace
  n = torch.cuda.device_count() + 1
  try:
    gym_pickplace.main(gym_pickplace.parse([
        '--wrk_dir', os.path.join(ROOT, 'build', 'num_devices'),
        '--sim_mode', 'collect', '--num_envs', str(2 * n),
        '--num_devices', str(n)]))
    fail(f'--num_devices {n} with {n - 1} card(s) did not raise')
  except RuntimeError as e:
    print(f'[options] --num_devices {n}: raised as it should: {e}',
          flush=True)
  print(f'[options] phase 14 took {time.perf_counter() - t_phase:.1f} s '
        '(beside the replay processes)', flush=True)
  return prod_launches, tiles, err


def raycast_check(am, env):
  """The port's depth on the card against the MuJoCo ray-cast fixture of
  pad2cube2 (three frames), for the variants tests/test_render_golden.py
  runs: no sky holes, exact interiors, the > 2 cm and > 10 cm areas and the
  silhouette IoU bounded."""
  from geeco_tpu_torch.core.model import make_state
  golden = np.load(os.path.join(ROOT, 'tests', 'fixtures',
                                'mujoco_raycast_pad2cube2.npz'))
  m = env.model
  n = golden['qpos'].shape[0]
  st = make_state(m, n)
  as_t = lambda k: torch.as_tensor(golden[k], dtype=torch.float32,
                                   device=st.qpos.device)
  st = st.replace(qpos=as_t('qpos'), mocap_pos=as_t('mocap_pos'),
                  mocap_quat=as_t('mocap_quat'))
  kin = env.stepper.fk(st)
  H, W = int(golden['height']), int(golden['width'])
  for variant in ('auto', 'jnp', 'jnp-analytic'):
    backend, _, opt = variant.partition('-')
    r = _option_renderer(env, am, width=W, height=H, backend=backend,
                         analytic_rects=opt == 'analytic')
    _, depth = r.render(kin)
    depth = depth.cpu().numpy()
    worst = []
    for k, (d, g) in enumerate(zip(depth, golden['depth'])):
      err = np.abs(d - g)
      ours, mjs = d < 2.0, g < 2.0
      stats = dict(holes=np.mean((d > 9.9) & (g > 0)),
                   median=np.median(err), frac2cm=np.mean(err > 0.02),
                   frac10cm=np.mean(err > 0.10),
                   iou=(ours & mjs).sum() / max((ours | mjs).sum(), 1))
      worst.append(stats)
      check(stats['holes'] < 1e-3 and stats['median'] < 1e-3 and
            stats['frac2cm'] < 0.07 and stats['frac10cm'] < 0.05 and
            stats['iou'] > 0.965,
            f'MuJoCo ray-cast bounds fail for {variant} frame {k}: {stats}')
    print(f'[options] MuJoCo ray-cast depth, {variant}: '
          + '; '.join(', '.join(f'{k} {v:.4f}' for k, v in w.items())
                      for w in worst), flush=True)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--profile', default='',
                  help='write the torch.profiler tables of one slice-1 '
                  'control step there')
  ap.add_argument('--psd-phases', action='store_true',
                  help='only build the PSD kernel with its phase counters '
                  'and print the cycles of each phase per cluster size')
  ap.add_argument('--raster-phases', action='store_true',
                  help='only time the raster kernel on frame planes at '
                  'tiles 8, 16, 32 and 10, and print how its warps share '
                  'the SMs there (a build with per-warp records)')
  ap.add_argument('--replay-only',
                  choices=('slice1', 'slice2', *REPLAYS), default='',
                  help='phase 5, 8 or one replay of phase 13 alone: the '
                  'MuJoCo replay through that slice\'s or scene\'s env (a '
                  'full run starts each, a process each)')
  ap.add_argument('--scenes-only', action='store_true',
                  help='phase 13\'s four other scenes alone, their summary '
                  'written to build/scenes_smoke.json (a full run starts '
                  'it, a process)')
  ap.add_argument('--cli-only', choices=CLI_PARTS, default='',
                  help='one part of phase 12 alone: the command-line '
                  'workflow on the card, its summary written to '
                  'build/cli_smoke/<part>.json (a full run starts both, a '
                  'process each)')
  ap.add_argument('--bench-only', action='store_true',
                  help='phase 15 alone: the port\'s bench at its defaults, '
                  'its raster launches checked against the twin, its '
                  'output written to build/bench_smoke.* (a full run '
                  'starts it, a process)')
  args = ap.parse_args()
  if args.replay_only or args.cli_only or args.scenes_only or \
      args.bench_only:
    # a child of a full run, beside six others on the host's cores: its
    # host work is launches, not CPU operators
    torch.set_num_threads(1)

  # ---- 1. the card
  if not torch.cuda.is_available():
    fail('torch.cuda.is_available() is false: this smoke test needs a GPU')
  if args.bench_only:
    # stdout is the bench's: its one JSON line
    bench_child()
    return
  from geeco_tpu_torch.utils.device import card_name
  card = card_name(torch.device('cuda'))
  print(f'[device] {torch.cuda.get_device_name(0)} | {card} | torch '
        f'{torch.__version__} cuda {torch.version.cuda}', flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  from geeco_tpu_torch.envs.base import make_env
  from geeco_tpu_torch.utils import build
  t_start = time.perf_counter()
  if args.psd_phases:
    psd_phases(card)
    return
  if args.raster_phases:
    raster_phases(card)
    return

  # ---- 2. build: the rasterizer, and the PSD solve for every shape and
  # cluster size this script runs, every nvcc started together
  from geeco_tpu_torch.physics import solver_pallas as SP
  t0 = time.perf_counter()
  libs = [build.psd_library(SP.build_spec(3, *shape, cluster=C))
          for shape, sizes in PSD_BUILDS for C in sizes]
  build.build_all([build.raster_library(), *libs])
  print(f'[build] {1 + len(dict(libs))} kernel libraries ready in '
        f'{time.perf_counter() - t0:.2f} s (nvcc '
        f'{build.last_build_seconds:.2f} s) -> '
        f'{os.path.relpath(build.BUILD_DIR, ROOT)}', flush=True)
  for line in build.last_build_log.splitlines():
    if line.startswith('$'):
      print('[build] ' + ' '.join(a for a in line.split()
                                  if a.startswith('-DPSD') or
                                  a.endswith('.cu')), flush=True)
    if 'registers' in line or 'smem' in line or 'spill' in line:
      print(f'[build] {line.strip()}', flush=True)
  build.load_kernels()

  if args.replay_only == 'slice1':
    replay(make_env('pad2-cube2', device='cuda'), 'fidelity',
           steps=REPLAY1_STEPS)
    return
  if args.replay_only == 'slice2':
    drift = replay(make_env('pad2-cube2', device='cuda', rolling=False,
                            solver_method='pallas'), 'fidelity2')
    print(f'[fidelity2] drift {drift * 1000:.2f} mm through '
          f'{SP.psd_solve.launches} PSD wrapper calls (eager substeps, '
          'warm-ups and captures: a replay calls none) (the JAX pallas '
          'path at rolling=False: 11.8 mm on this fixture, JAX on the CPU)',
          flush=True)
    check(SP.psd_solve.launches > 0, 'the replay did not reach the PSD '
          'kernel')
    return

  if args.replay_only in REPLAYS:
    scene_replay(args.replay_only)
    return
  if args.cli_only:
    cli_phase(card, args.cli_only, cli_summary(args.cli_only))
    return
  if args.scenes_only:
    scenes_phase(card)
    return

  # ---- 5, 8, 12. the two MuJoCo replays and the two parts of the
  # command-line workflow, a process each from here on; this process
  # meanwhile does the work that times nothing (set-up, the kernel checks),
  # and its timed phases wait for their end and run alone
  for path in [cli_summary(part) for part in CLI_PARTS] + [SCENES_SUMMARY]:
    if os.path.exists(path):
      os.remove(path)
  me = [sys.executable, os.path.abspath(__file__)]
  children = [subprocess.Popen(me + ['--replay-only', which])
              for which in ('slice1', 'slice2', *REPLAYS)]
  children += [subprocess.Popen(me + ['--cli-only', part])
               for part in CLI_PARTS]
  children.append(subprocess.Popen(me + ['--scenes-only']))
  children.append(start_bench())
  try:
    kernels = drive(card, children, args.profile)
  finally:
    for child in children:
      if child.poll() is None:
        child.kill()
        child.wait()
  print(f'[total] {time.perf_counter() - t_start:.1f} s after the device '
        'check', flush=True)
  print(json.dumps({'kernels': kernels}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


def drive(card, children, profile_path):
  """Phases 3-4, 6-7 and 9-11 beside the processes `children` (the replays,
  phases 5 and 8, and the two parts of the command-line workflow, phase
  12); the timed part of phases 3, 4, 7, 10 and 11 after they have ended.
  Returns the kernels line."""
  from geeco_tpu_torch.envs.base import make_env
  from geeco_tpu_torch.expert import policies as EP
  from geeco_tpu_torch.physics import solver_pallas as SP
  from geeco_tpu_torch.render import raster_kernel as rk
  from geeco_tpu_torch.render import rasterizer as R
  from geeco_tpu_torch.utils import build
  dev = torch.device('cuda')
  gen = torch.Generator(device=dev).manual_seed(0)

  # ---- 3a. raster kernel vs twin on random planes at production shapes
  TS, K, n_tiles = 16, 192, 256
  sky = R._pack_sky((0.45, 0.86, 0.57))
  coeffs = R._coeff_planes(random_planes(ENVS, n_tiles, K, TS, gen),
                           TS, 2)
  raster_err = compare_raster(coeffs, TS, sky, rk, 'random')
  rnd_coeffs = coeffs
  # no slot valid; every slot valid; a slot count that is no multiple of 4
  for label, ok, K_ in (('none valid', 0.0, K), ('all valid', 1.0, K),
                        ('K=50', None, 50)):
    planes = random_planes(3, 7, K_, TS, gen)
    if ok is not None:
      planes[9] = torch.full_like(planes[9], ok)
    raster_err = max(raster_err, compare_raster(
        R._coeff_planes(planes, TS, 2), TS, sky, rk, label))
  check_sides(rk, sky, gen)

  # ---- 4a. slice 1: set-up
  t0 = time.perf_counter()
  env = make_env('pad2-cube2', device='cuda')
  env.setup()
  es = env.reset_random(ENVS, torch.Generator(device=dev).manual_seed(1))
  torch.cuda.synchronize()
  print(f'[slice] env built, set up and reset_random(B={ENVS}) in '
        f'{time.perf_counter() - t0:.1f} s (beside the replay processes)',
        flush=True)

  # ---- 3b. raster kernel vs twin on planes binned from these frames
  kin = env.kin(es)
  tp = R._project_and_shade(env.renderer, kin, es.rgba)
  coeffs = R._coeff_planes(R._bin_hierarchical(env.renderer, tp), TS, 2)
  raster_err = max(raster_err, compare_raster(coeffs, TS, sky, rk, 'frame'))
  describe_slots(coeffs, TS, 'frame')
  describe_slots(rnd_coeffs, TS, 'random')

  # env 0's frame rendered by the CPU path (the plain twin)
  rgb, _ = env.render(es)
  cpu_env = make_env('pad2-cube2', device='cpu')
  kin0 = kin.replace(**{f.name: getattr(kin, f.name)[:1].cpu()
                        for f in dataclasses.fields(kin)})
  rgb_cpu, _ = cpu_env.renderer.render(kin0, es.rgba[:1].cpu())
  diff = float((rgb_cpu[0] != rgb[0].cpu()).any(-1).float().mean())
  print(f'[slice] frame 0, CUDA vs CPU path: {diff:.5f} of pixels differ '
        f'(tolerance {CPU_FRAME_TOL:g})', flush=True)
  check(diff <= CPU_FRAME_TOL, 'CUDA frame disagrees with the CPU path')
  del cpu_env, kin, kin0, tp, rgb, rgb_cpu

  # ---- 6. the PSD kernel against its twin, on real and random operands
  t0 = time.perf_counter()
  k2env = make_env('pad2-cube2', device='cuda', rolling=False,
                   solver_method='pallas')
  k2env.setup()
  es2 = k2env.reset_random(ENVS, torch.Generator(device=dev).manual_seed(2))
  torch.cuda.synchronize()
  print(f'[psd] slice-2 env (rolling=False, pallas, ngrp='
        f'{k2env.stepper.cs.ngrp}) built, set up and reset at B={ENVS} in '
        f'{time.perf_counter() - t0:.1f} s (beside the replay processes)',
        flush=True)
  # 6a. random well-posed operands at the real shapes, with and without
  # the weld rows, at three batch sizes, in every cluster size; the
  # wrapper's own count of shared memory against the source's
  psd_err = 0.0
  for B_ in (ENVS, 3, 1):
    for nE in (6, 0):
      rnd = random_psd_operands(B_, 128, 9, 39, nE, gen)
      ref = SP.psd_solve_reference(**rnd)
      for C in (None, 1, 2, 4):
        lay = SP.plan(B_, 530, 39, nE, 128, C)
        check(lay['resident'] and lay['jreg'] > 0,
              f'pad2-cube2 shapes not resident with J in registers: {lay}')
        lib = build.load_psd(SP.build_spec(B_, 530, 39, nE, 128, 9, C))
        check(lay['smem'] == lib.psd_solve_smem_bytes(),
              f'shared-memory count differs from the source: {lay}')
        e, _ = within(SP.psd_solve(**rnd, cluster=C), ref,
                      label=f'psd:random forces, B={B_}, nE={nE}, '
                      f'cluster={C} -> {lay["cluster"]}', **FORCE_TOL)
        psd_err = max(psd_err, e)
  # other shapes, each one way through the kernel: J in shared memory, one
  # block per env (staged by bulk copy); a larger scene (K=192 contacts,
  # nv=63), resident only split over a cluster; shapes that are resident in
  # no cluster of four, J and X left in device memory
  for K_, nv_, C, want in (
      (64, 45, 1, dict(cluster=1, resident=True, jreg=0)),
      (192, 63, None, dict(cluster=2, resident=True, jreg=0)),
      (320, 87, None, dict(cluster=1, resident=False, jreg=0))):
    rnd = random_psd_operands(3, K_, 9, nv_, 6, gen)
    lay = SP.plan(3, 4 * K_ + 18, nv_, 6, K_, C)
    print(f'[psd] K={K_}, nv={nv_}: {lay}', flush=True)
    check(all(lay[k] == v for k, v in want.items()),
          f'unexpected plan at K={K_}, nv={nv_}: {lay}, expected {want}')
    within(SP.psd_solve(**rnd, cluster=C), SP.psd_solve_reference(**rnd),
           label=f'psd:random forces, K={K_}, nv={nv_}', **FORCE_TOL)
  # 6b. the first substep after reset_random, where the 60-iteration solve
  # is unstable to float32 rounding: every float32 solve against float64
  w = rounding_witness(capture_solve(k2env, es2, SP), SP, gen)
  check(w['envs_kernel_gt_2x_every_f32'] <= ENVS * WITNESS_MAX_FRAC,
        f'the PSD kernel is > 2x farther from the float64 solve than every '
        f'float32 twin in {w["envs_kernel_gt_2x_every_f32"]} of {ENVS} envs')
  # 6c. a substep of the expert episode after 5 control steps: the kernel
  # against the twin on its operands, and the substep through each
  es5, _ = EP.rollout(k2env, es2, EP.make_expert(k2env), length=5)
  ops = capture_solve(k2env, es5, SP)
  print(f'[psd] operands of one substep: B={ops["J"].shape[0]}, nI='
        f'{ops["J"].shape[1]}, nv={ops["J"].shape[2]}, nE='
        f'{ops["A_IE"].shape[2]}, K={ops["K"]}, nlim={ops["nlim"]}, '
        f'{ops["iterations"]} iterations', flush=True)
  f_k = SP.psd_solve(**ops)
  check(bool(torch.isfinite(f_k).all()), 'PSD kernel forces not finite')
  e, _ = within(f_k, SP.psd_solve_reference(**ops),
                label='psd:episode forces', **FORCE_TOL)
  psd_err = max(psd_err, e)
  sub_k = k2env.stepper.substep(es5.phys, k2env.solver_iterations, 'pallas')
  sub_r = twin_substep(k2env, es5.phys, SP)
  within(sub_k.qvel, sub_r.qvel, label='psd:episode substep qvel',
         **QVEL_TOL)
  del es5, sub_k, sub_r

  # ---- 9, 10a. the model's checks; the trainer's set-up and warm-up step
  cl_cfg, cl_model = model_checks(card)
  *trainer, train_err = trainer_setup(env, card)
  raster_err = max(raster_err, train_err)

  # ---- 13a. every scene, untimed: a textured render of slice 1; the PSD
  # kernel on clutter4's and nut-cone's operands; both scenes' production
  # envs set up
  tex_launches, e = textured_render(env, es, rk, card)
  raster_err = max(raster_err, e)
  k2_scenes = k2_scene_checks(SP, dev)
  psd_err = max([psd_err] + [v[3] for v in k2_scenes.values()])
  scene_envs, e = scene_envs_setup(rk, dev)
  raster_err = max(raster_err, e)

  # ---- 14a. the renderer's options, blockgj, profiling.trace and the
  # --num_devices check, untimed
  opt_launches, opt_tiles, e = option_phase(env, es, rk, card, dev)
  raster_err = max(raster_err, e)

  # phases 5 and 8, the replays' processes, and phase 15's bench;
  # everything below is timed and runs alone
  *children, bench_child = children
  for child, which in zip(children, ('slice-1 replay', 'slice-2 replay',
                                     *(f'{r} replay' for r in REPLAYS),
                                     *(f'command-line workflow ({p})'
                                       for p in CLI_PARTS),
                                     'other scenes')):
    rc = child.wait()
    check(rc == 0, f'the {which} failed with exit code {rc}')
    print(f'[children] the {which} ended by t='
          f'{time.perf_counter() - T_START:.0f} s', flush=True)
  cli_launches = {}
  for part in CLI_PARTS:
    with open(cli_summary(part)) as f:
      cli = json.load(f)
    raster_err = max(raster_err, cli['max_abs_err'])
    cli_launches.update(cli['launches'])
  with open(SCENES_SUMMARY) as f:
    scenes = json.load(f)
  raster_err = max(raster_err, scenes['max_abs_err'])
  bench_launches, e = bench_phase(bench_child)
  raster_err = max(raster_err, e)

  # ---- 3c. the raster kernel's time on the frame planes and on the
  # random ones
  ms, plain_ms, raster_bound, _ = time_raster(coeffs, TS, sky, rk, card,
                                              'frame')
  time_raster(rnd_coeffs, TS, sky, rk, card, 'random')
  del coeffs, rnd_coeffs
  # ---- 14b. K1 at the other tile sides, on phase 14's frame planes
  tile_entries = []
  for tile, res in OPTION_TILES:
    t_coeffs, t_launches, t_err = opt_tiles.pop(tile)
    t_ms, t_plain, t_bound, t_tile_bound = time_raster(
        t_coeffs, tile, sky, rk, card, f'tile {tile} at {res}x{res}')
    tile_entries.append({
        'name': f'raster_tiles[tile={tile}]', 'route': 'cuda',
        'source': 'geeco_tpu_torch/csrc/raster_tiles.cu',
        'replaces': 'geeco_tpu/render/rasterizer.py:778',
        'launches': t_launches, 'max_abs_err': t_err, 'ms': t_ms,
        'plain_ms': t_plain, 'bound_ms': t_bound[0],
        'bound_by': t_bound[1], 'library_ms': None,
        'tile_bound_ms': t_tile_bound[0], 'path': rk.kernel_limits(tile),
        'plan': list(rk.subtile_plan(tile)),
        'shape': list(t_coeffs.shape)})
    del t_coeffs

  # ---- 4b. slice 1: control steps of step + render
  base = torch.tensor([0.1, 0.0, 0.2, 1.0], device=dev).expand(ENVS, 4)
  rk.raster_tiles.launches = 0
  SP.psd_solve.launches = 0
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
  psd_launches_slice1 = SP.psd_solve.launches
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
  print(f'[slice] raster kernel launches: {launches} for {renders} renders; '
        f'PSD kernel launches: {psd_launches_slice1} (rolling rows, ngrp=6: '
        'the plain psd iteration)', flush=True)
  check(launches == renders, 'the raster kernel did not run once per render')
  check(psd_launches_slice1 == 0, 'the PSD kernel ran on the ngrp=6 path')
  profile_step(lambda: env.render(env.step(es, base)),
               f'slice 1, one control step + render, B={ENVS}', card,
               profile_path)
  del rgb, depth, flat

  # ---- 10b. the trainer; 11. closed loop from the state slice 1 left
  train_launches = trainer_run(*trainer, card, rk, env)
  del trainer
  cl_launches = closed_loop_run(env, es, cl_cfg, cl_model, card, rk)
  del env, es, cl_model

  # ---- 7. slice 2: the expert's state-only episodes at B=64, whose chains
  # of CUDA graphs a 2-step episode from the same state captures first
  EP.rollout(k2env, es2, EP.make_expert(k2env), length=2)
  rk.raster_tiles.launches = 0
  SP.psd_solve.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  es2, _ = EP.rollout(k2env, es2, EP.make_expert(k2env), length=EPISODE)
  torch.cuda.synchronize()
  dt2 = time.perf_counter() - t0
  psd_launches = SP.psd_solve.launches
  substeps = EPISODE * k2env.n_substeps
  print(f'[slice2] {EPISODE}-step expert episodes at B={ENVS}: {dt2:.3f} s '
        f'-> {ENVS * EPISODE / dt2:.2f} env-steps/s (state only) on '
        f'{card}; slice 1 in this run: {rate:.2f} env-steps/s (step + '
        'render)', flush=True)
  zeros = torch.zeros(ENVS, 4, device=dev)
  step_kernels = psd_kernels(lambda: k2env.step(es2, zeros),
                             k2env.n_substeps)
  print(f'[slice2] PSD wrapper calls: {psd_launches} for {substeps} '
        f'substeps (every substep a replay); PSD kernels in the device trace '
        f'of a control step: {step_kernels} for {k2env.n_substeps} '
        f'substeps; raster launches: {rk.raster_tiles.launches}', flush=True)
  check(psd_launches == 0, 'the episode captured a chain of CUDA graphs '
        'in its timed window')
  check(step_kernels == k2env.n_substeps,
        'the PSD kernel did not run once per substep')
  check(bool(torch.isfinite(es2.phys.qpos).all()), 'non-finite qpos')
  m = k2env.eval_metrics(es2)
  succ = float(m['task_success'].mean())
  print(f'[slice2] task_success {succ:.4f} '
        f'({int(m["task_success"].sum())} of {ENVS}), grasp_success '
        f'{float(m["grasp_success"].mean()):.4f}, goal_dist mean '
        f'{float(m["goal_dist"].mean()):.4f} median '
        f'{float(m["goal_dist"].median()):.4f} m', flush=True)
  check(succ >= MIN_SUCCESS, f'expert task success {succ:.4f} < '
        f'{MIN_SUCCESS}')
  psd_ms = cuda_ms(lambda: SP.psd_solve(**ops), 30, queued=True)
  psd_plain_ms = cuda_ms(lambda: SP.psd_solve_reference(**ops), 3)
  psd_bound = bound(*psd_work(ops))
  lay = SP.plan(*ops['J'].shape, ops['A_IE'].shape[2], ops['K'])
  print(f'[psd] kernel {psd_ms:.4f} ms ({lay}), plain twin '
        f'{psd_plain_ms:.4f} ms (CUDA events: the kernel queued, the twin '
        f'one by one), bound '
        f'{psd_bound[0]:.4f} ms by {psd_bound[1]} on {card}', flush=True)
  check(psd_ms >= psd_bound[0], 'PSD kernel time under its bound')
  # per cluster size, on the same substep's operands (B=1: env 0's)
  ops1 = {k: v[:1].contiguous() if isinstance(v, torch.Tensor) else v
          for k, v in ops.items()}
  for label, o in ((f'B={ENVS}', ops), ('B=1', ops1)):
    per_c = {C: cuda_ms(lambda: SP.psd_solve(**o, cluster=C), 30, queued=True)
             for C in (1, 2, 4, 4, 2, 1)}
    print(f'[psd] {label}, kernel ms per cluster size (second of two '
          f'turns): {per_c}; the plan takes '
          f'{SP.plan(*o["J"].shape, o["A_IE"].shape[2], o["K"])["cluster"]} '
          f'on {card}', flush=True)
  profile_step(lambda: k2env.step(es2, torch.zeros(ENVS, 4, device=dev)),
               f'slice 2, one control step, B={ENVS}', card)
  del k2env, es2

  # ---- 13b. clutter4 and nut-cone at B=ENVS, alone: control steps of
  # step + render, one profiled; the PSD kernel on their pallas envs
  scene_launches = time_scenes(scene_envs, rk, SP, card, dev)
  del scene_envs
  psd_paths, psd_shapes = time_k2_scenes(k2_scenes, SP, card, dev)
  del k2_scenes
  return [{
      'name': 'raster_tiles', 'route': 'cuda',
      'source': 'geeco_tpu_torch/csrc/raster_tiles.cu',
      'replaces': 'geeco_tpu/render/rasterizer.py:778',
      'launches': (launches + train_launches + cl_launches +
                   sum(cli_launches.values()) + tex_launches +
                   sum(scenes['launches'].values()) +
                   sum(scene_launches.values()) + opt_launches +
                   sum(bench_launches.values())),
      'launches_by_path': {'slice1': launches, 'trainer': train_launches,
                           'closed_loop': cl_launches, **cli_launches,
                           'textured': tex_launches, **scenes['launches'],
                           **scene_launches,
                           'options_production': opt_launches,
                           **bench_launches},
      'max_abs_err': raster_err,
      'ms': ms, 'plain_ms': plain_ms, 'bound_ms': raster_bound[0],
      'bound_by': raster_bound[1], 'library_ms': None,
  }, {
      'name': 'psd_solve', 'route': 'cuda',
      'source': 'geeco_tpu_torch/csrc/psd_solve.cu',
      'replaces': 'geeco_tpu/physics/solver_pallas.py:130',
      'launches': step_kernels + sum(psd_paths.values()),
      'launches_by_path': {'slice2 step': step_kernels, **psd_paths},
      'max_abs_err': psd_err,
      'ms': psd_ms, 'plain_ms': psd_plain_ms, 'bound_ms': psd_bound[0],
      'bound_by': psd_bound[1], 'library_ms': None,
      'by_shape': psd_shapes,
  }] + tile_entries


if __name__ == '__main__':
  main()
