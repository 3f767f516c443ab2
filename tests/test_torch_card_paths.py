"""The port's paths on the card at production settings (every test skips
without one).

Slice 1, ``GeecoEnv('pad2-cube2')`` at B=64: control steps of step +
render keep the cubes on the table and launch K1 once a render, and env
0's frame matches the CPU path's.  Slice 2, the fused-solve env
(``rolling=False, solver_method='pallas'``): the scripted expert's
100-step episodes succeed, every substep a replay of its chain.  The
model: the flagship's bf16 forward against float32, a small float32 train
step on the card against the CPU, with cuDNN's TF32 as a control the
comparison must reject.  The episode trainer at the bench point: every K1
launch of its warm-up step against the twin, ceil(B*T/100) + 1 launches a
step, a finite, falling loss.  The closed loop: one K1 launch a step and
one for the goal frames.  The renderer's options against the CPU port, a
textured render, the MuJoCo ray-cast depth, ``blockgj`` against ``chol``,
``profiling.trace``, ``--num_devices`` above the card count, the other
scenes, and ``python -m geeco_tpu_torch.bench`` at a small sweep.

tests/conftest.py imports JAX, which the card lacks, so there the file
runs without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_paths.py

This file imports no JAX.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from geeco_tpu_torch.bench import (RENDER_CHUNK, bench_config, train_batch,
                                   train_launches)
from geeco_tpu_torch.core.model import make_state
from geeco_tpu_torch.envs.base import make_env
from geeco_tpu_torch.expert import policies as EP
from geeco_tpu_torch.physics import solver_pallas as SP
from geeco_tpu_torch.render import raster_kernel as rk
from geeco_tpu_torch.render import rasterizer as R
from test_torch_card_kernels import (  # noqa: F401 (fixtures)
    ENVS, card, checked_k1, launches_of_k1, option_renderer, slice1, slice2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, 'tests', 'fixtures')
STEPS = 5               # control steps of step + render
CPU_FRAME_TOL = 5e-3    # CUDA vs CPU full frame: edge pixels only
EPISODE = 100           # control steps of an expert episode (run/sim.py:36)
MIN_SUCCESS = 0.80      # expert task success over the B envs
# the flagship's heads in bf16 against float32 convolutions (8 bits of
# mantissa through 8 layers; 0.37-1.19% on the H100, 1-3.3% on the CPU at
# 256x256): within this share of their largest value
BF16_REL = 0.03
# a small float32 train step on the card against the CPU: the same float32
# graph, other convolution algorithms (no TF32).  Gradients per tensor, as
# the norm of the difference over the norm of the CPU's: the largest, and
# the median over the tensors
SMALL_LOSS_RTOL = 1e-4
SMALL_GRAD_REL = 3e-3
SMALL_GRAD_MEDIAN = 1e-4
# the trainer at the bench's point: B episodes of T steps, windows encoded
# in chunks of 8, state re-rendered RENDER_CHUNK frames a call
TRAIN_B, TRAIN_T = 8, 99
TRAIN_STEPS = 5         # train steps after the warm-up step
CL_STEPS = 5            # closed-loop control steps of the ENVS envs
# one control step under mass_inverse='blockgj' against 'chol' at
# tests/test_torch_levers.py's physics and tolerance
BLOCKGJ_PHYSICS = dict(n_substeps=2, solver_iterations=8)
BLOCKGJ_QPOS_ATOL = 1e-4
# and at the production physics (20 substeps of 60 iterations) the per-env
# median within BLOCKGJ_PROD_MEDIAN.  Not the largest env: a few envs
# amplify rounding without bound (one reached a state a substep before a
# 32 kN contact impulse, which the JAX package's substep reproduces from
# that state; even one substep from a common state moved qvel 1.5e-2 apart
# on the card: PERF.md)
BLOCKGJ_PROD_MEDIAN = 1e-6
# the other scenes on their production envs, settle steps cut to
# SCENE_SETTLE: SCENE_ENVS envs (ball-cup at its peak memory, the full
# batch), one reset_random, a control step and a render each
SCENES = ('pad2-cube2-clutter12', 'ball-cup', 'bridge-pad', 'diamond-pad')
SCENE_ENVS, SCENE_SETTLE = 8, 2
SCENE_BATCH = {'ball-cup': ENVS}
SCENE_STEPS = 3         # control steps of clutter4 and nut-cone at ENVS envs
BENCH_KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'train_steps_per_sec')


@pytest.fixture(scope='module')
def flagship(card):
  """The flagship E2E-VMC (goal-conditioned, dynimg/dyndiff, 256x256, bf16
  convolutions) with the bench's trainer settings, its zero-initialised
  heads given seeded weights, so the outputs see the whole network and
  the closed loop acts."""
  from geeco_tpu_torch.models import e2evmc as TE
  cfg = bench_config()
  model = TE.make_model(cfg, True, device=card,
                        generator=torch.Generator().manual_seed(0))
  gen = torch.Generator().manual_seed(1)
  with torch.no_grad():
    for name, _ in model.decoder.heads:
      w = getattr(model.decoder, name).weight
      w.copy_(0.05 * torch.randn(w.shape, generator=gen))
  return cfg, model


@pytest.fixture(scope='module')
def background(tmp_path_factory):
  """A 12-frame GIF of moving colour bands, written with Pillow."""
  from PIL import Image
  path = str(tmp_path_factory.mktemp('background') / 'bands.gif')
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
  return path


def _textures(env, gif):
  """A background frame per env from a VideoCycler over ``gif``."""
  from geeco_tpu_torch.data.videos import VideoCycler
  frames = VideoCycler(gif).texel_steps(ENVS, env.renderer.scene.tex_res)
  return env.background_textures(frames)


def _object_heights(env, es):
  m = env.model
  return torch.stack([es.phys.qpos[:, m.jnt_qposadr[m.joint(str(j))] + 2]
                      for j in env.obj_joint_names], -1)


def _cpu_frame(assets_model, kin, rgba, textures=None, **options):
  """Env 0's frame through the port on the CPU with ``options``."""
  m, assets = assets_model
  kin0 = kin.replace(**{f.name: getattr(kin, f.name)[:1].cpu()
                        for f in dataclasses.fields(kin)})
  tex = None if textures is None else textures[:1].cpu()
  return R.build_renderer(m, assets, **options).render(
      kin0, rgba[:1].cpu(), tex)


def _assert_frame_matches_cpu(rgb, depth, ref):
  """Env 0 of a card frame against the CPU port's frame: at most
  CPU_FRAME_TOL of the pixels differ, the depth of the others within
  1e-4 (``depth`` None: the pixels alone)."""
  rgb_c, depth_c = ref
  mism = (rgb_c[0] != rgb[0].cpu()).any(-1)
  assert float(mism.float().mean()) <= CPU_FRAME_TOL
  if depth is None:
    return
  derr = float((depth_c[0] - depth[0].cpu())[~mism].abs().max())
  assert derr <= 1e-4 + 1e-4 * float(depth_c.abs().max())


# ------------------------------------------------------------------ slice 1

def test_slice1_frame_matches_the_cpu_path(slice1):
  env, es, am = slice1
  rgb, _ = env.render(es)
  _assert_frame_matches_cpu(rgb, None, _cpu_frame(am, env.kin(es), es.rgba))


def test_slice1_steps_and_renders(slice1):
  """Control steps of step + render: the cubes rest on the table, the
  frames are 256x256 uint8 and not constant, the depth finite, K1 runs once
  a render and K2's wrapper is never called (every substep the replay of
  a chain captured at the reset; the replay runs K2's 'psd' form)."""
  env, es, _ = slice1
  dev = es.phys.qpos.device
  base = torch.tensor([0.1, 0.0, 0.2, 1.0], device=dev).expand(ENVS, 4)
  rk.raster_tiles.launches = 0
  SP.psd_solve.launches = 0
  for i in range(STEPS):
    delta = 0.01 * torch.sin(0.7 * i + torch.arange(4, device=dev))
    es = env.step(es, base + delta)
    rgb, depth = env.render(es)
  torch.cuda.synchronize()
  assert rk.raster_tiles.launches == STEPS
  assert SP.psd_solve.launches == 0
  assert bool(torch.isfinite(es.phys.qpos).all())
  zs = _object_heights(env, es)
  assert bool(((zs >= 0.28) & (zs <= 0.32)).all()), \
      'cubes are not resting on the table'
  assert rgb.shape == (ENVS, 256, 256, 3) and rgb.dtype == torch.uint8
  assert bool(torch.isfinite(depth).all())
  flat = rgb.reshape(ENVS, -1, 3).float()
  assert bool((flat.std(dim=1).mean(-1) > 10).all()), 'a frame is constant'


# ------------------------------------------------------------------ slice 2

def test_the_expert_succeeds_on_the_fused_solve_env(slice2):
  """The expert's 100-step state-only episodes at B=64, whose chains of
  CUDA graphs a 2-step episode from the same state captures first: the
  wrapper of K2 is never called (every substep a replay), the state
  finite, task success at least MIN_SUCCESS."""
  env, es = slice2
  EP.rollout(env, es, EP.make_expert(env), length=2)
  SP.psd_solve.launches = 0
  rk.raster_tiles.launches = 0
  es, _ = EP.rollout(env, es, EP.make_expert(env), length=EPISODE)
  torch.cuda.synchronize()
  assert SP.psd_solve.launches == 0
  assert rk.raster_tiles.launches == 0
  assert bool(torch.isfinite(es.phys.qpos).all())
  succ = float(env.eval_metrics(es)['task_success'].mean())
  assert succ >= MIN_SUCCESS


# ---------------------------------------------------------------- the model

def test_the_flagship_bf16_forward_matches_float32(flagship, card):
  from geeco_tpu_torch.models import e2evmc as TE
  cfg, model = flagship
  f32 = TE.make_model(dataclasses.replace(cfg, compute_dtype='float32'),
                      True, device=card)
  f32.load_state_dict(model.state_dict())
  n, K, H, W = 4, cfg.window_size, cfg.img_height, cfg.img_width
  g = torch.Generator(device=card).manual_seed(3)
  frames = torch.rand((n, K, H, W, 3), generator=g, device=card)
  jnt = torch.randn((n, K, 7), generator=g, device=card)
  tgt = torch.rand((n, H, W, 3), generator=g, device=card)
  carry = tuple(torch.randn((n, cfg.dim_h_lstm), generator=g, device=card)
                for _ in range(2))
  with torch.no_grad():
    ep, c = model(frames, jnt, tgt, carry, False)
    ref, rc = f32(frames, jnt, tgt, carry, False)
  for k, _ in model.decoder.heads:
    assert bool(torch.isfinite(ep[k]).all()), k
    rel = float((ep[k] - ref[k]).abs().max() / ref[k].abs().max())
    assert rel <= BF16_REL, (k, rel)
  assert max(float((a - b).abs().max()) for a, b in zip(c, rc)) <= BF16_REL


def test_a_card_train_step_matches_the_cpu_and_tf32_does_not(card,
                                                             monkeypatch):
  """One float32 per-window train step (64x64, encoders 20 wide: their last
  GroupNorm is one group) on the CPU and on the card from the same weights
  and batch; then the same step on the card with cuDNN's TF32 on in every
  convolution (the model's float32 scope replaced), a control the same
  comparison must reject."""
  from geeco_tpu_torch.models import e2evmc as TE
  from geeco_tpu_torch.models import train as TT
  from geeco_tpu_torch.models.params import create_e2evmc_config
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
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

  def failures(run):
    """What the comparison with the CPU's step finds out of tolerance."""
    (m_c, p_c), (m_g, p_g) = cpu, run
    out = [k for k, v in m_c.items()
           if abs(m_g[k] - v) > SMALL_LOSS_RTOL * abs(v) + 1e-6]
    rel = [float((p_g[k][0] - g).norm() / (g.norm() + 1e-12))
           for k, (g, _) in p_c.items()]
    perr = max(float((p_g[k][1] - p).abs().max()) for k, (_, p) in p_c.items())
    if max(rel) > SMALL_GRAD_REL:
      out.append('gradient (largest)')
    if float(np.median(rel)) > SMALL_GRAD_MEDIAN:
      out.append('gradient (median)')
    # Adam's first step is about lr * sign(g): at most 2 lr apart
    if perr > 2 * cfg.lr + 1e-6:
      out.append('parameters')
    return out

  cpu = step_on('cpu')
  assert failures(step_on('cuda')) == []
  monkeypatch.setattr(TE, 'conv_precision', tf32_on)
  monkeypatch.setattr(TT, 'conv_precision', tf32_on)
  assert failures(step_on('cuda')), \
      'the card-vs-CPU comparison passes a step with TF32 on'


def test_the_episode_trainer_at_the_bench_point(slice1, flagship):
  """The bench's batch around slice 1's settled state: the warm-up step's
  renders (chunks of RENDER_CHUNK frames, the last one padded, then the
  goal frames) each held against the twin; then train steps on the fixed
  batch, ceil(B*T/RENDER_CHUNK) + 1 K1 launches each, the loss finite and
  falling."""
  from geeco_tpu_torch.models import train as TT
  env, _, _ = slice1
  cfg, _ = flagship
  init_fn, train_step, _, _ = TT.make_episode_train_fns(
      cfg, True, chunk_windows=8, render_fn=env.render_from_qpos,
      aug_pad=10, render_chunk=RENDER_CHUNK, device=env.device)
  ts = init_fn(torch.Generator().manual_seed(0), cfg.batch_size)
  batch = train_batch(env, TRAIN_B, TRAIN_T, env.device, cfg)
  with checked_k1() as sizes:
    ts, m = train_step(ts, batch)
  assert sizes == [RENDER_CHUNK] * -(-TRAIN_B * TRAIN_T // RENDER_CHUNK) + \
      [TRAIN_B]
  losses = [m['loss']]
  rk.raster_tiles.launches = 0
  for _ in range(TRAIN_STEPS):
    ts, m = train_step(ts, batch)
    losses.append(m['loss'])
  losses = torch.stack(losses).tolist()
  assert rk.raster_tiles.launches == \
      train_launches(TRAIN_B, TRAIN_T) * TRAIN_STEPS
  assert all(np.isfinite(losses)), losses
  assert losses[-1] < losses[0], losses


def test_the_closed_loop_launches_k1_once_a_step(slice1, flagship):
  from geeco_tpu_torch.models import closed_loop as CL
  env, es, _ = slice1
  cfg, model = flagship
  rk.raster_tiles.launches = 0
  agg = CL.evaluate_batched(env, cfg, model, True, ENVS, es0=es,
                            n_steps=CL_STEPS)
  torch.cuda.synchronize()
  assert rk.raster_tiles.launches == CL_STEPS + 1   # + the goal frames
  assert all(bool(torch.isfinite(v).all()) for v in agg.values())


# ------------------------------------------------------ the renderer's options

def test_the_production_render_takes_k1_once(slice1):
  env, es, _ = slice1
  before = dict(env.renderer.path_counts)
  rk.raster_tiles.launches = 0
  env.render(es)
  torch.cuda.synchronize()
  took = {k: v - before.get(k, 0) for k, v in env.renderer.path_counts.items()
          if v != before.get(k, 0)}
  assert took == {'hierarchical': 1} and rk.raster_tiles.launches == 1


def test_flat_binning_launches_no_k1_and_matches_the_cpu(slice1):
  env, es, am = slice1
  r = option_renderer(env, am, backend='jnp')
  kin = env.kin(es)
  rk.raster_tiles.launches = 0
  rgb, depth = r.render(kin, es.rgba)
  torch.cuda.synchronize()
  assert rk.raster_tiles.launches == 0 and r.path_counts == {'flat': 1}
  _assert_frame_matches_cpu(rgb, depth,
                            _cpu_frame(am, kin, es.rgba, backend='jnp'))


def test_analytic_rects_with_textures_and_depth_gl_match_the_cpu(
    slice1, background):
  env, es, am = slice1
  tex = _textures(env, background)
  opts = dict(analytic_rects=True, depth_gl=True)
  r = option_renderer(env, am, **opts)
  kin = env.kin(es)
  with launches_of_k1() as seen:
    rgb, depth = r.render(kin, es.rgba, tex)
  torch.cuda.synchronize()
  assert r.scene.rect_geom.size > 0 and r.shadows
  assert len(seen) == 1
  assert bool(torch.isfinite(depth).all())
  assert 0.0 <= float(depth.min()) and float(depth.max()) <= 1.0
  _assert_frame_matches_cpu(rgb, depth,
                            _cpu_frame(am, kin, es.rgba, tex, **opts))


def test_a_textured_render(slice1, background):
  """A background frame per env: one K1 launch, held against the twin;
  every env's wall changes, the table front (the bottom 32 rows) not."""
  env, es, _ = slice1
  tex = _textures(env, background)
  plain, _ = env.render(es)
  rk.raster_tiles.launches = 0
  with checked_k1():
    rgb, _ = env.render(es, textures=tex)
  torch.cuda.synchronize()
  assert rk.raster_tiles.launches == 1
  changed = (plain != rgb).any(-1)                # [B, H, W]
  assert bool((changed.float().mean((1, 2)) > 0.05).all()), \
      'a textured frame shows no wall'
  assert not bool(changed[:, -32:].any()), \
      'the background texture reached the table front'


def test_the_gripper_camera_renders_finite_depth(slice1):
  env, es, am = slice1
  r = option_renderer(env, am, camera='gripper_camera_rgb')
  _, depth = r.render(env.kin(es), es.rgba)
  assert bool(torch.isfinite(depth).all())


@pytest.mark.parametrize('variant', ['auto', 'jnp', 'jnp-analytic'])
def test_mujoco_raycast_depth_bounds(variant, slice1):
  """The port's depth on the card against the MuJoCo ray-cast fixture of
  pad2cube2 (three frames), at tests/test_render_golden.py's bounds: no
  sky holes, exact interiors, the > 2 cm and > 10 cm areas and the
  silhouette IoU bounded."""
  env, _, am = slice1
  golden = np.load(os.path.join(FIXTURES, 'mujoco_raycast_pad2cube2.npz'))
  st = make_state(env.model, golden['qpos'].shape[0])
  as_t = lambda k: torch.as_tensor(golden[k], dtype=torch.float32,
                                   device=st.qpos.device)
  st = st.replace(qpos=as_t('qpos'), mocap_pos=as_t('mocap_pos'),
                  mocap_quat=as_t('mocap_quat'))
  backend, _, opt = variant.partition('-')
  r = option_renderer(env, am, width=int(golden['width']),
                      height=int(golden['height']), backend=backend,
                      analytic_rects=opt == 'analytic')
  _, depth = r.render(env.stepper.fk(st))
  for k, (d, g) in enumerate(zip(depth.cpu().numpy(), golden['depth'])):
    err = np.abs(d - g)
    ours, mjs = d < 2.0, g < 2.0
    stats = dict(holes=np.mean((d > 9.9) & (g > 0)), median=np.median(err),
                 frac2cm=np.mean(err > 0.02), frac10cm=np.mean(err > 0.10),
                 iou=(ours & mjs).sum() / max((ours | mjs).sum(), 1))
    assert (stats['holes'] < 1e-3 and stats['median'] < 1e-3 and
            stats['frac2cm'] < 0.07 and stats['frac10cm'] < 0.05 and
            stats['iou'] > 0.965), (k, stats)


# --------------------------------------------------------- the other options

def test_blockgj_against_chol(slice1):
  """From the state a first control step left: a control step at the CPU
  test's physics (2 substeps of 8 PSD iterations) to its tolerance, and at
  the production physics by the median env."""
  env, es, _ = slice1
  dev = es.phys.qpos.device
  base = torch.tensor([0.1, 0.0, 0.2, 1.0], device=dev).expand(ENVS, 4)
  es1 = env.step(es, base)
  chol = make_env('pad2-cube2', device=dev, **BLOCKGJ_PHYSICS)
  bgj = make_env('pad2-cube2', device=dev, mass_inverse='blockgj',
                 **BLOCKGJ_PHYSICS)
  d = (chol.step(es1, base).phys.qpos -
       bgj.step(es1, base).phys.qpos).abs().amax(-1)
  assert bool(torch.isfinite(d).all()) and float(d.max()) <= \
      BLOCKGJ_QPOS_ATOL
  del chol, bgj
  bgj = make_env('pad2-cube2', device=dev, mass_inverse='blockgj')
  d = (env.step(es1, base).phys.qpos -
       bgj.step(es1, base).phys.qpos).abs().amax(-1)
  assert bool(torch.isfinite(d).all()) and float(d.median()) <= \
      BLOCKGJ_PROD_MEDIAN


def test_profiling_trace_writes_a_trace(slice1, tmp_path):
  """A control step of a 2-substep env (a 20-substep step has ~125k
  events, whose export takes a minute) traced by utils/profiling.trace."""
  from geeco_tpu_torch.utils import profiling
  env, es, _ = slice1
  penv = make_env('pad2-cube2', device=env.device, n_substeps=2)
  base = torch.tensor([0.1, 0.0, 0.2, 1.0], device=env.device)
  with profiling.trace(str(tmp_path)):
    penv.step(es, base.expand(ENVS, 4))
    torch.cuda.synchronize()
  files = os.listdir(tmp_path)
  assert len(files) == 1 and os.path.getsize(tmp_path / files[0]) > 0


def test_num_devices_above_the_card_count_raises(card, tmp_path):
  from geeco_tpu_torch.run import gym_pickplace
  n = torch.cuda.device_count() + 1
  with pytest.raises(RuntimeError):
    gym_pickplace.main(gym_pickplace.parse([
        '--wrk_dir', str(tmp_path), '--sim_mode', 'collect',
        '--num_envs', str(2 * n), '--num_devices', str(n)]))


# -------------------------------------------------------------- other scenes

@pytest.mark.parametrize('shapes', SCENES)
def test_each_other_scene_steps_and_renders(shapes, card):
  """The primitive pair kernels (clutter12) and the convex-hull
  narrowphase (the mesh scenes) on their production envs: a finite state,
  the objects above the table, one K1 launch for the render, held against
  the twin."""
  B = SCENE_BATCH.get(shapes, SCENE_ENVS)
  env = make_env(shapes, device=card, settle_steps=SCENE_SETTLE)
  es = env.reset_random(B, torch.Generator(device=card).manual_seed(3))
  action = torch.tensor([0.2, -0.1, -0.3, 1.0], device=card).expand(B, 4)
  rk.raster_tiles.launches = 0
  with checked_k1():
    es = env.step(es, action)
    rgb, depth = env.render(es)
  torch.cuda.synchronize()
  assert rk.raster_tiles.launches == 1
  assert bool(torch.isfinite(es.phys.qpos).all() and
              torch.isfinite(es.phys.qvel).all())
  z = _object_heights(env, es)
  assert bool(((z > 0.2) & (z < 0.4)).all()), 'an object left the table'
  assert rgb.shape == (B, 256, 256, 3) and bool(torch.isfinite(depth).all())


@pytest.mark.parametrize('shapes', ['pad2-cube2-clutter4', 'nut-cone'])
def test_clutter4_and_nutcone_step_and_render_at_b64(shapes, card):
  """The production envs at 64 envs: the first render held against the
  twin, then control steps of step + render, K1 once a render and K2's
  wrapper never called (every substep the replay of a chain captured at
  the reset), the state and frames finite, the objects above the table."""
  env = make_env(shapes, device=card, settle_steps=SCENE_SETTLE)
  es = env.reset_random(ENVS, torch.Generator(device=card).manual_seed(5))
  with checked_k1():
    env.render(es)
  action = torch.tensor([0.1, 0.0, -0.2, 1.0], device=card).expand(ENVS, 4)
  rk.raster_tiles.launches = 0
  SP.psd_solve.launches = 0
  for _ in range(SCENE_STEPS):
    es = env.step(es, action)
    _, depth = env.render(es)
  torch.cuda.synchronize()
  assert rk.raster_tiles.launches == SCENE_STEPS
  assert SP.psd_solve.launches == 0
  assert bool(torch.isfinite(es.phys.qpos).all() and
              torch.isfinite(depth).all())
  z = _object_heights(env, es)
  assert bool(((z > 0.2) & (z < 0.4)).all()), 'an object left the table'


# ---------------------------------------------------------------- the bench

def test_the_bench_entry_point_prints_its_json_line(card):
  """``python -m geeco_tpu_torch.bench`` at one small batch and its
  trainer: exit 0 (the bench fails itself unless K1 ran once a timed
  control step and ceil(B*T/100) + 1 times a train step), one JSON line
  on stdout with the JAX bench's keys, rates above 0."""
  env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
  env.update(BENCH_SWEEP='16', BENCH_STEPS='3')
  proc = subprocess.run([sys.executable, '-m', 'geeco_tpu_torch.bench'],
                        cwd=ROOT, env=env, capture_output=True, text=True,
                        timeout=900)
  assert proc.returncode == 0, proc.stderr[-4000:]
  out = proc.stdout.splitlines()
  assert len(out) == 1, proc.stdout
  res = json.loads(out[0])
  assert all(k in res for k in BENCH_KEYS) and 'truncated' not in res, res
  assert res['value'] > 0 and res['train_steps_per_sec'] > 0, res
