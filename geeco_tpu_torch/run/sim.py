"""Simulation CLI engine: collect / replay / random / controller modes.

Counterpart of ``geeco_tpu/run/sim.py``, the shared implementation behind
run/gym_pickplace.py and run/gym_pushing.py and of the reference scripts
(scripts/gym_pickplace.py:608-977, gym_pushing.py:444-769): same modes,
same directory outputs (meta_info.json, replay_buffer_*.{npz,pkl,
tfrecord.zlib}, eval_results CSV, triage CSV, final_results.txt, videos),
same eval protocol.

--num_envs batches the envs: resets, expert FSMs, physics and rendering run
for the whole batch in lockstep on ``--device`` (default: the card), and
episodes are written out per env by a pool of writer threads.  Random draws
come from a CPU ``torch.Generator`` seeded with --seed, so one seed gives
the same resets on every device (not the JAX package's numbers).

--background_video (a GIF or a directory of frames; other formats need
OpenCV) puts one frame a step on the camera-facing wall of collected and
evaluated episodes; --rendering_mode viewer draws the frames into the
terminal (render/viewer.py).

--num_devices N (collect and controller) splits the --num_envs batch over N
devices, one process each (parallel/mesh.py): N ranks spawned by the CLI,
NCCL on cuda:0..N-1 or gloo on the CPU, joined through a file in the run's
work dir.  The random draws are made for the whole batch on every rank (the
same generator, the same stream) and each rank builds and steps its rows,
so N ranks write the episodes one rank writes, under the same names; the
controller's metrics are gathered in global env order and rank 0 writes
the CSVs.  With --rendering_mode video or viewer, rank 0 shows its own
episodes.  The other modes run in one process, as in the JAX package.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import tasks as task_csv
from ..data.episode import (load_episode, make_record_fn, meta_info_dict,
                            save_episode_npz, save_replay_buffer_pkl)
from ..data.keyframes import load_target_frames
from ..data.tfrecord_io import write_episode_tfrecord
from ..envs.base import GeecoEnv, ResetSpec
from ..expert.policies import make_expert, rollout
from ..parallel import mesh as PM
from ..render.video import VideoRecorder
from ..utils.runscript import save_run_command

EPISODE_STEPS_COLLECT = 100   # gym_pickplace.py:630
EPISODE_STEPS_CONTROL = 200   # gym_pickplace.py:626

EVAL_FIELDS = ('episode_id', 'obj_vicinity', 'grasp_success',
               'task_success', 'init_goal_dist', 'min_goal_dist',
               'max_goal_dist', 'final_goal_dist', 'video_file')
TRIAGE_FIELDS = ('episode_id', 'phase', 'steps_grasped', 'max_obj_z',
                 'drop_goal_dist', 'min_goal_dist', 'final_goal_dist',
                 'video_file')


def make_argparser(description: str, wrk_dir: str, shapes: str,
                   shapes_help: str) -> argparse.ArgumentParser:
  """The flags of the reference scripts (scripts/gym_pickplace.py:49-131),
  the JAX package's extensions and --device."""
  ap = argparse.ArgumentParser(description=description)
  ap.add_argument('--wrk_dir', type=str, default=wrk_dir)
  ap.add_argument('--shapes', type=str, default=shapes, help=shapes_help)
  ap.add_argument('--sim_mode', type=str, default='collect',
                  help='collect | replay | random | controller')
  ap.add_argument('--max_episode_steps', type=int, default=-1)
  ap.add_argument('--dry_run', default=False, action='store_true')
  ap.add_argument('--init_states', type=str, default='')
  ap.add_argument('--start_idx', type=int, default=0)
  ap.add_argument('--end_idx', type=int, default=100)
  ap.add_argument('--replay_buffer', type=str, default='')
  ap.add_argument('--controller', type=str, default='e2evmc')
  ap.add_argument('--goal_condition', type=str, default='none',
                  help='none | target')
  ap.add_argument('--model_dir', type=str, default='')
  ap.add_argument('--checkpoint_name', type=str, default=None)
  ap.add_argument('--dataset_dir', type=str, default='')
  ap.add_argument('--tfrecord_list', type=str, default='')
  ap.add_argument('--background_video', type=str, default='',
                  help='GIF, directory of frames or video (OpenCV) cycled '
                       'onto the camera-facing wall, one frame a step')
  ap.add_argument('--carry_mode', type=str, default='auto',
                  choices=['auto', 'window', 'persistent'],
                  help='LSTM carry at serving: auto derives it from the '
                       'trained config.train_carry; window = fresh per '
                       'step; persistent = accumulated across the episode '
                       '(reference-predictor parity)')
  ap.add_argument('--shadows', type=int, default=-1,
                  help='occlusion-tested shadows: 1 on, 0 off, -1 renderer '
                       'default (on)')
  ap.add_argument('--tex_grid', type=int, default=-1,
                  help='texel grid for textured surfaces; 0 disables '
                       'texture tessellation (flat colors), -1 = renderer '
                       'default')
  ap.add_argument('--rendering_mode', type=str, default='tfrecord',
                  help='video | tfrecord | viewer | none')
  ap.add_argument('--frame_res', type=int, nargs=2, default=[256, 256])
  ap.add_argument('--observation_format', type=str, default='rgb')
  ap.add_argument('--num_devices', type=int, default=1,
                  help='shard the env batch over this many devices, one '
                       'process each (num_envs must divide evenly)')
  ap.add_argument('--num_envs', type=int, default=1,
                  help='batch of envs stepped in lockstep')
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--split_name', type=str, default='default',
                  help='dataset split for controller-mode eval')
  ap.add_argument('--dataset_formats', type=str, default='all',
                  choices=['all', 'npz', 'states'],
                  help='npz = fast uncompressed training collect (skips '
                       'pkl/tfrecord sidecars and depth); states = '
                       'frameless collect storing full qpos per step '
                       '(~40 KB/episode): training re-renders on the '
                       'device (data/episode.py)')
  ap.add_argument('--start_sphere', type=float, default=0.03,
                  help='EE-start sampling sphere radius (reference r=0.03); '
                       'larger = perturbation-augmented start-basin '
                       'coverage for collection')
  ap.add_argument('--perturb_prefix', type=int, default=0,
                  help='collect mode: up to N random pre-roll steps per '
                       'episode before the expert takes over (the recorded '
                       'episode starts AFTER the pre-roll)')
  ap.add_argument('--expert_noise', type=float, default=0.0,
                  help='DART collection: execute expert + N(0, sigma) on '
                       'the EE translation, record the clean expert action '
                       '(expert/policies.py rollout)')
  ap.add_argument('--renderer_trim', type=str, default='',
                  help='K1,K2 binning-cap override (coarse_k,mid_k); only '
                       'values that keep the frames pixel-exact')
  ap.add_argument('--device', type=str, default=None,
                  help='torch device (default: the card, cuda)')
  ap.add_argument('--debug', default=False, action='store_true')
  return ap


def parse(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
  """Parse ``argv`` (default: the command line) for ``main``."""
  args, _ = parser.parse_known_args(argv)
  args._parser, args._argv = parser, argv
  return args


def _env_mesh(args):
  """This rank's mesh when the run is data-parallel, else None."""
  if getattr(args, 'num_devices', 1) <= 1:
    return None
  return PM.make_mesh(args.num_devices)


def build_env(args) -> GeecoEnv:
  rk = {}
  sh = getattr(args, 'shadows', -1)
  if sh is not None and sh >= 0:
    rk['shadows'] = bool(sh)
  tg = getattr(args, 'tex_grid', -1)
  if tg is not None and tg >= 0:
    rk['tex_grid'] = tg
  trim = getattr(args, 'renderer_trim', '')
  if trim:
    k1, k2 = (int(v) for v in trim.split(','))
    rk.update(coarse_k=k1, mid_k=k2)
  return GeecoEnv(shapes=args.shapes, frame_res=tuple(args.frame_res),
                  start_sphere_r=getattr(args, 'start_sphere', 0.03),
                  renderer_kwargs=rk, device=getattr(args, 'device', None))


def _background_cycler(args, env: GeecoEnv):
  """--background_video's frame cycler (the reference's VideoCycler +
  TextureModder on wall_04), or None."""
  if not getattr(args, 'background_video', ''):
    return None
  from ..data.videos import VideoCycler
  cycler = VideoCycler(args.background_video)
  if env.background_slot() is None:
    print('WARNING: scene has no textured wall_04; '
          '--background_video ignored')
    return None
  return cycler


def _step_textures(cycler, env: GeecoEnv, n_steps: int):
  """[n_steps, R, R, 3] background texels on the env's device, or None."""
  if cycler is None:
    return None
  return torch.as_tensor(cycler.texel_steps(
      n_steps, env.renderer.scene.tex_res), device=env.device)


def _episode_context(env: GeecoEnv, task_goal: int, task_object: int
                     ) -> dict:
  ctx = dict(meta_info_dict(env))
  ctx['task_goal'] = env.goal_sites[task_goal]
  ctx['task_object'] = env.cube_sites[task_object]
  return ctx


def _take(spec: ResetSpec, idx) -> ResetSpec:
  """The rows ``idx`` of a batched ResetSpec."""
  idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
  return ResetSpec(*(None if f is None else f[idx] for f in spec))


def _load_specs(env, args) -> Optional[ResetSpec]:
  if args.init_states and os.path.isfile(args.init_states):
    return task_csv.load_reset_specs(env, args.init_states)
  if args.init_states:
    print(f">>> Couldn't load initial states from {args.init_states}! "
          'Defaulting to random initialization.')
  return None


def _episode_steps(args, default: int) -> int:
  return args.max_episode_steps if args.max_episode_steps > 0 else default


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
  return {k: v.cpu().numpy() for k, v in tensors.items()}


# ---------------------------------------------------------------- collect


def _preroll(env: GeecoEnv, es, P: int, gen: torch.Generator, B: int,
             rows: slice):
  """k ~ U[0, P] random pre-roll steps per env before the expert episode;
  inactive steps apply the no-op action so the batch stays in lockstep.
  The recorded episode starts after it, with the step counter at 0.  The
  draws are made for all B envs of the batch, ``es`` holds its ``rows``."""
  k = torch.randint(0, P + 1, (B,), generator=gen)[rows]
  acts = (torch.rand((B, P, 3), generator=gen) * 2.0 - 1.0)[rows]
  n = k.shape[0]
  for t in range(P):
    act = torch.cat([acts[:, t], torch.zeros(n, 1)], -1)
    act = torch.where((t < k)[:, None], act, torch.zeros(n, 4))
    es = env.step(es, act.to(env.device))
  return es.replace(ts=torch.zeros_like(es.ts))


def run_collect(args):
  wrk_dir = os.path.join(args.wrk_dir, 'collect')
  os.makedirs(wrk_dir, exist_ok=True)
  mesh = _env_mesh(args)
  root = mesh is None or mesh.is_root
  env = build_env(args)
  specs = _load_specs(env, args)
  expert = make_expert(env)
  fmt = getattr(args, 'dataset_formats', 'all')
  state_only = fmt == 'states'
  if state_only and args.rendering_mode not in ('none', ''):
    # frameless collection records qpos only: no frames exist to feed a
    # video/tfrecord sink ('tfrecord' is the argparse default, so a hard
    # error would reject plain `--dataset_formats states` invocations)
    print(f'WARNING: --dataset_formats states records no frames; '
          f'rendering_mode={args.rendering_mode} output will not be '
          f'produced')
  if state_only and getattr(args, 'background_video', ''):
    raise SystemExit('--background_video is incompatible with '
                     '--dataset_formats states: per-step background '
                     'texels are not recorded, so re-rendered training '
                     'frames could not reproduce them')
  # viewer mode needs frames too (live playback of the recorded episode)
  with_frames = (not state_only
                 and args.rendering_mode in ('tfrecord', 'viewer'))
  fast = fmt in ('npz', 'states')
  record_fn = make_record_fn(env, with_frames=with_frames,
                             with_depth=not fast, with_state=state_only)

  # dataset meta (gym_pickplace.py:744-747); also placed under meta/ to
  # form a ready-to-train dataset directory (geeco_gym.py:283-289 layout)
  for meta_path in (os.path.join(wrk_dir, 'meta_info.json'),
                    os.path.join(wrk_dir, 'meta', 'meta_info.json')):
    if root:                      # one rank writes the shared files
      os.makedirs(os.path.dirname(meta_path), exist_ok=True)
      with open(meta_path, 'w') as fp:
        json.dump(meta_info_dict(env), fp, indent=2, sort_keys=True)

  episode_steps = _episode_steps(args, EPISODE_STEPS_COLLECT)
  env.setup()
  B = max(1, args.num_envs)
  # this rank's envs of each chunk of B (all B in one process)
  rows = slice(0, B) if mesh is None else mesh.rows(B)
  # DART-style noise-injected collection (--expert_noise): executed action
  # = expert + N(0, sigma) on the EE translation (gripper stays clean);
  # recorded cmd = the expert's clean corrective action
  sigma = max(0.0, getattr(args, 'expert_noise', 0.0))
  P = max(0, getattr(args, 'perturb_prefix', 0))
  video = VideoRecorder('collect', wrk_dir) \
      if args.rendering_mode == 'video' and root else None
  viewer = None
  if args.rendering_mode == 'viewer' and root:
    from ..render.viewer import TerminalViewer
    viewer = TerminalViewer()
  cycler = _background_cycler(args, env)
  gen = torch.Generator().manual_seed(args.seed)
  n_specs = 0 if specs is None else int(specs.mocap_qpos.shape[0])
  successes: List[tuple] = []     # (episode_id, task_success)

  def launch(chunk):
    """One chunk's episodes: reset, pre-roll, the expert's rollout."""
    n = min(B, args.end_idx - chunk)
    if specs is not None:
      idx = np.minimum(np.arange(chunk, chunk + B), n_specs - 1)
      es = env.reset_to(_take(specs, idx), gen, rows=rows)
    else:
      es = env.reset_random(B, gen, rows=rows)
    if P > 0:
      es = _preroll(env, es, P, gen, B, rows)
    if args.dry_run:
      return dict(chunk=chunk, n=n, es=es)
    noise = None
    if sigma > 0:
      noise = sigma * torch.randn((B, episode_steps, 3),
                                  generator=gen)[rows]
      noise = torch.cat([noise, torch.zeros(noise.shape[0], episode_steps,
                                            1)], -1)
    es_f, recs = rollout(env, es, expert, length=episode_steps,
                         record_fn=record_fn, action_noise=noise,
                         step_textures=_step_textures(cycler, env,
                                                      episode_steps))
    return dict(chunk=chunk, n=n, es=es, recs=recs,
                metrics=env.eval_metrics(es_f))

  def write_episode(episode_id, rec_k, ctx):
    name = f'replay_buffer_{episode_id:04d}'
    save_episode_npz(os.path.join(wrk_dir, 'data', f'{name}.npz'),
                     rec_k, ctx, compress=not fast)
    if fast:  # npz-only fast path for large training collections
      return
    save_replay_buffer_pkl(os.path.join(wrk_dir, f'{name}.pkl'), env,
                           rec_k, ctx)
    if with_frames:  # reference-format zlib TFRecord (native encoder)
      write_episode_tfrecord(
          os.path.join(wrk_dir, 'data', f'{name}.tfrecord.zlib'), rec_k,
          ctx)

  def drain(job, pool, futures):
    """Pull one finished chunk to the host and hand its episodes to the
    writers; returns their futures."""
    chunk, n = job['chunk'], job['n']
    # this rank's envs of the chunk's n episodes: (local k, global index)
    mine = [(k, g) for k, g in enumerate(range(rows.start, rows.stop))
            if g < n]
    if args.dry_run:  # save initial configuration images only
      from PIL import Image
      rgb, _ = env.render(job['es'])
      rgb = rgb.cpu().numpy()
      for k, g in mine:
        Image.fromarray(rgb[k]).save(
            os.path.join(wrk_dir, f'init_{chunk + g + 1:04d}.png'))
      return []
    recs = _host(job['recs'])
    metrics = _host(job['metrics'])
    es = job['es']
    rgba = es.rgba.cpu().numpy()
    goals, objs = es.task_goal.tolist(), es.task_object.tolist()
    for fu in futures:
      fu.result()   # the previous chunk's writers: surface their errors
    futures = []
    for k, g in mine:
      episode_id = chunk + g + 1
      rec_k = {key: v[k] for key, v in recs.items()}
      ctx = _episode_context(env, goals[k], objs[k])
      if sigma > 0:
        ctx['expert_noise'] = sigma   # provenance: DART episode
      if state_only:
        # per-episode recolour table: with full_qpos + mocap this is the
        # complete render input (GeecoEnv.render_from_qpos)
        rec_k['rgba'] = rgba[k]
      futures.append(pool.submit(write_episode, episode_id, rec_k, ctx))
      if video is not None and 'rgb' in rec_k:
        for frame in rec_k['rgb']:
          video.feed(frame)
        video.flush()
      if viewer is not None and g == 0 and 'rgb' in rec_k:
        for t, frame in enumerate(rec_k['rgb']):
          viewer.feed(frame, hud=f'episode {episode_id} t={t}')
      success = float(metrics['task_success'][k])
      successes.append((episode_id, success))
      print(f'episode {episode_id}: task_success={success:.0f} '
            f'goal_dist={float(metrics["goal_dist"][k]):.4f}')
    return futures

  # the writers of chunk k run while chunk k+1 is simulated
  with ThreadPoolExecutor(max_workers=4) as pool:
    futures = []
    for chunk in range(args.start_idx, args.end_idx, B):
      futures = drain(launch(chunk), pool, futures)
    for fu in futures:
      fu.result()
  if video is not None:
    video.finalize()
  if viewer is not None:
    viewer.close()
  if mesh is not None:          # every rank's episodes, in episode order
    successes = sorted(sum(PM.all_gather_objects(successes, mesh), []))
  successes = [v for _, v in successes]
  if successes and root:
    print(f'>>> expert success rate: {np.mean(successes) * 100:.2f}% '
          f'({len(successes)} episodes)')
  return np.mean(successes) if successes else None


# ---------------------------------------------------------------- replay


def run_replay(args):
  wrk_dir = os.path.join(args.wrk_dir, 'replay')
  os.makedirs(wrk_dir, exist_ok=True)
  env = build_env(args)

  # load recorded commands + initial object/mocap state
  if args.replay_buffer.endswith('.pkl'):
    with open(args.replay_buffer, 'rb') as f:
      rb = pickle.load(f)
    cmd_buffer = np.stack(rb['cmd_buffer'])
    obj_qpos0 = {k: np.asarray(v[0])
                 for k, v in rb['object_qpos_buffer'].items()}
    mocap0 = np.asarray(rb['mocap_qpos_buffer']['robot0:mocap'][0])
  else:
    ep, _ = load_episode(args.replay_buffer)
    cmd_buffer = ep['cmd']
    obj_qpos0 = {j: ep[f'object_qpos-{j}'][0] for j in env.obj_joint_names}
    mocap0 = ep['mocap_qpos-robot0:mocap'][0]

  obj_qpos = np.stack([obj_qpos0[j] for j in env.obj_joint_names])
  # reset_to adds the queue z-adjust; replay sets raw state, so undo it
  obj_qpos = obj_qpos.copy()
  obj_qpos[:, 2] -= 0.025
  spec = ResetSpec(obj_qpos=torch.as_tensor(obj_qpos[None],
                                            dtype=torch.float32),
                   mocap_qpos=torch.as_tensor(mocap0[None],
                                              dtype=torch.float32),
                   task_goal=torch.zeros(1, dtype=torch.int64),
                   task_object=torch.zeros(1, dtype=torch.int64))
  es = env.reset_to(spec)
  cmds = torch.as_tensor(np.asarray(cmd_buffer, np.float32),
                         device=env.device)
  for t in range(cmds.shape[0]):
    es = env.step(es, cmds[t:t + 1])
  m = _host(env.eval_metrics(es))
  print(f'>>> replay: task_success={float(m["task_success"][0]):.0f} '
        f'goal_dist={float(m["goal_dist"][0]):.4f}')
  return m


# ---------------------------------------------------------------- random


def run_random(args):
  env = build_env(args)
  gen = torch.Generator().manual_seed(args.seed)
  es = env.reset_random(1, gen)
  for _ in range(_episode_steps(args, EPISODE_STEPS_COLLECT)):
    action = torch.cat([torch.randn((1, 3), generator=gen) * 0.5,
                        torch.randint(-1, 2, (1, 1), generator=gen).float()],
                       -1)
    es = env.step(es, action.to(env.device))
  if not bool(torch.isfinite(es.phys.qpos).all()):
    raise RuntimeError('physics diverged')
  print('>>> random wiggle smoke test OK')
  return es


# ---------------------------------------------------------------- controller


def _dataset_eval_set(env, dataset_dir: str, split_name: str, n_eps: int):
  """Queued resets + recorded target frames from the test split.

  The reference controller protocol (gym_pickplace.py:655) replays recorded
  initial states and conditions on the episode's target frame; here both
  come straight from collected episodes.  Returns (ResetSpec of N rows,
  goal frames [N, H, W, 3] float32 in [0, 1], goal depths [N, H, W] or
  None, N).
  """
  from ..data.dataset import list_records
  paths = list_records(dataset_dir, split_name, 'test')
  if n_eps > 0:
    paths = paths[:n_eps]
  objq, mocapq, armq, goals, objs, tgts, tgt_depths = ([] for _ in range(7))
  render_states = []   # state-only episodes: goal frames re-rendered below
  for p in paths:
    ep, ctx = load_episode(p)
    oq = np.stack([np.asarray(ep[f'object_qpos-{j}'][0])
                   for j in env.obj_joint_names])
    oq = oq.copy()
    oq[:, 2] -= 0.025          # reset_to re-adds the table-height adjust
    objq.append(oq)
    mocapq.append(np.asarray(ep['mocap_qpos-robot0:mocap'][0]))
    armq.append(np.asarray([ep[f'joint_qpos-{j}'][0]
                            for j in env.monitored_joints]))
    goals.append(env.goal_sites.index(ctx['task_goal']))
    objs.append(env.cube_sites.index(ctx['task_object']))
    if 'rgb' in ep:
      tgts.append(ep['rgb'][-1].astype(np.float32) / 255.0)
      if 'depth' in ep:
        tgt_depths.append(np.asarray(ep['depth'][-1], np.float32))
    elif 'full_qpos' in ep:
      # placeholder keeps tgts aligned with the path order when the split
      # mixes frame-mode and state-only episodes; filled in after the
      # batched re-render below
      tgts.append(None)
      render_states.append((len(tgts) - 1,
                            np.asarray(ep['full_qpos'][-1], np.float32),
                            np.asarray(ep['mocap_qpos-robot0:mocap'][-1],
                                       np.float32),
                            np.asarray(ep['rgba'], np.float32)))
    else:
      raise ValueError(f'{p}: episode has neither frames nor full_qpos')
  if render_states:
    # re-render the goal frames on the device from the recorded final
    # states (state-only datasets; the frame-mode recording's pixels)
    env.setup()
    slots = [r[0] for r in render_states]
    as_t = lambda i: torch.as_tensor(np.stack([r[i] for r in render_states]),
                                     device=env.device)
    rq, rm, rr = as_t(1), as_t(2), as_t(3)
    rendered = []
    for s in range(0, rq.shape[0], 64):
      rgb, _ = env.render_from_qpos(rq[s:s + 64], rm[s:s + 64],
                                    rr[s:s + 64])
      rendered.extend(rgb.cpu().numpy().astype(np.float32) / 255.0)
    for slot, frame in zip(slots, rendered):
      tgts[slot] = frame
  specs = ResetSpec(
      obj_qpos=torch.as_tensor(np.stack(objq), dtype=torch.float32),
      mocap_qpos=torch.as_tensor(np.stack(mocapq), dtype=torch.float32),
      task_goal=torch.as_tensor(goals, dtype=torch.int64),
      task_object=torch.as_tensor(objs, dtype=torch.int64),
      # restore the recorded arm/gripper pose: settling the default pose
      # against the recorded mocap does not reach it (see ResetSpec)
      arm_qpos=torch.as_tensor(np.stack(armq), dtype=torch.float32))
  depths = (np.stack(tgt_depths) if len(tgt_depths) == len(paths) else None)
  return specs, np.stack(tgts), depths, len(paths)


def _goal_frames(config, tgt_all, tgt_depth_all, idx, device):
  """Goal frames [n, H, W, C] of rows ``idx`` on the device (RGB-D models
  get the recorded depth, or zeros with a warning)."""
  tgt = torch.as_tensor(tgt_all[idx], device=device)
  if config.img_channels == 4:
    if tgt_depth_all is not None:
      d = torch.as_tensor(tgt_depth_all[idx], device=device)[..., None]
    else:
      # episodes recorded without depth: an RGB-D policy was trained on
      # real goal depth; the reference conditions on the recorded frame
      print('WARNING: dataset episodes have no depth channel; '
            'zero-filling the goal depth for an RGBD model')
      d = torch.zeros(tgt.shape[:-1] + (1,), device=device)
    tgt = torch.cat([tgt, d], -1)
  return tgt


def _make_predictor(args):
  from ..models.predictor import E2EVMCPredictor, GoalE2EVMCPredictor
  if args.goal_condition == 'none':
    cls = E2EVMCPredictor
  elif args.goal_condition == 'target':
    cls = GoalE2EVMCPredictor
  else:
    raise ValueError(f'unknown goal condition {args.goal_condition}')
  return cls(args.model_dir, args.checkpoint_name,
             carry_mode=getattr(args, 'carry_mode', 'auto'),
             device=getattr(args, 'device', None))


def run_controller_batched(args):
  """Closed-loop eval of --num_envs envs on the device: policy + physics +
  render for the whole batch, the host reading only the metrics.  With
  --dataset_dir set, resets and goal frames come from the test split
  (reference protocol); otherwise resets are random and goal frames are
  synthesized renders."""
  from ..models.closed_loop import evaluate_batched

  wrk_dir = os.path.join(args.wrk_dir, 'controller')
  os.makedirs(wrk_dir, exist_ok=True)
  mesh = _env_mesh(args)
  root = mesh is None or mesh.is_root
  env = build_env(args)
  goal_conditioned = args.goal_condition == 'target'
  predictor = _make_predictor(args)
  config, model = predictor.cfg, predictor.model
  carry_mode = getattr(args, 'carry_mode', 'auto')

  B = args.num_envs
  rows = None if mesh is None else mesh.rows(B)   # this rank's envs
  n_eps = args.end_idx - args.start_idx
  specs = tgt_all = tgt_depth_all = None
  if args.dataset_dir:
    specs, tgt_all, tgt_depth_all, n_eps = _dataset_eval_set(
        env, args.dataset_dir, getattr(args, 'split_name', 'default'),
        n_eps)
  env.setup()
  gen = torch.Generator().manual_seed(args.seed)
  episode_steps = _episode_steps(args, EPISODE_STEPS_CONTROL)
  cycler = _background_cycler(args, env)
  results = []
  # --rendering_mode video: per-episode eval videos for the first chunk's
  # first envs, with real paths in the eval CSV (reference protocol:
  # gym_pickplace.py:941-945, 705-720)
  n_video = 8 if args.rendering_mode == 'video' else 0
  for chunk in range(0, n_eps, B):
    n = min(B, n_eps - chunk)
    V = min(n_video, n) if chunk == 0 else 0
    step_textures = _step_textures(cycler, env, episode_steps)
    rgba = None
    if specs is not None:
      idx = np.minimum(np.arange(chunk, chunk + B), n_eps - 1)
      es0 = env.reset_to(_take(specs, idx), gen, rows=rows)
      rgba = es0.rgba
      if mesh is not None:
        rgba = PM.all_gather_rows(rgba, mesh)
      rgba = rgba.cpu()
      agg = evaluate_batched(
          env, config, model, goal_conditioned, B,
          tgt_frames=_goal_frames(config, tgt_all, tgt_depth_all,
                                  idx if rows is None else idx[rows],
                                  env.device),
          n_steps=episode_steps, es0=es0, step_textures=step_textures,
          carry_mode=carry_mode, collect_frames=V, mesh=mesh)
    else:
      agg = evaluate_batched(env, config, model, goal_conditioned, B,
                             generator=gen, n_steps=episode_steps,
                             step_textures=step_textures,
                             carry_mode=carry_mode, collect_frames=V,
                             mesh=mesh)
    frames = None
    if V:
      agg, frames = agg  # [T, V, H, W, 3] uint8
    agg = _host(agg)
    for k in range(n):
      episode_id = args.start_idx + chunk + k + 1
      video_file = ''
      if frames is not None and k < V and root:
        vid = VideoRecorder(f'observation_{episode_id:04d}', wrk_dir)
        for frame in frames[:, k]:
          vid.feed(frame)
        video_file = vid.finalize() or ''
      results.append({
          'episode_id': episode_id,
          'obj_vicinity': int(agg['obj_vicinity'][k]),
          'grasp_success': int(agg['grasp_success'][k]),
          'task_success': int(agg['task_success'][k]),
          'init_goal_dist': float(agg['max_goal_dist'][k]),
          'min_goal_dist': float(agg['min_goal_dist'][k]),
          'max_goal_dist': float(agg['max_goal_dist'][k]),
          'final_goal_dist': float(agg['final_goal_dist'][k]),
          'video_file': video_file,
          '_steps_grasped': int(agg['steps_grasped'][k]),
          '_max_obj_z': float(agg['max_obj_z'][k]),
          '_drop_goal_dist': float(agg['drop_goal_dist'][k]),
          '_rgba': None if rgba is None else rgba[k],
      })
  if not root:      # rank 0 writes the gathered rows
    return results
  if args.rendering_mode == 'video' and specs is not None:
    _record_failure_videos(args, env, config, model, goal_conditioned,
                           specs, tgt_all, tgt_depth_all, results, wrk_dir)
  _write_triage(wrk_dir, results)
  with open(os.path.join(wrk_dir, 'eval_results.csv'), 'w',
            newline='') as fp:
    writer = csv.DictWriter(fp, fieldnames=EVAL_FIELDS, delimiter=';',
                            extrasaction='ignore')
    writer.writeheader()
    for r in results:
      writer.writerow(r)
  _write_final_results(wrk_dir, results, echo=True)
  return results


def _write_final_results(wrk_dir, rows, echo=False):
  with open(os.path.join(wrk_dir, 'final_results.txt'), 'w') as fp:
    for k in ('obj_vicinity', 'grasp_success', 'task_success'):
      avg = np.mean([r[k] for r in rows]) * 100
      fp.write(f'{k}\t{avg:.2f}\n')
      if echo:
        print(f'>>> {k}: {avg:.2f}%')


# episode phase ladder derived from the triage metrics: how far along
# reach->grasp->lift->transport->place did each episode get?
def _phase_reached(r):
  if r['task_success']:
    return 'placed'
  if r['_drop_goal_dist'] >= 0 and r['_drop_goal_dist'] <= 0.0625:
    return 'dropped_near_goal'
  if r['_max_obj_z'] > 0.47:          # table top ~0.425 + half cube
    return 'lifted'
  if r['grasp_success']:
    return 'grasped'
  if r['obj_vicinity']:
    return 'reached'
  return 'none'


def _write_triage(wrk_dir, rows):
  """Per-episode failure triage: phase-reached ladder + drop distance,
  written beside the reference-format eval CSV."""
  counts = {}
  with open(os.path.join(wrk_dir, 'triage_results.csv'), 'w',
            newline='') as fp:
    writer = csv.writer(fp, delimiter=';')
    writer.writerow(TRIAGE_FIELDS)
    for r in rows:
      phase = _phase_reached(r)
      counts[phase] = counts.get(phase, 0) + 1
      writer.writerow([r['episode_id'], phase, r['_steps_grasped'],
                       f"{r['_max_obj_z']:.4f}",
                       f"{r['_drop_goal_dist']:.4f}",
                       f"{r['min_goal_dist']:.4f}",
                       f"{r['final_goal_dist']:.4f}", r['video_file']])
  order = ('placed', 'dropped_near_goal', 'lifted', 'grasped', 'reached',
           'none')
  summary = '  '.join(f'{p}={counts.get(p, 0)}' for p in order)
  with open(os.path.join(wrk_dir, 'triage_summary.txt'), 'w') as fp:
    fp.write(summary + '\n')
  print(f'>>> phase ladder: {summary}')


def _record_failure_videos(args, env, config, model, goal_conditioned,
                           specs, tgt_all, tgt_depth_all, rows, wrk_dir):
  """Second pass: record videos for FAILING episodes (grasped but not
  placed), not just the first chunk (the reference logs a video per eval
  episode, gym_pickplace.py:941-945)."""
  from ..models.closed_loop import evaluate_batched
  fail = [i for i, r in enumerate(rows)
          if r['grasp_success'] and not r['task_success']]
  if not fail:
    return
  sel = fail[:16]
  idx = np.asarray(sel)
  es0 = env.reset_to(_take(specs, idx))
  # the episodes' own colours, so that each failure reproduces
  es0 = es0.replace(rgba=torch.stack([rows[i]['_rgba'] for i in sel]).to(
      env.device))
  _, frames = evaluate_batched(
      env, config, model, goal_conditioned, len(sel),
      tgt_frames=_goal_frames(config, tgt_all, tgt_depth_all, idx,
                              env.device),
      n_steps=_episode_steps(args, EPISODE_STEPS_CONTROL), es0=es0,
      carry_mode=getattr(args, 'carry_mode', 'auto'),
      collect_frames=len(sel))
  for v, i in enumerate(sel):
    episode_id = rows[i]['episode_id']
    vid = VideoRecorder(f'failure_{episode_id:04d}', wrk_dir)
    for frame in frames[:, v]:
      vid.feed(frame)
    rows[i]['video_file'] = vid.finalize() or rows[i]['video_file']


def run_controller(args):
  if args.num_envs > 1:
    return run_controller_batched(args)

  wrk_dir = os.path.join(args.wrk_dir, 'controller')
  os.makedirs(wrk_dir, exist_ok=True)
  env = build_env(args)
  specs = _load_specs(env, args)
  predictor = _make_predictor(args)

  # target frames aligned with the reset CSV rows (gym_pickplace.py:220-261)
  target_frames = None
  if args.goal_condition == 'target' and args.tfrecord_list:
    with open(args.tfrecord_list) as fp:
      record_names = [l.strip() for l in fp if l.strip()]
    target_frames = [
        load_target_frames(args.dataset_dir, n, load_depth=False)[0]
        for n in record_names]

  episode_steps = _episode_steps(args, EPISODE_STEPS_CONTROL)
  env.setup()
  gen = torch.Generator().manual_seed(args.seed)
  viewer = None
  if args.rendering_mode == 'viewer':   # live display
    from ..render.viewer import TerminalViewer
    viewer = TerminalViewer()
  eval_results = []
  with open(os.path.join(wrk_dir, 'eval_results.csv'), 'w',
            newline='') as csv_report:
    writer = csv.DictWriter(csv_report, fieldnames=EVAL_FIELDS,
                            delimiter=';')
    writer.writeheader()
    for i in range(args.start_idx, args.end_idx):
      episode_id = i + 1
      es = (env.reset_to(_take(specs, [i]), gen) if specs is not None
            else env.reset_random(1, gen))
      spec_row = {
          'episode_id': episode_id, 'obj_vicinity': 0, 'grasp_success': 0,
          'task_success': 0,
          'init_goal_dist': float(env.eval_metrics(es)['goal_dist'][0]),
          'min_goal_dist': 1000.0, 'max_goal_dist': 0.0,
          'final_goal_dist': 0.0, 'video_file': '',
      }
      video = VideoRecorder(f'observation_{episode_id:04d}', wrk_dir) \
          if args.rendering_mode == 'video' else None
      predictor.reset()
      if args.goal_condition == 'target' and target_frames is not None:
        predictor.set_goal(np.asarray(target_frames[i], np.float32))
      for t in range(episode_steps):
        rgb, depth = env.render(es)
        rgb = rgb[0].cpu().numpy()
        if video is not None:
          video.feed(rgb)
        if viewer is not None:
          viewer.feed(rgb, hud=f'episode {episode_id} t={t}')
        obs_frame = rgb.astype(np.float32) / 255.0
        if args.observation_format == 'rgbd':
          obs_frame = np.concatenate(
              [obs_frame, depth[0].cpu().numpy()[..., None]], axis=-1)
        proprio = env.proprioception(es)[0].cpu().numpy()
        pred = predictor.predict(obs_frame, proprio)
        action = np.concatenate([pred['cmd_ee'], pred['cmd_grp']])
        es = env.step(es, torch.as_tensor(action[None], dtype=torch.float32,
                                          device=env.device))
        m = _host(env.eval_metrics(es))
        spec_row['obj_vicinity'] = max(spec_row['obj_vicinity'],
                                       int(m['obj_vicinity'][0]))
        spec_row['grasp_success'] = max(spec_row['grasp_success'],
                                        int(m['grasp_success'][0]))
        gd = float(m['goal_dist'][0])
        spec_row['min_goal_dist'] = min(spec_row['min_goal_dist'], gd)
        spec_row['max_goal_dist'] = max(spec_row['max_goal_dist'], gd)
      m = _host(env.eval_metrics(es))
      spec_row['final_goal_dist'] = float(m['goal_dist'][0])
      spec_row['task_success'] = int(m['task_success'][0])
      if video is not None:
        spec_row['video_file'] = video.finalize() or ''
      eval_results.append(spec_row)
      for k in ('obj_vicinity', 'grasp_success', 'task_success'):
        avg = np.mean([r[k] for r in eval_results]) * 100
        print(f'>>> Current average success rate for {k}: {avg:.2f}')
      writer.writerow(spec_row)
  if viewer is not None:
    viewer.close()
  _write_final_results(wrk_dir, eval_results)
  return eval_results


# the modes that shard their env batch over --num_devices (the JAX
# package's _env_mesh users)
SHARDED_MODES = ('collect', 'controller')


def main(args):
  wrk_dir = os.path.join(args.wrk_dir, args.sim_mode)
  n = getattr(args, 'num_devices', 1)
  sharded = n > 1 and args.sim_mode in SHARDED_MODES
  if sharded and PM.make_mesh(None).size > 1:
    return _rank_main(args)                 # a rank that launch started
  os.makedirs(wrk_dir, exist_ok=True)
  save_run_command(argparser=args._parser, run_dir=wrk_dir,
                   argv=getattr(args, '_argv', None))
  if not sharded:
    return _run_mode(args)
  B = max(1, args.num_envs)
  if B % n:
    raise SystemExit(f'--num_envs {B} not divisible by --num_devices {n}')
  ranks_args = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                     if k != '_parser'})
  return PM.launch(_rank_main, n, ranks_args, device=args.device,
                   init_dir=wrk_dir)


def _rank_main(args):
  """One rank of a --num_devices run: the mode on this rank's device."""
  args.device = str(PM.make_mesh(args.num_devices).device)
  return _run_mode(args)


def _run_mode(args):
  modes = {'collect': run_collect, 'replay': run_replay,
           'random': run_random, 'controller': run_controller}
  if args.sim_mode not in modes:
    raise ValueError(f'Unknown simulation mode: {args.sim_mode}')
  return modes[args.sim_mode](args)
