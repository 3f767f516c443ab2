"""E2E-VMC training CLI (PyTorch).

Counterpart of ``geeco_tpu/run/train_e2evmc.py`` and of the reference
trainer (scripts/train_e2evmc.py:22-302): epoch-wise train/eval over the
dataset pipeline, goal_condition dispatch, config JSON persistence with
load-if-exists precedence (a resumed run cannot silently change
architecture, :229-252), rolling checkpoints and the best-K snapshot
manager.  Metrics stream to a metrics.jsonl in the model dir.

A state-only dataset (collect ``--dataset_formats states``) is detected
from its first record and re-rendered on the device through
``GeecoEnv.render_from_qpos``, with the renderer options its meta records.
Runs on ``--device`` (default: the card).

  python -m geeco_tpu_torch.run.train_e2evmc --dataset_dir D \\
      --model_dir M --goal_condition target [--device cpu] [--num_devices N]

``--num_devices N`` trains data-parallel on N devices, one process each
(parallel/mesh.py: N ranks spawned here, NCCL on cuda:0..N-1 or gloo on
the CPU, joined through a file in the model dir): every rank reads the same
batches, takes its part (``models.train.shard_batch``), and the gradients
are all-reduced to the global-batch mean, so N ranks take the steps one
rank takes on the whole batch.  Rank 0 alone writes the config,
checkpoints, metrics.jsonl and snapshots; a stop (STOP file, RSS limit) is
taken by all ranks together.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
from typing import Dict

import numpy as np
import torch

ARGPARSER = argparse.ArgumentParser(description='Train E2E-VMC (PyTorch).')
ARGPARSER.add_argument('--model_dir', type=str, default='../models/e2evmc')
ARGPARSER.add_argument('--dataset_dir', type=str, required=False,
                       default='../data/gym-pick-pad2-cube2-v4')
ARGPARSER.add_argument('--split_name', type=str, default='default')
ARGPARSER.add_argument('--goal_condition', type=str, default='none',
                       help='none | target')
ARGPARSER.add_argument('--control_mode', type=str, default='cartesian')
ARGPARSER.add_argument('--proc_obs', type=str, default='sequence')
ARGPARSER.add_argument('--proc_tgt', type=str, default='constant')
ARGPARSER.add_argument('--observation_format', type=str, default='rgb')
ARGPARSER.add_argument('--window_size', type=int, default=4)
ARGPARSER.add_argument('--batch_size', type=int, default=32)
ARGPARSER.add_argument('--lr', type=float, default=1e-4)
ARGPARSER.add_argument('--lambda_aux', type=float, default=1.0)
ARGPARSER.add_argument('--num_epochs', type=int, default=10)
ARGPARSER.add_argument('--ckpt_steps', type=int, default=10000)
ARGPARSER.add_argument('--num_last_ckpt', type=int, default=2)
ARGPARSER.add_argument('--num_best_ckpt', type=int, default=3)
ARGPARSER.add_argument('--log_steps', type=int, default=100)
ARGPARSER.add_argument('--num_devices', type=int, default=1)
ARGPARSER.add_argument('--seed', type=int, default=0)
ARGPARSER.add_argument('--max_steps_per_epoch', type=int, default=-1)
ARGPARSER.add_argument('--max_total_steps', type=int, default=-1,
                       help='stop once the resumed global step reaches '
                            'this (the watchdog-restart stop criterion)')
ARGPARSER.add_argument('--train_mode', type=str, default='episode',
                       help="'episode' trains on whole-episode batches "
                            "(balanced gradients + true BPTT); 'window' "
                            "reproduces the reference's consecutive-window "
                            "batches (geeco_gym.py:465-472)")
ARGPARSER.add_argument('--episodes_per_batch', type=int, default=8)
ARGPARSER.add_argument('--chunk_windows', type=int, default=8,
                       help='windows per conv mega-pass in episode mode')
ARGPARSER.add_argument('--loss_weighting', type=str, default='none',
                       choices=['none', 'cmd_mag'],
                       help='episode-mode command-loss window weighting '
                            '(cmd_mag re-focuses on large-action approach '
                            'windows; see models/params.py)')
ARGPARSER.add_argument('--start_boost', type=float, default=1.0,
                       help='multiply the command-loss weight of the first '
                            '--start_boost_windows windows of every episode '
                            '(closed-loop start-basin escape; '
                            'models/params.py start_boost)')
ARGPARSER.add_argument('--start_boost_windows', type=int, default=13)
ARGPARSER.add_argument('--aug_shift', type=int, default=0,
                       help='train-time random per-episode image '
                            'translation in pixels (episode mode only)')
ARGPARSER.add_argument('--renderer_trim', type=str, default='',
                       help='K1,K2: override the re-render binning caps '
                       '(coarse_k,mid_k) for state-only training. Only use '
                       'values that keep the frames pixel-exact for the '
                       'scene (pad2-cube2: down to 96,48): then the '
                       're-rendered frames are bit-identical to the '
                       'frame-mode collect, just cheaper to bin.')
ARGPARSER.add_argument('--max_rss_gb', type=float, default=100.0,
                       help='checkpoint and exit(3) when host RSS exceeds '
                            'this, so that a watchdog restart resumes from '
                            'the latest checkpoint')
ARGPARSER.add_argument('--device', type=str, default=None,
                       help='torch device (default: the card, cuda)')


def parse(argv=None) -> argparse.Namespace:
  """Parse ``argv`` (default: the command line) for ``main``."""
  args, _ = ARGPARSER.parse_known_args(argv)
  args._parser, args._argv = ARGPARSER, argv
  return args


def _rss_gb() -> float:
  with open('/proc/self/statm') as fp:
    return int(fp.read().split()[1]) * os.sysconf('SC_PAGE_SIZE') / 2**30


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
  """A numpy batch on ``device``; int32 index arrays become int64."""
  out = {}
  for k, v in arrays.items():
    t = torch.as_tensor(np.asarray(v))
    if t.dtype == torch.int32:
      t = t.long()
    out[k] = t.to(device)
  return out


def render_env(meta: Dict, renderer_trim: str = '', device=None):
  """The env that re-renders a state-only dataset on ``device``: the meta's
  scene at its frame size, with the renderer options its
  ``renderer_kwargs`` record (any option of ``build_renderer``, as the JAX
  package's meta may name them), the binning caps overridden by
  ``renderer_trim`` ('K1,K2'); set up."""
  from ..envs.base import make_env
  rkw = dict(meta.get('renderer_kwargs', {}))
  if renderer_trim:
    k1, k2 = (int(v) for v in renderer_trim.split(','))
    rkw.update(coarse_k=k1, mid_k=k2)
    print(f'>>> renderer binning trim: coarse_k={k1} mid_k={k2}')
  env = make_env(meta.get('shapes', 'pad2-cube2'),
                 frame_res=(meta['img_height'], meta['img_width']),
                 renderer_kwargs=rkw, device=device)
  env.setup()
  return env


def main(args):
  from ..parallel import mesh as PM
  from ..utils.runscript import save_run_command

  if args.num_devices > 1 and PM.make_mesh(None).size == 1:
    os.makedirs(args.model_dir, exist_ok=True)
    save_run_command(argparser=args._parser, run_dir=args.model_dir,
                     argv=getattr(args, '_argv', None))
    ranks_args = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                       if k != '_parser'})
    return PM.launch(_rank_main, args.num_devices, ranks_args,
                     device=args.device, init_dir=args.model_dir)
  if args.num_devices > 1:                 # a rank that launch started
    return _rank_main(args)
  os.makedirs(args.model_dir, exist_ok=True)
  save_run_command(argparser=args._parser, run_dir=args.model_dir,
                   argv=getattr(args, '_argv', None))
  return train(args)


def _rank_main(args):
  """One rank of a --num_devices run, on this rank's device."""
  from ..parallel import mesh as PM
  args.device = str(PM.make_mesh(args.num_devices).device)
  return train(args)


def train(args):
  """The training run of ``main``, in one process or as one rank."""
  from ..data.dataset import (episode_pipeline, get_meta, input_pipeline,
                              list_records)
  from ..data.episode import load_episode
  from ..models import snapshots
  from ..models.params import (create_e2evmc_config, load_model_config,
                               save_model_config)
  from ..models.train import (make_episode_train_fns, make_train_fns,
                              shard_batch, shard_train_state)
  from ..parallel import mesh as PM
  from ..utils.device import resolve_device

  device = resolve_device(args.device)
  mesh = PM.make_mesh(args.num_devices) if args.num_devices > 1 else None
  root = mesh is None or mesh.is_root

  # --- config: load-if-exists precedence (train_e2evmc.py:229-252)
  config_path = os.path.join(args.model_dir, 'e2evmc_config.json')
  exists = os.path.exists(config_path)
  PM.barrier(mesh)        # every rank has looked before rank 0 writes
  if exists:
    config = load_model_config(config_path)
    print(f'>>> Loaded existing model config from {config_path}')
  else:
    config = create_e2evmc_config({
        'control_mode': args.control_mode,
        'proc_obs': args.proc_obs,
        'proc_tgt': args.proc_tgt,
        'img_channels': 4 if args.observation_format == 'rgbd' else 3,
        'window_size': args.window_size,
        'batch_size': args.batch_size,
        'lr': args.lr,
        'lambda_aux': args.lambda_aux,
        'loss_weighting': args.loss_weighting,
        'start_boost': args.start_boost,
        'start_boost_windows': args.start_boost_windows,
    })
    if root:
      save_model_config(config, config_path)
      print(f'>>> Saved model config to {config_path}')

  goal_conditioned = args.goal_condition == 'target'
  episode_mode = args.train_mode == 'episode'

  # state-only datasets ship qpos trajectories instead of frames; the train
  # step re-renders on the device with the renderer the collect used
  render_fn = None
  first = list_records(args.dataset_dir, args.split_name, 'train')[0]
  ep0, _ = load_episode(first)
  if 'rgb' not in ep0 and 'full_qpos' in ep0:
    if not episode_mode:
      raise SystemExit('state-only datasets require --train_mode episode '
                       '(on-device re-rendering)')
    meta = get_meta(args.dataset_dir)
    env = render_env(meta, args.renderer_trim, device)
    render_fn = env.render_from_qpos
    print('>>> state-only dataset: on-device re-rendering '
          f'({meta.get("shapes", "pad2-cube2")})')
  del ep0

  if episode_mode:
    init_fn, train_step, eval_step, _ = make_episode_train_fns(
        config, goal_conditioned, chunk_windows=args.chunk_windows,
        render_fn=render_fn, aug_pad=args.aug_shift, device=device,
        mesh=mesh)
  else:
    init_fn, train_step, eval_step, _ = make_train_fns(
        config, goal_conditioned, device=device, mesh=mesh)
  ts = init_fn(torch.Generator().manual_seed(args.seed), config.batch_size)

  # resume: prefer a full train state (weights + optimizer moments), fall
  # back to weights-only checkpoints
  latest_state = snapshots.latest_train_state(args.model_dir)
  latest = snapshots.latest_checkpoint(args.model_dir)
  if latest_state:
    ts = snapshots.restore_train_state(latest_state, ts)
    print(f'>>> Resumed train state from {latest_state}')
  elif latest:
    snapshots.restore_params(latest, ts.model)
    ts = ts.replace(step=snapshots.checkpoint_step(latest))
    print(f'>>> Resumed params from {latest}')

  if mesh is not None:      # replicated weights, this rank's carry rows
    ts = shard_train_state(ts, mesh)
  global_step = int(ts.step)
  with_depth = config.img_channels == 4
  part = (lambda b: b) if mesh is None else (lambda b: shard_batch(b, mesh))

  def batches(mode, epoch):
    train = mode == 'train'
    order = dict(seed=args.seed + epoch) if train else dict(shuffle=False)
    if episode_mode:
      for b in episode_pipeline(
          args.dataset_dir, args.split_name, mode,
          batch_episodes=args.episodes_per_batch,
          window_size=config.window_size, fetch_target=goal_conditioned,
          num_epochs=1, with_depth=with_depth,
          aug_shift=args.aug_shift if train else 0, **order):
        yield (to_device(part(b), device),)
    else:
      for f, l in input_pipeline(
          args.dataset_dir, args.split_name, mode,
          window_size=config.window_size, fetch_target=goal_conditioned,
          batch_size=config.batch_size, num_epochs=1,
          with_depth=with_depth, **order):
        yield to_device(part(f), device), to_device(part(l), device)

  def save_ckpt(step):
    if not root:
      return
    snapshots.save_checkpoint(args.model_dir, step, ts.model,
                              keep_last=args.num_last_ckpt)
    snapshots.save_train_state(args.model_dir, step, ts,
                               keep_last=args.num_last_ckpt)

  metrics_path = os.path.join(args.model_dir, 'metrics.jsonl')
  with (open(metrics_path, 'a') if root else
        open(os.devnull, 'w')) as metrics_log:
    for epoch in range(args.num_epochs):
      if 0 < args.max_total_steps <= global_step:
        print(f'>>> reached max_total_steps={args.max_total_steps}; done')
        break
      # ---- train
      t0 = time.time()
      n_steps = 0
      for batch in batches('train', epoch):
        if 0 < args.max_total_steps <= global_step:
          break
        ts, m = train_step(ts, *batch)
        global_step += 1
        n_steps += 1
        if global_step % args.log_steps == 0:
          gc.collect()
          rec = {k: float(v) for k, v in m.items()}
          rec.update(step=global_step, epoch=epoch, split='train',
                     rss_gb=round(_rss_gb(), 2))
          metrics_log.write(json.dumps(rec) + '\n')
          metrics_log.flush()
          print(f'step {global_step}: loss={rec["loss"]:.5f} '
                f'rss={rec["rss_gb"]:.1f}G')
          if PM.any_rank(root and os.path.exists(
              os.path.join(args.model_dir, 'STOP')), mesh):
            save_ckpt(global_step)
            print(f'>>> STOP file present; checkpointed at step '
                  f'{global_step}, exiting 0 (treated as training complete)')
            raise SystemExit(0)
          if PM.any_rank(rec['rss_gb'] > args.max_rss_gb, mesh):
            save_ckpt(global_step)
            print(f'>>> RSS {rec["rss_gb"]:.1f} GiB > --max_rss_gb '
                  f'{args.max_rss_gb}; checkpointed at step {global_step}, '
                  'exiting 3 for the watchdog to restart')
            raise SystemExit(3)
        if global_step % args.ckpt_steps == 0:
          save_ckpt(global_step)
        if 0 < args.max_steps_per_epoch <= n_steps:
          break
      if device.type == 'cuda':
        torch.cuda.synchronize(device)
      sps = n_steps / max(time.time() - t0, 1e-9)
      print(f'epoch {epoch}: {n_steps} steps, {sps:.2f} steps/s')

      # ---- eval + snapshot export (train_e2evmc.py:288-291, 143-205)
      eval_metrics = []
      for batch in batches('eval', epoch):
        m = eval_step(ts, *batch)
        eval_metrics.append({k: float(v) for k, v in m.items()})
        if 0 < args.max_steps_per_epoch <= len(eval_metrics):
          break
      if eval_metrics:
        agg = {k: float(np.mean([m[k] for m in eval_metrics]))
               for k in eval_metrics[0]}
        eval_loss = agg['loss']
        rec = dict(agg, step=global_step, epoch=epoch, split='eval')
        metrics_log.write(json.dumps(rec) + '\n')
        metrics_log.flush()
        save_ckpt(global_step)
        if root:
          snapshots.export_snapshot(args.model_dir, eval_loss,
                                    num_best=args.num_best_ckpt)
        print(f'epoch {epoch}: eval_loss={eval_loss:.5f} '
              + ' '.join(f'{k}={v:.4f}' for k, v in sorted(agg.items())
                         if k != 'loss'))
    save_ckpt(global_step)
  return ts


if __name__ == '__main__':
  main(parse())
