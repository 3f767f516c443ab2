"""Checkpointing + best-K snapshot manager (PyTorch).

Counterpart of ``geeco_tpu/models/snapshots.py``, with its reference
semantics (scripts/train_e2evmc.py:143-205, 221-224):
  * rolling step checkpoints in <model_dir>/ckpt-<step>
  * after each epoch's eval, export the latest checkpoint into
    <model_dir>/snapshots/<name>/ together with config/runcmd JSONs,
    maintain snapshots/snapshot_index.json [{step, loss, dir}, ...] and
    garbage-collect the worst-loss snapshot beyond num_best_ckpt.

Storage: ``torch.save`` where the JAX package writes flax msgpack.
``ckpt-%08d.pt`` holds the model's ``state_dict``; ``state-%08d.pt`` holds
the model, the optimizer's ``state_dict`` and the step, so a restart
resumes the exact optimization (Adam's moments and its own step count,
which drives the bias correction).  Files are read with
``torch.load(weights_only=True)``.  The port reads no msgpack file: flax
weights enter through ``core.convert.e2evmc_params_from_reference``.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import List, Optional

import torch
from torch import nn


def _cpu_state(model: nn.Module) -> dict:
  return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _rolling_gc(model_dir: str, prefix: str, keep_last: int):
  """Keep the newest ``keep_last`` files <prefix>-*.pt (keep_checkpoint_max
  semantics)."""
  files = sorted(glob.glob(os.path.join(model_dir, f'{prefix}-*.pt')))
  for old in files[:-keep_last]:
    os.remove(old)


def save_checkpoint(model_dir: str, step: int, model: nn.Module,
                    keep_last: int = 2) -> str:
  os.makedirs(model_dir, exist_ok=True)
  path = os.path.join(model_dir, f'ckpt-{step:08d}.pt')
  torch.save(_cpu_state(model), path)
  _rolling_gc(model_dir, 'ckpt', keep_last)
  return path


def latest_checkpoint(model_dir: str) -> Optional[str]:
  ckpts = sorted(glob.glob(os.path.join(model_dir, 'ckpt-*.pt')))
  return ckpts[-1] if ckpts else None


def restore_params(path: str, model: nn.Module) -> nn.Module:
  """Load a checkpoint's weights into ``model`` (in place, on its device)."""
  device = next(model.parameters()).device
  model.load_state_dict(torch.load(path, weights_only=True,
                                   map_location=device))
  return model


def checkpoint_step(path: str) -> int:
  base = os.path.basename(path)
  return int(base.split('-')[1].split('.')[0])


# ------------------------------------------------- full train-state ckpts


def save_train_state(model_dir: str, step: int, train_state,
                     keep_last: int = 2) -> str:
  """Model + optimizer state + step, so a watchdog restart resumes the
  exact optimization trajectory (a params-only restore silently resets the
  Adam moments every restart)."""
  os.makedirs(model_dir, exist_ok=True)
  payload = {'model': _cpu_state(train_state.model),
             'optimizer': train_state.optimizer.state_dict(),
             'step': int(train_state.step)}
  path = os.path.join(model_dir, f'state-{step:08d}.pt')
  torch.save(payload, path)
  _rolling_gc(model_dir, 'state', keep_last)
  return path


def latest_train_state(model_dir: str) -> Optional[str]:
  states = sorted(glob.glob(os.path.join(model_dir, 'state-*.pt')))
  return states[-1] if states else None


def restore_train_state(path: str, train_state):
  """Restore a TrainState saved by save_train_state into ``train_state``'s
  model and optimizer (in place; the moments land on the model's device)
  and return it with the saved step."""
  device = next(train_state.model.parameters()).device
  payload = torch.load(path, weights_only=True, map_location=device)
  train_state.model.load_state_dict(payload['model'])
  opt = payload['optimizer']
  for st in opt['state'].values():
    # Adam keeps its step count on the CPU unless it is capturable/fused
    if 'step' in st:
      st['step'] = st['step'].cpu()
  train_state.optimizer.load_state_dict(opt)
  return train_state.replace(step=int(payload['step']))


# ------------------------------------------------------------- snapshots


def _index_path(model_dir: str) -> str:
  return os.path.join(model_dir, 'snapshots', 'snapshot_index.json')


def load_snapshot_index(model_dir: str) -> List[dict]:
  p = _index_path(model_dir)
  if os.path.exists(p):
    with open(p) as fp:
      return json.load(fp)
  return []


def export_snapshot(model_dir: str, eval_loss: float,
                    num_best: int = 3) -> Optional[str]:
  """Copy the latest checkpoint into snapshots/, keep the best-K by loss."""
  ckpt = latest_checkpoint(model_dir)
  if ckpt is None:
    return None
  step = checkpoint_step(ckpt)
  name = f'snapshot-{step:08d}'
  snap_dir = os.path.join(model_dir, 'snapshots', name)
  os.makedirs(snap_dir, exist_ok=True)
  shutil.copy(ckpt, snap_dir)
  # copy config + runcmd JSONs alongside (train_e2evmc.py:176)
  for fn in os.listdir(model_dir):
    if fn.endswith('config.json') or fn.endswith('runcmd.json'):
      shutil.copy(os.path.join(model_dir, fn), snap_dir)

  index = load_snapshot_index(model_dir)
  index = [e for e in index if e['step'] != step]
  index.append({'step': step, 'loss': float(eval_loss), 'dir': snap_dir})
  index.sort(key=lambda e: e['loss'])
  # GC worst beyond num_best
  while len(index) > num_best:
    worst = index.pop()
    if os.path.isdir(worst['dir']):
      shutil.rmtree(worst['dir'])
  with open(_index_path(model_dir), 'w') as fp:
    json.dump(index, fp, indent=2)
  return snap_dir


def best_snapshot(model_dir: str) -> Optional[str]:
  index = load_snapshot_index(model_dir)
  if not index:
    return None
  best = min(index, key=lambda e: e['loss'])
  ckpts = glob.glob(os.path.join(best['dir'], 'ckpt-*.pt'))
  return ckpts[0] if ckpts else None
