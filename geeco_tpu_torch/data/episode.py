"""Episode capture: per-step records on the device -> host episode archives.

Counterpart of ``geeco_tpu/data/episode.py``, with its schema parity with
``PickAndPlaceEncodingV4`` (reference: src/data/geeco_gym.py:54-158):
per-frame keys step/ts/rgb/depth/cmd/ctrl, per-joint qpos/qvel, mocap qpos,
per-object qpos and the task goal/object qpos.  Recording happens with the
PRE-step state and the action about to be applied (reference order:
pickplace.py:326-340).

``make_record_fn`` returns the per-step record function that
``expert.policies.rollout`` calls once a control step with the batched
state; its records are [B, ...] tensors on the env's device, stacked by the
rollout into [B, T, ...].  Every key has the JAX package's dtype (``step``
int32, pixels uint8, the rest float32): a dataset is a file format, and a
JAX reader sees no difference.

Storage as in the JAX package, key for key: ``.npz`` with a JSON context
sidecar (compressed unless asked otherwise), the reference's zlib TFRecord
(``data/tfrecord_io.py``) and the reference replay pickle.  The loaders are
numpy.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict

import numpy as np
import torch

from ..core.model import get_joint_qpos
from ..envs.base import EnvState, GeecoEnv


def meta_info_dict(env: GeecoEnv) -> Dict:
  """Dataset meta (reference: pickplace.py:156-166)."""
  return {
      'episode_length': 100,
      'img_height': env.renderer.height,
      'img_width': env.renderer.width,
      'shapes': env.shapes,
      'monitored_joints': list(env.monitored_joints),
      'actuated_joints': list(env.actuated_joints),
      'monitored_mocaps': ['robot0:mocap'],
      'monitored_objects': list(env.obj_joint_names),
      'dim_cmd': 4,
      'dim_ctrl': len(env.actuated_joints),
      # a state-only dataset is re-rendered at train time, so non-default
      # rendering (--shadows/--tex_grid/--renderer_trim) is recorded for the
      # re-rendered pixels to be the collected ones
      'renderer_kwargs': dict(env.renderer_kwargs),
  }


def make_record_fn(env: GeecoEnv, with_frames: bool = True,
                   with_depth: bool = True, with_state: bool = False):
  """Per-step record function for ``expert.policies.rollout(record_fn=)``.

  with_frames renders the batch (one raster-kernel launch a step on the
  card); with_state records the full ``qpos`` vector per step: with the
  recorded mocap pose and the episode's recolour table that is enough to
  re-render the exact frame later (``GeecoEnv.render_from_qpos``).
  """
  m = env.model
  goal_idx = [env.obj_joint_names.index(f'{s}:joint') for s in env.goal_sites]
  cube_idx = [env.obj_joint_names.index(f'{s}:joint') for s in env.cube_sites]

  def record(env_, es: EnvState, action: torch.Tensor, xs,
             textures=None) -> Dict[str, torch.Tensor]:
    if textures is not None:
      raise NotImplementedError('per-step background textures are not '
                                'ported (ROADMAP Queue 1 item 17)')
    phys = es.phys
    rec = {
        'step': es.ts.to(torch.int32),
        'ts': phys.time.to(torch.float32),
        'cmd': action.to(torch.float32),
        'ctrl': phys.ctrl,
    }
    if with_state:
      rec['full_qpos'] = phys.qpos
    if with_frames:
      rgb, depth = env.render(es)
      rec['rgb'] = rgb
      if with_depth:
        rec['depth'] = depth.to(torch.float32)
    for jname in env.monitored_joints:
      j = m.joint(jname)
      rec[f'joint_qpos-{jname}'] = phys.qpos[:, m.jnt_qposadr[j]]
      rec[f'joint_qvel-{jname}'] = phys.qvel[:, m.jnt_dofadr[j]]
    rec['mocap_qpos-robot0:mocap'] = torch.cat(
        [phys.mocap_pos[:, 0], phys.mocap_quat[:, 0]], -1)
    obj_qpos = []
    for jname in env.obj_joint_names:
      q = get_joint_qpos(m, phys.qpos, jname)
      rec[f'object_qpos-{jname}'] = q
      obj_qpos.append(q)
    obj_qpos = torch.stack(obj_qpos, 1)               # [B, n_objs, 7]
    rows = torch.arange(obj_qpos.shape[0], device=obj_qpos.device)
    rec['goal_qpos'] = obj_qpos[:, goal_idx][rows, es.task_goal]
    rec['obj_qpos'] = obj_qpos[:, cube_idx][rows, es.task_object]
    return rec

  return record


def save_episode_npz(path: str, records: Dict, context: Dict,
                     compress: bool = True):
  """Write stacked per-step records + context sidecar."""
  arrays = {k: np.asarray(v) for k, v in records.items()}
  os.makedirs(os.path.dirname(path), exist_ok=True)
  if compress:
    np.savez_compressed(path, **arrays)
  else:
    np.savez(path, **arrays)
  with open(path.replace('.npz', '.json'), 'w') as fp:
    json.dump(context, fp, indent=2, sort_keys=True)


def load_episode_npz(path: str):
  data = dict(np.load(path))
  ctx_path = path.replace('.npz', '.json')
  context = {}
  if os.path.exists(ctx_path):
    with open(ctx_path) as fp:
      context = json.load(fp)
  return data, context


def load_episode_tfrecord(path: str):
  """Load one episode from a reference-format ``.tfrecord[.zlib]`` file
  into the same stacked-array dict ``load_episode_npz`` returns, so a
  dataset collected by the reference stack trains directly
  (reference contract: src/data/geeco_gym.py:401 parses these
  SequenceExamples; writer side: tfrecord_io.write_episode_tfrecord)."""
  from .tfrecord_io import read_tfrecord
  comp = 'zlib' if path.endswith('.zlib') else 'none'
  examples = read_tfrecord(path, compression=comp)
  if not examples:
    raise ValueError(f'no SequenceExample in {path}')
  raw_ctx, lists = examples[0]
  # keys that are scalar strings in the npz JSON-sidecar schema; every
  # other bytes_list context entry stays a list even when it has one
  # element (monitored_mocaps=['robot0:mocap'] must not collapse to a str
  # whose iteration yields characters)
  _scalar_str_keys = {'task_goal', 'task_object', 'encoding', 'scenario',
                      'task'}
  context = {}
  for key, val in raw_ctx.items():
    if isinstance(val, list):  # bytes_list -> str / list[str]
      decoded = [v.decode() for v in val]
      if key in _JSON_CONTEXT_KEYS and len(decoded) == 1:
        context[key] = json.loads(decoded[0])
        continue
      context[key] = (decoded[0]
                      if len(decoded) == 1 and key in _scalar_str_keys
                      else decoded)
    else:
      arr = np.asarray(val)
      context[key] = arr.item() if arr.size == 1 else arr.tolist()
  h = int(context.get('img_height', 0))
  w = int(context.get('img_width', 0))
  data = {}
  for key, frames in lists.items():
    arr = np.stack(frames)  # [T, D]
    if key == 'rgb':
      if not (h and w):
        raise ValueError(f'{path}: rgb present but img_height/img_width '
                         'missing from context')
      data['rgb'] = arr.reshape(len(frames), h, w, 3).astype(np.uint8)
    elif key == 'depth':
      data['depth'] = arr.reshape(len(frames), h, w).astype(np.float32)
    elif (arr.ndim == 2 and arr.shape[1] == 1
          and (key in ('step', 'ts')
               or key.startswith(('joint_qpos-', 'joint_qvel-')))):
      # only known per-frame scalars squeeze back to [T]; vector features
      # that happen to be 1-d (a dim_ctrl=1 'cmd') keep their [T, 1] shape
      # to match the npz schema
      data[key] = arr[:, 0]
    else:
      data[key] = arr
  return data, context


_RECORD_EXTS = ('.npz', '.tfrecord.zlib', '.tfrecord')
# dict-valued context entries, stored in a TFRecord as their JSON text
_JSON_CONTEXT_KEYS = ('renderer_kwargs',)


def load_episode(path: str):
  """Extension dispatch: npz or reference tfrecord."""
  if path.endswith('.npz'):
    return load_episode_npz(path)
  if path.endswith(('.tfrecord', '.tfrecord.zlib')):
    return load_episode_tfrecord(path)
  raise ValueError(f'unknown episode record format: {path}')


def save_replay_buffer_pkl(path: str, env: GeecoEnv, records: Dict,
                           context: Dict):
  """Reference-compatible replay pickle (pickplace.py:226-246)."""
  rb = {
      'monitored_joints': list(env.monitored_joints),
      'actuated_joints': list(env.actuated_joints),
      'monitored_mocaps': ['robot0:mocap'],
      'monitored_objects': list(env.obj_joint_names),
      'step_buffer': list(np.asarray(records['step'])),
      'time_elapsed': list(np.asarray(records['ts'])),
      'rgb_buffer': [],
      'cmd_buffer': [np.asarray(c) for c in np.asarray(records['cmd'])],
      'ctrl_buffer': [np.asarray(c) for c in np.asarray(records['ctrl'])],
      'joint_qpos_buffer': {
          j: list(np.asarray(records[f'joint_qpos-{j}']))
          for j in env.monitored_joints},
      'joint_qvel_buffer': {
          j: list(np.asarray(records[f'joint_qvel-{j}']))
          for j in env.monitored_joints},
      'mocap_qpos_buffer': {
          'robot0:mocap':
          [np.asarray(q) for q in
           np.asarray(records['mocap_qpos-robot0:mocap'])]},
      'object_qpos_buffer': {
          j: [np.asarray(q) for q in
              np.asarray(records[f'object_qpos-{j}'])]
          for j in env.obj_joint_names},
  }
  with open(path, 'wb') as f:
    pickle.dump(rb, f)
