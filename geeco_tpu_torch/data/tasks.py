"""Task-initialization CSV generation and loading.

Counterpart of ``geeco_tpu/data/tasks.py``, the library port of the
reference notebook ``dataset-create_tasks.ipynb``: sample non-colliding
object spawn tuples on the workspace grid, cross with goal x object task
permutations, randomize the gripper start within a small sphere, and export
``init-<scenario>.csv``.  The CSV generation is numpy and draws the JAX
package's numbers from the same seed; ``load_reset_specs`` returns a
``ResetSpec`` of tensors.

CSV format parity (consumed by _load_reset_queue_v2,
scripts/gym_pickplace.py:185-218):
  header: '<jnt>::px;<jnt>::py;...;<jnt>::qz' x joints ';task::goal;task::object'
  joint order: object joints first, robot mocap LAST (the loader treats the
  last joint group as the robot).
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..envs import base as envbase
from ..envs.spawn import compute_grid

_QPOS_FIELDS = ('px', 'py', 'pz', 'qw', 'qx', 'qy', 'qz')


def generate_tasks(shapes: str, num_tasks: int, seed: int = 0,
                   goal_names: Optional[Sequence[str]] = None,
                   object_names: Optional[Sequence[str]] = None
                   ) -> Tuple[List[str], List[List]]:
  """Sample task init rows. Returns (header, rows)."""
  rng = np.random.RandomState(seed)
  mmx, mmy, tiling, goal_off = envbase.SPAWN_DIMS[shapes]
  grid = compute_grid(mmx, mmy, tiling)
  task = 'pushing' if shapes.startswith('push') else 'pickplace'
  z = 0.27 + (0.025 if task == 'pushing' else 0.037)
  robot0 = (envbase.ROBOT_XPOS0_PUSH if task == 'pushing'
            else envbase.ROBOT_XPOS0_PICK)

  # the scene's site names only: compiled on the CPU, never stepped
  env = envbase.GeecoEnv(shapes=shapes, settle_steps=0, device='cpu')
  obj_sites = env.obj_sites
  goal_names = list(goal_names or env.goal_sites)
  object_names = list(object_names or env.cube_sites)

  joint_names = [f'{n}:joint' for n in obj_sites] + ['robot0:mocap']
  header = []
  for jn in joint_names:
    header += [f'{jn}::{f}' for f in _QPOS_FIELDS]
  header += ['task::goal', 'task::object']

  rows = []
  combos = [(g, o) for g in goal_names for o in object_names]
  for i in range(num_tasks):
    idx = rng.choice(len(grid), len(obj_sites), replace=False)
    row = []
    for k, name in enumerate(obj_sites):
      x, y = grid[idx[k]]
      if goal_off and name.startswith('goal'):
        x += goal_off
      row += [x, y, z, 1.0, 0.0, 0.0, 0.0]
    # gripper start: ROBOT_XPOS0 + a point within the sphere, as the JAX
    # package draws it (radius cbrt(u), u ~ U[0, 0.03])
    u = rng.uniform(0, 0.03)
    d = rng.normal(size=3)
    d /= max(np.linalg.norm(d), 1e-9)
    gp = robot0 + d * np.cbrt(u)
    row += [gp[0], gp[1], gp[2], 1.0, 0.0, 1.0, 0.0]
    g, o = combos[i % len(combos)]
    row += [g, o]
    rows.append(row)
  return header, rows


def write_task_csv(path: str, header: List[str], rows: List[List]):
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(path, 'w', newline='') as fp:
    w = csv.writer(fp, delimiter=';')
    w.writerow(header)
    for r in rows:
      w.writerow(r)


def load_reset_specs(env, csv_path: str, start_idx: int = 0,
                     end_idx: int = 10 ** 9) -> 'envbase.ResetSpec':
  """Parse an init CSV into one ResetSpec of N rows (tensors on the CPU:
  obj_qpos [N, n_objs, 7], mocap_qpos [N, 7] float32, task_goal and
  task_object [N] int64).

  Functional equivalent of _load_reset_queue_v2
  (scripts/gym_pickplace.py:185-218).
  """
  with open(csv_path) as fp:
    rows = list(csv.reader(fp, delimiter=';'))
  header, rows = rows[0], rows[1:end_idx + 1 if end_idx < 10 ** 9 else None]
  state_header = header[:-2]
  num_joints = len(state_header) // 7
  joint_names = [state_header[i * 7].split('::')[0]
                 for i in range(num_joints)]

  obj_qpos, mocap, goals, objects = [], [], [], []
  for i, row in enumerate(rows):
    if i < start_idx or i >= end_idx:
      continue
    vals = np.asarray([float(e) for e in row[:-2]], np.float32)
    qpos_list = vals.reshape(num_joints, 7)
    by_name = dict(zip(joint_names, qpos_list))
    obj_qpos.append(np.stack([by_name[jn] for jn in env.obj_joint_names]))
    mocap.append(qpos_list[-1])
    goals.append(env.goal_sites.index(row[-2].split(',')[0]))
    objects.append(env.cube_sites.index(row[-1].split(',')[0]))
  return envbase.ResetSpec(
      obj_qpos=torch.as_tensor(np.stack(obj_qpos)),
      mocap_qpos=torch.as_tensor(np.stack(mocap)),
      task_goal=torch.as_tensor(goals, dtype=torch.int64),
      task_object=torch.as_tensor(objects, dtype=torch.int64))
