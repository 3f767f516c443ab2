"""Cross-engine fidelity of the port: the MuJoCo-recorded pick episodes
replayed open loop through geeco_tpu_torch's ``reset_to`` + ``step`` on the
CPU, held to tests/test_replay_parity.py's bounds.

Each replay is 100 production control steps at B=1 (minutes on the CPU),
so all four run under ``-m slow`` only, as the JAX package's heavy
replays do; tests/test_torch_card_replays.py replays pad2-cube2, clutter4
and nut-cone on the card.
"""

import os

from tests.conftest import REPO_ROOT
import numpy as np
import pytest
import torch

from geeco_tpu_torch.envs.base import ResetSpec, make_env

FIXTURES = ('mujoco_pickplace_pad2cube2.npz',
            'mujoco_pickplace_pad2cube2clutter4.npz',
            'mujoco_pickplace_nutcone.npz',
            'mujoco_pickplace_ballcup.npz')


@pytest.mark.slow
@pytest.mark.parametrize('fixture', FIXTURES)
def test_port_replay_tracks_mujoco(fixture):
  fx = np.load(os.path.join(REPO_ROOT, 'tests', 'fixtures', fixture))
  env = make_env(str(fx['shapes']), frame_res=(64, 64), device='cpu')
  obj = fx['init_obj_qpos'].copy()
  obj[:, 2] -= 0.025   # reset_to re-adds the table-height adjust
  es = env.reset_to(ResetSpec(
      obj_qpos=torch.as_tensor(obj)[None],
      mocap_qpos=torch.as_tensor(fx['init_mocap_qpos'])[None],
      task_goal=torch.tensor([0]), task_object=torch.tensor([0])))
  adrs = [env.model.jnt_qposadr[env.model.joint(str(j))]
          for j in fx['obj_joint_names']]
  trace = []
  for cmd in fx['cmds']:
    es = env.step(es, torch.as_tensor(cmd)[None])
    trace.append(np.stack([es.phys.qpos[0, a:a + 3].numpy() for a in adrs]))
  trace = np.stack(trace)
  m = env.eval_metrics(es)
  assert np.isfinite(trace).all()
  assert float(m['task_success'][0]) == 1.0, float(m['goal_dist'][0])
  mj = fx['obj_pos_trace']
  per_obj = np.linalg.norm(trace - mj, axis=-1).max(axis=0)
  moved = np.linalg.norm(mj - mj[:1], axis=-1).max(axis=0) > 0.005
  assert per_obj[0] < 0.03, f'task object drift {per_obj[0]:.4f}'
  moved_cap = 0.055 if 'clutter4' in fixture else 0.03
  assert per_obj[moved].max(initial=0.0) < moved_cap, per_obj[moved]
  assert per_obj[~moved].max(initial=0.0) < 0.005, per_obj[~moved]
