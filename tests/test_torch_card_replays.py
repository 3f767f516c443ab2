"""The recorded MuJoCo pick episodes replayed through the port's
production envs on the card, at B=1 (every test skips without one).

Each fixture's commands go through ``reset_to`` + ``step``; the task
object must stay within ``DRIFT_LIMIT`` of MuJoCo's trace and, where the
whole episode runs, the pick must succeed.  pad2-cube2 (its first 50
steps: approach, grasp, lift) and the whole episode through the
fused-solve env (``rolling=False, solver_method='pallas'``: K2 every
substep); nut-cone whole (``psd_block``, quota selection) and clutter4's
first 50 steps (``psd``, the top-192), where the objects MuJoCo shows
moving stay within their scene's limit and the others within
``STATIC_LIMIT``, every solve by the env's method.  The CPU's replays are
``tests/test_torch_replay.py`` (``-m slow``).

tests/conftest.py imports JAX, which the card lacks, so there the file
runs without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_replays.py

This file imports no JAX.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from geeco_tpu_torch.envs.base import ResetSpec, make_env
from geeco_tpu_torch.physics import solver as S
from geeco_tpu_torch.physics import solver_pallas as SP
from test_torch_card_kernels import card  # noqa: F401 (fixture)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures')
DRIFT_LIMIT = 0.03      # the task object's drift from the MuJoCo trace (m)
STATIC_LIMIT = 0.005    # the objects MuJoCo shows at rest (m)
# fixture, env options, control steps replayed (None: whole), the limit of
# the other objects MuJoCo shows moving (more than 5 mm; None: not held).
# One brushed clutter piece rolls near-chaotically: 55 mm
# (tests/test_replay_parity.py:96-103).  Half of pad2-cube2's episode and
# of clutter4's keeps the run short; pad2-cube2's whole episode runs
# through the fused-solve env
REPLAYS = {
    'pad2-cube2': ('mujoco_pickplace_pad2cube2.npz', {}, 50, None),
    'pad2-cube2 fused solve': ('mujoco_pickplace_pad2cube2.npz',
                               dict(rolling=False, solver_method='pallas'),
                               None, None),
    'nut-cone': ('mujoco_pickplace_nutcone.npz', {}, None, 0.03),
    'pad2-cube2-clutter4': ('mujoco_pickplace_pad2cube2clutter4.npz', {}, 50,
                            0.055),
}


@pytest.mark.parametrize('case', list(REPLAYS))
def test_mujoco_replay(case, card, monkeypatch):
  fixture, options, steps, moved_limit = REPLAYS[case]
  env = make_env(case.split()[0], device=card, **options)
  solves = {}
  solve = S.solve
  signature = inspect.signature(solve)

  def counted(*a, **k):
    method = signature.bind(*a, **k).arguments.get('method', 'psd')
    solves[method] = solves.get(method, 0) + 1
    return solve(*a, **k)
  monkeypatch.setattr(S, 'solve', counted)
  SP.psd_solve.launches = 0
  fx = np.load(os.path.join(FIXTURES, fixture))
  obj = fx['init_obj_qpos'].copy()
  obj[:, 2] -= 0.025   # reset_to re-adds the table-height adjust
  es = env.reset_to(ResetSpec(
      obj_qpos=torch.as_tensor(obj)[None],
      mocap_qpos=torch.as_tensor(fx['init_mocap_qpos'])[None],
      task_goal=torch.tensor([0]), task_object=torch.tensor([0])))
  adrs = [env.model.jnt_qposadr[env.model.joint(str(j))]
          for j in fx['obj_joint_names']]
  cmds = fx['cmds'][:steps]
  trace = []
  for cmd in cmds:
    es = env.step(es, torch.as_tensor(cmd)[None])
    trace.append(torch.stack([es.phys.qpos[0, a:a + 3] for a in adrs]))
  trace = torch.stack(trace).cpu().numpy()
  assert np.isfinite(trace).all()
  mj = fx['obj_pos_trace'][:len(cmds)]
  drift = np.linalg.norm(trace - mj, axis=-1).max(axis=0)
  assert drift[0] < DRIFT_LIMIT, f'task-object drift {drift[0]:.4f} m'
  if steps is None:
    assert float(env.eval_metrics(es)['task_success'][0]) == 1.0
  if moved_limit is not None:
    moved = np.linalg.norm(mj - mj[:1], axis=-1).max(axis=0) > 0.005
    moved[0] = False                      # the task object, held above
    static = ~moved
    static[0] = False
    assert drift[moved].max(initial=0.0) < moved_limit, drift
    assert drift[static].max(initial=0.0) < STATIC_LIMIT, drift
  if options.get('solver_method') == 'pallas':
    # eager substeps, chains' warm-ups and captures call the wrapper; a
    # replay runs the kernel it captured
    assert SP.psd_solve.launches > 0
  else:
    # on the card a chain's warm-up and capture call solve; its replays
    # run what was captured
    assert set(solves) == {env.solver_method}, solves
