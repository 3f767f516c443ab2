"""Port parity (every scene): ``GeecoEnv`` of geeco_tpu_torch builds, resets,
steps and renders every scene of ``MODEL_XML`` with the JAX package's
scene-conditional solver defaults, and a few control steps of clutter4 and
nut-cone match the JAX env through the public entry points (setup,
reset_to, step, render) at 64x64 with settle_steps=2, on the CPU.

The JAX env renders with ``backend='pallas'`` (interpret mode here), as in
tests/test_torch_env.py.  The replays of the MuJoCo fixtures at full length
run on the card (tests/test_torch_card_replays.py) and, for JAX, under
``-m slow``.
"""

import concurrent.futures
import os

from tests.conftest import REPO_ROOT
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.envs.base import ResetSpec as JSpec
from geeco_tpu.envs.base import make_env as jmake_env
from geeco_tpu_torch.envs.base import MODEL_XML
from geeco_tpu_torch.envs.base import ResetSpec as TSpec
from geeco_tpu_torch.envs.base import make_env as tmake_env

torch.set_num_threads(1)

# tests/test_torch_env.py's tolerances: after 6 control steps (120
# substeps of 60 iterations) in float32 ...
QPOS_ATOL = 1e-4
QVEL_TOL = dict(rtol=1e-3, atol=1e-3)
# ... except on nut-cone, held to 1 mm: its settling nut and cone are
# chaotic in the JAX package itself, where a 1e-6 change of the settled
# setup state moves qpos by 2.4e-3 after one control step (clutter4: 6e-6;
# both measured on the CPU)
MESH_QPOS_ATOL = 1e-3
# ... and its velocities to twice that over a control step (0.04 s)
MESH_QVEL_ATOL = 2 * MESH_QPOS_ATOL / 0.04
FRAME_MISMATCH_TOL = 1e-3
N_STEPS = 2
# free bodies carrying mesh hulls: psd_block with quota selection
MESH_SCENES = ('ball-cup', 'bridge-pad', 'diamond-pad', 'nut-cone')
FIXTURES = {'pad2-cube2-clutter4': 'pad2cube2clutter4',
            'nut-cone': 'nutcone'}


@pytest.mark.parametrize('shapes', list(MODEL_XML))
def test_every_scene_steps(shapes):
  """Two envs: reset_random, a control step, a render (2 substeps a step,
  one settle step); finite state, objects resting above the floor."""
  env = tmake_env(shapes, frame_res=(64, 64), n_substeps=2, settle_steps=1,
                  device='cpu')
  mesh = shapes in MESH_SCENES
  assert env.solver_method == ('psd_block' if mesh else 'psd')
  assert (env.stepper.cs.quota_sel is not None) == mesh
  es = env.reset_random(2, torch.Generator().manual_seed(0))
  es = env.step(es, torch.tensor([[0.5, 0.0, -0.5, 1.0], [0.0, 0.5, 0.0,
                                                          -1.0]]))
  rgb, depth = env.render(es)
  assert rgb.shape == (2, 64, 64, 3) and rgb.dtype == torch.uint8
  assert bool(torch.isfinite(depth).all())
  assert bool(torch.isfinite(es.phys.qpos).all())
  assert bool(torch.isfinite(es.phys.qvel).all())
  m = env.model
  z = torch.stack([es.phys.qpos[:, m.jnt_qposadr[m.joint(j)] + 2]
                   for j in env.obj_joint_names], -1)
  assert ((z > 0.2) & (z < 0.4)).all(), z
  assert int(es.ts[0]) == 1


def _port_run(shapes, fx, obj):
  te = tmake_env(shapes, frame_res=(64, 64), settle_steps=2, device='cpu')
  tes = te.reset_to(TSpec(obj_qpos=torch.as_tensor(obj)[None],
                          mocap_qpos=torch.as_tensor(
                              fx['init_mocap_qpos'])[None],
                          task_goal=torch.tensor([0]),
                          task_object=torch.tensor([0])))
  reset_qpos = tes.phys.qpos[0].numpy()
  for cmd in fx['cmds'][:N_STEPS]:
    tes = te.step(tes, torch.as_tensor(cmd)[None])
  return te, tes, reset_qpos


@pytest.fixture(scope='module', params=list(FIXTURES))
def scene_run(request):
  shapes = request.param
  fx = np.load(os.path.join(REPO_ROOT, 'tests', 'fixtures',
                            f'mujoco_pickplace_{FIXTURES[shapes]}.npz'))
  obj = fx['init_obj_qpos'].copy()
  obj[:, 2] -= 0.025   # reset_to re-adds the table-height adjust
  # the port runs in a worker thread while XLA compiles the JAX side
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    port = pool.submit(_port_run, shapes, fx, obj)
    je = jmake_env(shapes, frame_res=(64, 64), settle_steps=2,
                   renderer_kwargs={'backend': 'pallas'})
    jes = je.reset_to(JSpec(obj_qpos=jnp.asarray(obj),
                            mocap_qpos=jnp.asarray(fx['init_mocap_qpos']),
                            task_goal=jnp.asarray(0, jnp.int32),
                            task_object=jnp.asarray(0, jnp.int32)),
                      jax.random.PRNGKey(0))
    reset = np.asarray(jes.phys.qpos)
    step = jax.jit(je.step)
    for cmd in fx['cmds'][:N_STEPS]:
      jes = step(jes, jnp.asarray(cmd))
    te, tes, reset_port = port.result(timeout=600)
  return shapes, je, te, jes, tes, reset, reset_port


def _qpos_atol(run):
  return MESH_QPOS_ATOL if run[0] in MESH_SCENES else QPOS_ATOL


def test_scene_defaults_match(scene_run):
  shapes, je, te = scene_run[:3]
  assert te.solver_method == je.solver_method
  a, b = je.stepper.cs, te.stepper.cs
  assert (a.ncon, a.ncon_sel, a.ngrp, a.ne) == (b.ncon, b.ncon_sel, b.ngrp,
                                                b.ne)
  assert (a.quota_sel is None) == (b.quota_sel is None)


def test_setup_and_reset_match(scene_run):
  _, je, te, _, _, reset, reset_port = scene_run
  atol = _qpos_atol(scene_run)
  np.testing.assert_allclose(te.setup().qpos[0].numpy(),
                             np.asarray(je.setup().qpos), atol=atol)
  np.testing.assert_allclose(reset_port, reset, atol=atol)


def test_control_steps_match(scene_run):
  shapes, je, te, jes, tes, _, _ = scene_run
  atol = _qpos_atol(scene_run)
  np.testing.assert_allclose(tes.phys.qpos[0].numpy(),
                             np.asarray(jes.phys.qpos), atol=atol)
  np.testing.assert_allclose(
      tes.phys.qvel[0].numpy(), np.asarray(jes.phys.qvel),
      rtol=QVEL_TOL['rtol'],
      atol=MESH_QVEL_ATOL if shapes in MESH_SCENES else QVEL_TOL['atol'])
  for k, v in je.eval_metrics(jes).items():
    np.testing.assert_allclose(te.eval_metrics(tes)[k][0].item(), float(v),
                               atol=atol, err_msg=k)


def test_scene_render_matches(scene_run):
  _, je, te, jes, tes, _, _ = scene_run
  rgb_ref, depth_ref = jax.jit(je.render)(jes)
  rgb, depth = te.render(tes)
  rgb_ref, depth_ref = np.asarray(rgb_ref), np.asarray(depth_ref)
  mism = (rgb[0].numpy() != rgb_ref).any(-1)
  assert mism.mean() <= FRAME_MISMATCH_TOL, f'{mism.sum()} pixels differ'
  np.testing.assert_allclose(depth[0].numpy()[~mism], depth_ref[~mism],
                             rtol=1e-4, atol=_qpos_atol(scene_run))
