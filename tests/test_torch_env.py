"""Port parity (the slice): GeecoEnv('pad2-cube2') of geeco_tpu_torch
against the JAX package's env through the public entry points — setup,
reset_to, step, eval_metrics, observe and render — at 64x64 with
settle_steps=2, on the CPU.

The JAX env renders with ``backend='pallas'`` (the TPU path, interpret mode
here): its CPU default (flat binning) differs from hierarchical binning on
about 6% of pixels, and the port has the hierarchical path only.
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
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.envs.base import ResetSpec as TSpec
from geeco_tpu_torch.envs.base import make_env as tmake_env

# The tensors here are small: one intra-op thread is as fast, and it keeps
# the parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

FIXTURE = os.path.join(REPO_ROOT, 'tests', 'fixtures',
                       'mujoco_pickplace_pad2cube2.npz')
# after 6 control steps (120 substeps of 60 PSD iterations) in float32
QPOS_ATOL = 1e-4
# frames: projections differ by float32 rounding; edge pixels may flip
FRAME_MISMATCH_TOL = 1e-3
N_STEPS = 2


def _port_slice(fx, obj):
  te = tmake_env('pad2-cube2', frame_res=(64, 64), settle_steps=2,
                 device='cpu')
  tes = te.reset_to(TSpec(obj_qpos=torch.as_tensor(obj)[None],
                          mocap_qpos=torch.as_tensor(
                              fx['init_mocap_qpos'])[None],
                          task_goal=torch.tensor([0]),
                          task_object=torch.tensor([0])))
  reset_qpos = tes.phys.qpos[0].numpy()
  for cmd in fx['cmds'][:N_STEPS]:
    tes = te.step(tes, torch.as_tensor(cmd)[None])
  return te, tes, reset_qpos


@pytest.fixture(scope='module')
def slice_run():
  fx = np.load(FIXTURE)
  obj = fx['init_obj_qpos'].copy()
  obj[:, 2] -= 0.025   # reset_to re-adds the table-height adjust
  # the port runs in a worker thread while XLA compiles the JAX side (both
  # release the interpreter lock in their kernels): keeps this file short
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    port = pool.submit(_port_slice, fx, obj)
    je = jmake_env('pad2-cube2', frame_res=(64, 64), settle_steps=2,
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
  return je, te, jes, tes, (reset, reset_port)


def test_setup_state_matches(slice_run):
  je, te = slice_run[:2]
  np.testing.assert_allclose(te.setup().qpos[0].numpy(),
                             np.asarray(je.setup().qpos), atol=QPOS_ATOL)
  np.testing.assert_allclose(te.initial_gripper_xpos,
                             je.initial_gripper_xpos, atol=QPOS_ATOL)


def test_reset_to_matches(slice_run):
  ref, got = slice_run[4]
  np.testing.assert_allclose(got, ref, atol=QPOS_ATOL)


def test_steps_match(slice_run):
  _, _, jes, tes, _ = slice_run
  np.testing.assert_allclose(tes.phys.qpos[0].numpy(),
                             np.asarray(jes.phys.qpos), atol=QPOS_ATOL)
  np.testing.assert_allclose(tes.phys.qvel[0].numpy(),
                             np.asarray(jes.phys.qvel), rtol=1e-3, atol=1e-3)
  assert int(tes.ts[0]) == int(jes.ts) == N_STEPS


def test_eval_metrics_match(slice_run):
  je, te, jes, tes, _ = slice_run
  ref = je.eval_metrics(jes)
  got = te.eval_metrics(tes)
  assert set(got) == set(ref)
  for k in ref:
    assert got[k].shape == (1,)
    np.testing.assert_allclose(got[k][0].item(), float(ref[k]), atol=1e-4,
                               err_msg=k)


def test_observe_matches(slice_run):
  je, te, jes, tes, _ = slice_run
  ref = je.observe(jes)
  got = te.observe(tes)
  for k in ref:
    np.testing.assert_allclose(got[k][0].numpy(), np.asarray(ref[k]),
                               atol=1e-4, err_msg=k)


def test_env_state_conversion(slice_run):
  """The JAX EnvState carried across reads back the same metrics."""
  je, te, jes, _, _ = slice_run
  es = convert.env_state_from_reference(jes)
  assert es.phys.qpos.shape == (1, te.model.nq) and es.ts.shape == (1,)
  assert es.rgba.shape == (1, te.model.ngeom, 4)
  ref = je.eval_metrics(jes)
  got = te.eval_metrics(es)
  for k in ref:
    np.testing.assert_allclose(got[k][0].item(), float(ref[k]), atol=1e-5,
                               err_msg=k)


def test_render_matches(slice_run):
  je, te, jes, tes, _ = slice_run
  rgb_ref, depth_ref = jax.jit(je.render)(jes)
  rgb, depth = te.render(tes)
  assert rgb.shape == (1, 64, 64, 3) and depth.shape == (1, 64, 64)
  rgb_ref, depth_ref = np.asarray(rgb_ref), np.asarray(depth_ref)
  mism = (rgb[0].numpy() != rgb_ref).any(-1)
  assert mism.mean() <= FRAME_MISMATCH_TOL, f'{mism.sum()} pixels differ'
  np.testing.assert_allclose(depth[0].numpy()[~mism], depth_ref[~mism],
                             rtol=1e-4, atol=1e-4)


def test_step_clips_action(slice_run):
  """The action is clipped to [-1, 1] at execution time: an out-of-range
  command moves the mocap target exactly as the clipped one does."""
  _, te, _, tes, _ = slice_run
  a = torch.tensor([[3.0, -2.0, 0.5, 1.4]])
  kin = te.kin(tes)
  clipped = torch.clamp(a, -1.0, 1.0)
  target = kin.xpos[:, te.gripper_body] + clipped[:, :3] * 0.05
  # one substep is enough to see the mocap target the step installed
  n, te.n_substeps = te.n_substeps, 1
  try:
    out = te.step(tes, a)
  finally:
    te.n_substeps = n
  np.testing.assert_allclose(out.phys.mocap_pos[:, 0].numpy(),
                             target.numpy(), atol=1e-6)
  assert out.phys.ctrl[0, 0] > tes.phys.qpos[0, te.model.jnt_qposadr[
      te.model.actuator_jntid[0]]]   # cmd 1.4 rounds to 1: open


def test_reset_random_places_objects(slice_run):
  _, te, _, _, _ = slice_run
  es = te.reset_random(2, torch.Generator().manual_seed(0))
  m = te.model
  assert es.phys.qpos.shape == (2, m.nq) and es.rgba.shape == (2, m.ngeom, 4)
  assert torch.isfinite(es.phys.qpos).all()
  z = torch.stack([es.phys.qpos[:, m.jnt_qposadr[m.joint(j)] + 2]
                   for j in te.obj_joint_names], -1)
  assert ((z > 0.28) & (z < 0.32)).all(), z
  xy = torch.stack([es.phys.qpos[:, m.jnt_qposadr[m.joint(j)]:
                                 m.jnt_qposadr[m.joint(j)] + 2]
                    for j in te.obj_joint_names], 1)
  # distinct spawn cells per env
  assert (torch.cdist(xy[0], xy[0]) + torch.eye(len(te.obj_joint_names))
          ).min() > 0.02
  assert set(es.task_goal.tolist()) <= {0, 1}
  np.testing.assert_array_equal(
      es.rgba[:, m.geom('object0')].numpy(), [[1, 0, 0, 1]] * 2)


def test_make_env_defaults_to_the_card():
  """With no ``device`` the env is built on the card; where there is none,
  construction raises instead of running on the CPU."""
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present: the default builds there')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tmake_env('pad2-cube2')
