"""Port parity (physics): FK, smooth dynamics, contacts, constraint layout
and one full substep of geeco_tpu_torch against the JAX package on the
pad2-cube2 scene, on the CPU.

Both engines get the same model (carried across with core/convert.py) and
the same states (made with numpy from a fixed seed, or settled by the JAX
stepper).
"""

from tests.conftest import reference_xml
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core import mjcf as jmjcf
from geeco_tpu.core.model import make_state as jmake_state
from geeco_tpu.core.model import set_joint_qpos as jset
from geeco_tpu.physics import collision as JC
from geeco_tpu.physics import dynamics as JD
from geeco_tpu.physics import kinematics as JK
from geeco_tpu.physics.step import build_stepper as jbuild
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.physics import collision as TC
from geeco_tpu_torch.physics import dynamics as TD
from geeco_tpu_torch.physics import kinematics as TK
from geeco_tpu_torch.physics.step import build_stepper as tbuild

# The tensors here are small: one intra-op thread is as fast, and it keeps
# the parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

# float32 kinematics/dynamics, same formulas, sums in another order
RTOL, ATOL = 1e-5, 1e-5
# one substep (60 PSD iterations) after the solve: the tolerances of
# tests/test_solver_pallas.py:87-91
QVEL_TOL = dict(rtol=1e-3, atol=1e-4)
EFC_TOL = dict(rtol=1e-2, atol=2e-3)


@pytest.fixture(scope='module')
def scene():
  jm, _ = jmjcf.load_model(reference_xml('geeco-pad2-cube2.xml'))
  tm = convert.model_from_reference(jm)
  js, ts = jbuild(jm), tbuild(tm)
  base = js.init_state(jmake_state(jm))
  q = base.qpos
  for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                    ('robot0:slide2', 0.0)):
    q = jset(jm, q, name, val)
  for name, xy, z in (('object0:joint', (1.3, 0.6), 0.3075),
                      ('object1:joint', (1.25, 0.9), 0.3075),
                      ('goal0:joint', (1.45, 0.6), 0.296),
                      ('goal1:joint', (1.45, 0.9), 0.296)):
    q = jset(jm, q, name, jnp.array([xy[0], xy[1], z, 1, 0, 0, 0]))
  base = base.replace(qpos=q)
  # settle with the JAX stepper: resting contacts on the table
  sub = jax.jit(js.substep)
  settled = base
  for _ in range(10):
    settled = sub(settled)
  return jm, tm, js, ts, base, settled, sub


def _perturbed(state, seed, scale_q=0.01, scale_v=0.1):
  rng = np.random.RandomState(seed)
  q = np.asarray(state.qpos) + rng.normal(0, scale_q, state.qpos.shape)
  v = rng.normal(0, scale_v, state.qvel.shape)
  return state.replace(qpos=jnp.asarray(q, jnp.float32),
                       qvel=jnp.asarray(v, jnp.float32))


def _close(got, ref, **tol):
  np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


def test_constraint_static_matches(scene):
  _, _, js, ts, _, _, _ = scene
  a, b = js.cs, ts.cs
  assert (a.ncon, a.nlim, a.neq, a.ne, a.ncon_sel, a.ngrp) == \
      (b.ncon, b.nlim, b.neq, b.ne, b.ncon_sel, b.ngrp)
  assert b.ngrp == 6 and b.ncon == 754 and b.ncon_sel == 128
  for f in ('con_body1', 'con_body2', 'con_friction', 'con_solref',
            'con_solimp', 'con_condim', 'lim_dof', 'lim_qadr', 'lim_range',
            'lim_solref', 'lim_solimp'):
    np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
  np.testing.assert_allclose(b.invweight, a.invweight, rtol=1e-4)
  np.testing.assert_array_equal(ts.anc_mask, js.anc_mask)


@pytest.mark.parametrize('seed', [0, 1])
def test_fk_matches(scene, seed):
  jm, tm, js, ts, base, _, _ = scene
  st = _perturbed(base, seed, scale_q=0.1)
  jk = JK.fk(jm, st)
  tk = TK.fk(tm, convert.state_from_reference(st))
  for f in ('xpos', 'xquat', 'ximat', 'xipos', 'geom_xpos', 'geom_xquat',
            'site_xpos', 'site_xmat'):
    _close(getattr(tk, f)[0], getattr(jk, f), rtol=RTOL, atol=ATOL)
  ji = JK.dof_info(jm, jk)
  ti = TK.dof_info(tm, tk)
  _close(ti.axis[0], ji.axis, rtol=RTOL, atol=ATOL)
  _close(ti.anchor[0], ji.anchor, rtol=RTOL, atol=ATOL)
  jp, jr = JK.com_jacobians(jm, jk, ji, js.anc_mask)
  tp, tr = TK.com_jacobians(tm, tk, ti, ts.anc_mask)
  _close(tp[0], jp, rtol=RTOL, atol=ATOL)
  _close(tr[0], jr, rtol=RTOL, atol=ATOL)


def test_smooth_dynamics_matches(scene):
  jm, tm, js, ts, base, _, _ = scene
  st = _perturbed(base, 2)
  ref, bias_ref = jax.jit(lambda s: (
      JD.smooth_dynamics(jm, s, js.anc_mask, jm.opt.timestep),
      JD.kin_and_bias(jm, s, js.anc_mask)[4]))(st)
  got = TD.smooth_dynamics(tm, convert.state_from_reference(st), ts.anc_mask,
                           tm.opt.timestep)
  _close(got.M[0], ref.M, rtol=RTOL, atol=1e-5)
  # qfrc_smooth carries the 1e11-damped world slides: compare relative to
  # its scale
  scale = np.abs(np.asarray(ref.qfrc_smooth)).max()
  _close(got.qfrc_smooth[0] / scale, ref.qfrc_smooth / scale, atol=1e-6)
  _close(got.qacc_smooth[0], ref.qacc_smooth, rtol=1e-4, atol=1e-4)
  _, _, _, _, bias = TD.kin_and_bias(tm, convert.state_from_reference(st),
                                     ts.anc_mask)
  _close(bias[0], bias_ref, rtol=1e-4, atol=1e-4)
  L = got.chol[0].numpy().astype(np.float64)
  m_scale = np.abs(np.asarray(ref.M_impl)).max()
  _close(L @ L.T / m_scale, np.asarray(ref.M_impl) / m_scale, atol=1e-6)


def test_contacts_match_on_settled_state(scene):
  jm, tm, _, _, _, settled, _ = scene
  ref = jax.jit(lambda s: JC.collide(jm, JK.fk(jm, s)))(settled)
  got = TC.collide(tm, TK.fk(tm, convert.state_from_reference(settled)))
  np.testing.assert_array_equal(got.geom1, np.asarray(ref.geom1))
  np.testing.assert_array_equal(got.geom2, np.asarray(ref.geom2))
  _close(got.dist[0], ref.dist, atol=1e-5)
  _close(got.pos[0], ref.pos, rtol=1e-5, atol=1e-5)
  _close(got.normal[0], ref.normal, atol=1e-5)
  assert (np.asarray(ref.dist) < 0).sum() >= 8   # resting manifolds


def test_substep_matches(scene):
  _, _, _, ts, _, settled, sub = scene
  ref = sub(settled)
  got = ts.substep(convert.state_from_reference(settled))
  _close(got.qvel[0], ref.qvel, **QVEL_TOL)
  _close(got.efc_force[0], ref.efc_force, **EFC_TOL)
  _close(got.qpos[0], ref.qpos, rtol=1e-5, atol=1e-6)


def test_batched_substep_equals_per_env(scene):
  _, _, _, ts, _, settled, _ = scene
  B = 4
  rng = np.random.RandomState(3)
  one = convert.state_from_reference(settled)
  noise = torch.as_tensor(1e-3 * rng.normal(size=(B, one.qvel.shape[1])),
                          dtype=torch.float32)
  batch = one.replace(**{
      f: getattr(one, f).expand((B,) + getattr(one, f).shape[1:]).clone()
      for f in ('qpos', 'qvel', 'ctrl', 'mocap_pos', 'mocap_quat', 'time',
                'efc_force')})
  batch = batch.replace(qvel=batch.qvel + noise)
  out = ts.substep(batch, 30)
  for k in (0, 2, 3):
    single = ts.substep(batch.replace(**{
        f: getattr(batch, f)[k:k + 1]
        for f in ('qpos', 'qvel', 'ctrl', 'mocap_pos', 'mocap_quat', 'time',
                  'efc_force')}), 30)
    _close(out.qvel[k], single.qvel[0], rtol=1e-4, atol=1e-5)


def test_collide_every_matches(scene):
  """Two substeps sharing one contact set (collide_every=2)."""
  _, _, js, ts, _, settled, _ = scene
  ref = jax.jit(lambda s: js.step(s, n_substeps=2, collide_every=2))(settled)
  got = ts.step(convert.state_from_reference(settled), n_substeps=2,
                collide_every=2)
  _close(got.qvel[0], ref.qvel, **QVEL_TOL)
  _close(got.qpos[0], ref.qpos, rtol=1e-5, atol=1e-6)
  with pytest.raises(ValueError):
    ts.step(convert.state_from_reference(settled), n_substeps=3,
            collide_every=2)


def test_unported_pair_raises(scene):
  """A type pair the JAX dispatcher lacks raises in both engines (box vs
  sphere: the scenes list the sphere first)."""
  _, tm, _, _, _, _, _ = scene
  assert TC.ncon_max(tm) == 754
  BOX, SPHERE = 6, 2
  with pytest.raises(NotImplementedError):
    JC._kernel(BOX, SPHERE)
  with pytest.raises(NotImplementedError):
    TC._kernel(BOX, SPHERE)
  TC._kernel(SPHERE, SPHERE)   # ported with the clutter scenes
