"""Port parity (solver): quota contact selection, the island blocks, the
projected iterations ``cg``, ``bb``, ``apgd``, ``psd_block`` and ``bb_block``
and one substep of the clutter4 and nut-cone scenes, geeco_tpu_torch against
the JAX package on the CPU.

The scenes start from the MuJoCo fixtures' initial object poses, settled by
the JAX stepper; each substep compared starts from zero forces (a JAX
warm start is tied to its contact slots, which may order equal-depth
manifold points differently: ROADMAP Queue 3).
"""

import functools
import os

from tests.conftest import REPO_ROOT, reference_xml
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core import mjcf as jmjcf
from geeco_tpu.core.model import make_state as jmake_state
from geeco_tpu.core.model import set_joint_qpos as jset
from geeco_tpu.physics import collision as JC
from geeco_tpu.physics import kinematics as JK
from geeco_tpu.physics import solver as JS
from geeco_tpu.physics.step import build_stepper as jbuild
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.physics import collision as TC
from geeco_tpu_torch.physics import dynamics as TD
from geeco_tpu_torch.physics import kinematics as TK
from geeco_tpu_torch.physics import solver as TS
from geeco_tpu_torch.physics.step import build_stepper as tbuild

torch.set_num_threads(1)

# one substep (60 PSD iterations) after the solve: tests/test_torch_physics.py
QVEL_TOL = dict(rtol=1e-3, atol=1e-4)
EFC_TOL = dict(rtol=1e-2, atol=2e-3)
# 30 iterations on a well-conditioned operator in float32 (on an
# ill-conditioned one the Barzilai-Borwein steps amplify rounding: both
# engines then stray from a float64 run alike)
ITER_TOL = dict(rtol=1e-4, atol=5e-5)   # each lies up to 2e-5 from float64
# the envs' selection: clutter4 the global top-K (K = 128 + 16 per free body
# past four), nut-cone the per-body quotas (free bodies with mesh hulls)
SCENES = {'pad2-cube2-clutter4': ('topk', 192, 'psd', 'pad2cube2clutter4'),
          'nut-cone': ('quota', 128, 'psd_block', 'nutcone')}


@functools.lru_cache(maxsize=None)
def _load(name):
  return jmjcf.load_model(reference_xml(f'geeco-{name}.xml'))[0]


@functools.lru_cache(maxsize=None)
def _scene(name):
  """(JAX model, port model, JAX stepper, port stepper, settled state)."""
  mode, k, method, fixture = SCENES[name]
  jm = _load(name)
  tm = convert.model_from_reference(jm)
  js = jbuild(jm, contact_select_k=k, select_mode=mode)
  ts = tbuild(tm, contact_select_k=k, select_mode=mode)
  fx = np.load(os.path.join(REPO_ROOT, 'tests', 'fixtures',
                            f'mujoco_pickplace_{fixture}.npz'))
  st = js.init_state(jmake_state(jm))
  q = st.qpos
  for jname, obj in zip(fx['obj_joint_names'], fx['init_obj_qpos']):
    q = jset(jm, q, str(jname), jnp.asarray(obj, jnp.float32))
  st = st.replace(qpos=q)
  sub = jax.jit(lambda s: js.substep(s, 30, method))
  for _ in range(10):
    st = sub(st)
  return jm, tm, js, ts, st


@pytest.mark.parametrize('name,mode', [('nut-cone', 'quota'),
                                       ('ball-cup', 'quota'),
                                       ('pad2-cube2-clutter4', 'quota'),
                                       ('pad2-cube2-clutter4', 'topk')])
def test_constraint_static_and_blocks_match(name, mode):
  """``_quota_groups``, ``ConstraintStatic`` and ``block_ids``: integers
  exactly, the reference-pose weights to float32 rounding."""
  jm = _load(name)
  tm = convert.model_from_reference(jm)
  js, ts = jbuild(jm, select_mode=mode), tbuild(tm, select_mode=mode)
  a, b = js.cs, ts.cs
  assert (a.ncon, a.nlim, a.neq, a.ne, a.ncon_sel, a.ngrp) == \
      (b.ncon, b.nlim, b.neq, b.ne, b.ncon_sel, b.ngrp)
  for f in ('con_body1', 'con_body2', 'con_condim', 'lim_dof', 'lim_qadr'):
    np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
  np.testing.assert_allclose(b.invweight, a.invweight, rtol=1e-4)
  if mode == 'topk':
    assert a.quota_sel is None and b.quota_sel is None
    assert TS.block_ids(b) is None
    return
  assert len(b.quota_sel) == len(a.quota_sel) >= 2
  for (ia, ka), (ib, kb) in zip(a.quota_sel, b.quota_sel):
    assert ka == kb
    np.testing.assert_array_equal(ib, ia)
  np.testing.assert_array_equal(TS.block_ids(b), JS.block_ids(a))
  groups = TS._quota_groups(tm, b.con_body1, b.con_body2, 24, 48, 32)
  ref = JS._quota_groups(jm, a.con_body1, a.con_body2, 24, 48, 32)
  assert [k for _, k in groups] == [k for _, k in ref]


def _operator(seed, B=3, K=6, nlim=2, m=48):
  """A random SPD operator per env over 4 contact groups of K rows and
  2*nlim limit rows, its right-hand side, preconditioner and start."""
  rng = np.random.RandomState(seed)
  n = 4 * K + 2 * nlim
  J = rng.normal(size=(B, n, m)).astype(np.float32)
  R = rng.uniform(0.5, 1.0, (B, n)).astype(np.float32)
  A = np.einsum('bim,bjm->bij', J, J) + R[:, :, None] * np.eye(n)
  b = rng.normal(size=(B, n)).astype(np.float32)
  precond = (1.0 / np.einsum('bii->bi', A)).astype(np.float32)
  f0 = np.abs(rng.normal(size=(B, n))).astype(np.float32)
  # islands: three quota groups of 2, 3 and 1 slots, then the limit rows
  slot = np.array([0, 0, 1, 1, 1, 2])
  bid = np.concatenate([np.tile(slot, 4), np.full(2 * nlim, 3)])
  return A.astype(np.float32), b, precond, f0, bid, K


@pytest.mark.parametrize('method', ['psd', 'cg', 'bb', 'apgd', 'psd_block',
                                    'bb_block'])
def test_iterate_matches(method):
  """30 iterations of each method on one operator per env, with the normal
  rows projected onto f >= 0, against the JAX ``_iterate`` vmapped."""
  A, b, precond, f0, bid, K = _operator(11)
  block = method in TS.BLOCK_METHODS

  def jrun(A_, b_, p_, f_):
    project = lambda f: f.at[:K].set(jnp.maximum(f[:K], 0.0))
    return JS._iterate(lambda v: A_ @ v, project, f_, b_, p_, 30, method,
                       bid=jnp.asarray(bid) if block else None,
                       nblocks=int(bid.max()) + 1 if block else 0)

  ref = jax.jit(jax.vmap(jrun))(*map(jnp.asarray, (A, b, precond, f0)))
  tA = torch.as_tensor(A)
  got = TS._iterate(
      lambda v: torch.bmm(tA, v[..., None])[..., 0],
      lambda f: torch.cat([torch.clamp(f[:, :K], min=0.0), f[:, K:]], 1),
      torch.as_tensor(f0), torch.as_tensor(b), torch.as_tensor(precond), 30,
      method, torch.as_tensor(bid) if block else None,
      nblocks=int(bid.max()) + 1 if block else 0)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ITER_TOL)
  assert (got[:, :K] >= 0).all()
  # the iteration moved: the start is no fixed point
  assert np.abs(np.asarray(ref) - f0).max() > 1e-2


def test_block_methods_need_quota_and_unknown_methods_raise():
  A, b, precond, f0, _, _ = _operator(12)
  args = (lambda v: v, lambda f: f, torch.as_tensor(f0), torch.as_tensor(b),
          torch.as_tensor(precond), 2)
  for method in TS.BLOCK_METHODS:
    with pytest.raises(ValueError, match='quota'):
      TS._iterate(*args, method)
  with pytest.raises(ValueError, match='unknown solver method'):
    TS._iterate(*args, 'newton')
  with pytest.raises(ValueError, match='unknown solver method'):
    JS._iterate(*args[:2], jnp.asarray(f0[0]), jnp.asarray(b[0]),
                jnp.asarray(precond[0]), 2, 'newton')


def _efc_close(got, ref, cs):
  """Forces at EFC_TOL, a contact's friction rows relative to the larger of
  their own size and the contact's normal force: the split of friction
  over the points of one manifold is weakly determined (60 iterations
  leave it to the rounding: 4-8% of a net tangential force of ~1 N under a
  normal force of ~100 N on nut-cone), where the normal rows, the limit and
  weld rows and qvel are not."""
  got, ref = got.reshape(-1), np.asarray(ref).reshape(-1)
  fn = np.abs(ref[:cs.ncon])
  scale = np.abs(ref).copy()
  for g in range(1, cs.ngrp):
    rows = slice(g * cs.ncon, (g + 1) * cs.ncon)
    scale[rows] = np.maximum(scale[rows], fn)
  err = np.abs(got - ref)
  bound = EFC_TOL['atol'] + EFC_TOL['rtol'] * scale
  assert (err <= bound).all(), (np.argmax(err - bound), (err - bound).max())


@pytest.mark.parametrize('name', list(SCENES))
def test_substep_matches(name):
  """One substep of the scene's production solver from zero forces."""
  _, _, js, ts, st = _scene(name)
  method = SCENES[name][2]
  start = st.replace(efc_force=jnp.zeros_like(st.efc_force))
  ref = jax.jit(lambda s: js.substep(s, 60, method))(start)
  got = ts.substep(convert.state_from_reference(start), 60, method)
  np.testing.assert_allclose(got.qvel[0].numpy(), np.asarray(ref.qvel),
                             **QVEL_TOL)
  _efc_close(got.efc_force[0].numpy(), ref.efc_force, ts.cs)
  np.testing.assert_allclose(got.qpos[0].numpy(), np.asarray(ref.qpos),
                             rtol=1e-5, atol=1e-6)
  assert (np.asarray(ref.efc_force)[:ts.cs.ncon] > 0).sum() >= 4


def test_hysteresis_substep_matches():
  """One substep of clutter4 with a hysteresis bonus.  The warm start
  marks the normal rows of the eight candidates ranked just past the
  top-K as carrying force, so the bonus swaps them into the active set;
  they are not penetrating, so the solve still starts from zero forces."""
  jm, tm, js, ts, st = _scene('pad2-cube2-clutter4')
  cs, h = ts.cs, 0.1
  dist = np.asarray(jax.jit(lambda s: JC.collide(jm, JK.fk(jm, s)).dist)(st))
  late = np.argsort(dist, kind='stable')[cs.ncon_sel:cs.ncon_sel + 8]
  assert (dist[late] > 0).all()
  warm = np.zeros(cs.ne, np.float32)
  warm[late] = 1.0
  start = st.replace(efc_force=jnp.asarray(warm))
  ref = jax.jit(lambda s: js.substep(s, 60, 'psd', hysteresis=h))(start)
  tstart = convert.state_from_reference(start)
  got = ts.substep(tstart, 60, 'psd', hysteresis=h)
  np.testing.assert_allclose(got.qvel[0].numpy(), np.asarray(ref.qvel),
                             **QVEL_TOL)
  _efc_close(got.efc_force[0].numpy(), ref.efc_force, cs)
  # the bonus moved the eight rows into the active set, and the solve
  # (whose global step sees every selected row) differs without it
  kin = TK.fk(tm, tstart)
  smooth = TD.smooth_dynamics(tm, tstart, ts.anc_mask, tm.opt.timestep)
  contacts = TC.collide(tm, kin)
  sel = [set(TS.make_constraints(tm, cs, smooth, contacts, tstart,
                                 ts.anc_mask, hysteresis=x).sel_idx[0].tolist())
         for x in (0.0, h)]
  assert not set(late.tolist()) & sel[0]
  assert set(late.tolist()) <= sel[1]
  plain = ts.substep(tstart, 60, 'psd')
  assert not torch.equal(plain.qvel, got.qvel)


@pytest.mark.parametrize('method', TS.BLOCK_METHODS)
def test_block_methods_need_the_block_count(method):
  """``bid`` without ``nblocks`` raises on the host, before a zero-column
  one-hot could index out of range on the card."""
  A, b, precond, f0, bid, _ = _operator(13)
  args = (lambda v: v, lambda f: f, torch.as_tensor(f0), torch.as_tensor(b),
          torch.as_tensor(precond), 2, method, torch.as_tensor(bid))
  with pytest.raises(ValueError, match='nblocks'):
    TS._iterate(*args)
  assert TS._iterate(*args, nblocks=int(bid.max()) + 1).shape == f0.shape
