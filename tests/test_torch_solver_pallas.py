"""Port parity (the fused PSD solve): geeco_tpu_torch/physics/solver_pallas.py
and ``solve(method='pallas')`` against the JAX package's Pallas solve path,
on the CPU.

On the CPU the wrapper ``psd_solve`` runs the kernel's plain twin; the JAX
side runs ``_psd_loop`` (the math its Pallas kernel runs).  Inputs are made
with numpy from fixed seeds and handed to both engines.
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
from geeco_tpu.envs.base import GeecoEnv as JEnv
from geeco_tpu.physics import solver_pallas as JSP
from geeco_tpu.physics.step import build_stepper as jbuild
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.envs.base import GeecoEnv as TEnv
from geeco_tpu_torch.physics import solver_pallas as SP
from geeco_tpu_torch.physics.step import build_stepper as tbuild

# The tensors here are small: one intra-op thread is as fast, and it keeps
# the parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

# 60 iterations of the same float32 math, sums in another order
LOOP_TOL = dict(rtol=1e-5, atol=1e-6)
# one substep after the solve: the tolerances of
# tests/test_solver_pallas.py:87-91 (as test_torch_physics.py)
QVEL_TOL = dict(rtol=1e-3, atol=1e-4)
EFC_TOL = dict(rtol=1e-2, atol=2e-3)

# the two scenes of tests/test_solver_pallas.py:19-60
TWO_BOXES = """
<mujoco>
  <option timestep="0.002" density="0"/>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="5 5 1" condim="4"
          friction="1.0 0.005 0.0001"/>
    <body name="b1" pos="0 0 0.1">
      <joint type="free"/>
      <geom type="box" size="0.025 0.025 0.025" condim="4" mass="2"
            friction="1.0 0.005 0.0001"/>
    </body>
    <body name="b2" pos="0.02 0.01 0.18">
      <joint type="free"/>
      <geom type="box" size="0.025 0.025 0.025" condim="4" mass="1"
            friction="1.0 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>
"""

WELD_ARM = """
<mujoco>
  <option timestep="0.002" density="0"/>
  <worldbody>
    <body name="mocap" mocap="true" pos="0.1 0 0.3"/>
    <body name="arm" pos="0 0 0.3">
      <joint type="free"/>
      <geom type="box" size="0.03 0.03 0.03" mass="1"/>
    </body>
    <body name="ball" pos="0.0 0 0.06">
      <joint type="free"/>
      <geom type="sphere" size="0.03" mass="0.5" condim="4"
            friction="0.8 0.005 0.0001"/>
    </body>
    <geom name="floor" type="plane" pos="0 0 0" size="5 5 1" condim="4"
          friction="0.8 0.005 0.0001"/>
  </worldbody>
  <equality>
    <weld body1="mocap" body2="arm" solref="0.02 1" solimp="0.9 0.95 0.001"/>
  </equality>
</mujoco>
"""


def _operands(seed, B=3, K=8, nlim=2, nv=12, nE=6):
  """Random well-posed solve operands (env-major float32 numpy): an SPD
  mass matrix, X = M⁻¹Jᵀ, the Schur block of nE weld rows."""
  rng = np.random.RandomState(seed)
  nI = 4 * K + 2 * nlim
  J = rng.normal(size=(B, nI, nv)) / np.sqrt(nv)
  A = rng.normal(size=(B, nv, nv)) / np.sqrt(nv)
  M = np.eye(nv) + A @ A.transpose(0, 2, 1)
  X = np.linalg.solve(M, J.transpose(0, 2, 1))
  R = 0.1 + rng.uniform(size=(B, nI))
  JE = rng.normal(size=(B, nE, nv)) / np.sqrt(nv)
  XE = np.linalg.solve(M, JE.transpose(0, 2, 1))
  AIE = J @ XE
  EEinv = np.linalg.inv(JE @ XE + np.eye(nE) * (0.1 + rng.uniform(
      size=(B, 1, nE))))
  diag = np.einsum('biv,bvi->bi', J, X) + R - np.einsum(
      'bie,bef,bif->bi', AIE, EEinv, AIE)
  ops = dict(J=J, X=X, A_IE=AIE, EEinv=EEinv, R=R,
             b=rng.normal(size=(B, nI)), precond=1.0 / diag,
             f0=rng.normal(size=(B, nI)),
             mu_t=0.5 + 0.5 * rng.uniform(size=(B, K)),
             mu_tor=0.005 + 0.01 * rng.uniform(size=(B, K)),
             con_act=(rng.uniform(size=(B, K)) > 0.3).astype(np.float64),
             lim_act=(rng.uniform(size=(B, 2 * nlim)) > 0.5).astype(
                 np.float64))
  return {k: v.astype(np.float32) for k, v in ops.items()}


def _torch(ops):
  return {k: torch.as_tensor(v) for k, v in ops.items()}


def _jax_layout(ops):
  """The TPU kernel's lane layout [.., E]: env axis last."""
  tr = lambda a, p: jnp.asarray(np.transpose(a, p))
  return (tr(ops['J'], (2, 1, 0)), tr(ops['X'], (1, 2, 0)),
          tr(ops['A_IE'], (2, 1, 0)), tr(ops['EEinv'], (1, 2, 0)),
          *(jnp.asarray(ops[k].T) for k in (
              'R', 'b', 'precond', 'f0', 'mu_t', 'mu_tor', 'con_act',
              'lim_act')))


@pytest.mark.parametrize('nE', [6, 0], ids=['weld_rows', 'no_weld_rows'])
def test_twin_matches_jax_psd_loop(nE):
  K, nlim = 8, 2
  ops = _operands(0, K=K, nlim=nlim, nE=nE)
  ref = jax.jit(lambda *a: JSP._psd_loop(*a, K, nlim, 60))(*_jax_layout(ops))
  t = _torch(ops)
  got = SP.psd_solve_reference(**t, K=K, nlim=nlim, iterations=60)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref).T, **LOOP_TOL)
  # the wrapper on CPU tensors is the twin
  same = SP.psd_solve(**t, K=K, nlim=nlim, iterations=60)
  np.testing.assert_array_equal(same.numpy(), got.numpy())
  # the iteration moved the forces and kept them in the cone
  f0 = SP.project_rows(t['f0'], t['mu_t'], t['mu_tor'], t['con_act'],
                       t['lim_act'], K, nlim)
  assert (got - f0).abs().max() > 1e-2
  assert (got[:, :K] >= 0).all()


def test_project_rows_matches_jax_exactly():
  K, nlim = 8, 2
  ops = _operands(1, K=K, nlim=nlim)
  rng = np.random.RandomState(2)
  nI = 4 * K + 2 * nlim + 4          # 4 padding rows
  f = (3.0 * rng.normal(size=(3, nI))).astype(np.float32)
  args = [ops[k] for k in ('mu_t', 'mu_tor', 'con_act', 'lim_act')]
  ref = JSP._project_rows(jnp.asarray(f.T), *(jnp.asarray(a.T) for a in args),
                          K, nlim)
  got = SP.project_rows(torch.as_tensor(f), *map(torch.as_tensor, args), K,
                        nlim)
  np.testing.assert_array_equal(got.numpy(), np.asarray(ref).T)
  assert (got[:, 4 * K + 2 * nlim:] == 0).all()


def _load_pair(tmp_path, xml):
  p = tmp_path / 'scene.xml'
  p.write_text(xml)
  jm, _ = jmjcf.load_model(str(p))
  return jm, convert.model_from_reference(jm)


def _sorted_by_group(efc, ncon):
  """Full-layout forces with each contact row group sorted: the engines may
  hold the corners of one box-box manifold in another slot order."""
  groups = [np.sort(efc[g * ncon:(g + 1) * ncon]) for g in range(4)]
  return np.concatenate(groups + [efc[4 * ncon:]])


@pytest.mark.parametrize('xml', [TWO_BOXES, WELD_ARM],
                         ids=['contacts_only', 'with_weld'])
def test_substep_pallas_matches_jax(tmp_path, xml):
  jm, tm = _load_pair(tmp_path, xml)
  js, ts = jbuild(jm), tbuild(tm)
  assert js.cs.ngrp == ts.cs.ngrp == 4
  sub = jax.jit(lambda s: js.substep(s, 60, 'pallas'))
  state = js.init_state(jmake_state(jm))
  for _ in range(150):      # the boxes stack, the ball rests on the floor
    state = sub(state)
  # Corners of a box-box manifold at equal depth (up to rounding) take
  # their 8 slots in another order in the two engines, and a warm start is
  # tied to the slots: start both solves from zero.
  state = state.replace(efc_force=jnp.zeros_like(state.efc_force))
  ref = sub(state)
  with SP.capture() as calls:
    got = ts.substep(convert.state_from_reference(state), 60, 'pallas')
  assert len(calls) == 1 and calls[0]['A_IE'].shape[2] == 6 * jm.neq
  np.testing.assert_allclose(got.qvel[0].numpy(), np.asarray(ref.qvel),
                             **QVEL_TOL)
  ncon = ts.cs.ncon
  np.testing.assert_allclose(
      _sorted_by_group(got.efc_force[0].numpy(), ncon),
      _sorted_by_group(np.asarray(ref.efc_force), ncon), **EFC_TOL)
  assert np.abs(np.asarray(ref.efc_force)).max() > 1.0   # in contact


@pytest.fixture(scope='module')
def pad2cube2():
  """pad2-cube2 at rolling=False from test_torch_physics.py's start state,
  settled by 10 JAX substeps of the 'pallas' path."""
  jm, _ = jmjcf.load_model(reference_xml('geeco-pad2-cube2.xml'))
  tm = convert.model_from_reference(jm)
  js = jbuild(jm, rolling=False)
  ts = tbuild(tm, rolling=False)
  q = js.init_state(jmake_state(jm)).qpos
  for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                    ('robot0:slide2', 0.0)):
    q = jset(jm, q, name, val)
  for name, xy, z in (('object0:joint', (1.3, 0.6), 0.3075),
                      ('object1:joint', (1.25, 0.9), 0.3075),
                      ('goal0:joint', (1.45, 0.6), 0.296),
                      ('goal1:joint', (1.45, 0.9), 0.296)):
    q = jset(jm, q, name, jnp.array([xy[0], xy[1], z, 1, 0, 0, 0]))
  state = js.init_state(jmake_state(jm)).replace(qpos=q)
  sub = jax.jit(lambda s: js.substep(s, 60, 'pallas'))
  for _ in range(10):
    state = sub(state)
  return jm, tm, js, ts, state, sub


def test_constraint_static_rolling_false(pad2cube2):
  _, _, js, ts, _, _ = pad2cube2
  a, b = js.cs, ts.cs
  assert (a.ncon, a.nlim, a.neq, a.ne, a.ncon_sel, a.ngrp) == \
      (b.ncon, b.nlim, b.neq, b.ne, b.ncon_sel, b.ngrp) == \
      (754, 9, 1, 3040, 128, 4)
  np.testing.assert_allclose(b.invweight, a.invweight, rtol=1e-4)


def test_pad2cube2_substep_pallas_matches_jax(pad2cube2):
  _, _, _, ts, state, sub = pad2cube2
  ref = sub(state)
  with SP.capture() as calls:
    got = ts.substep(convert.state_from_reference(state), 60, 'pallas')
  # one fused solve of nI = 4*128 + 2*9 rows, nv=39, one weld (nE=6)
  (c,) = calls
  assert tuple(c['J'].shape) == (1, 530, 39)
  assert tuple(c['A_IE'].shape) == (1, 530, 6)
  np.testing.assert_allclose(got.qvel[0].numpy(), np.asarray(ref.qvel),
                             **QVEL_TOL)
  np.testing.assert_allclose(got.efc_force[0].numpy(),
                             np.asarray(ref.efc_force), **EFC_TOL)
  np.testing.assert_allclose(got.qpos[0].numpy(), np.asarray(ref.qpos),
                             rtol=1e-5, atol=1e-6)


def test_pallas_at_ngrp6_is_psd(pad2cube2):
  """With the rolling rows (ngrp=6) 'pallas' runs the 'psd' iteration and
  never reaches the fused solve, as in the JAX package."""
  _, tm, _, _, state, _ = pad2cube2
  ts6 = tbuild(tm)
  assert ts6.cs.ngrp == 6
  start = ts6.init_state(convert.state_from_reference(state))
  psd = ts6.substep(start, 60, 'psd')
  with SP.capture() as calls:
    pallas = ts6.substep(start, 60, 'pallas')
  assert calls == []
  np.testing.assert_array_equal(pallas.qvel.numpy(), psd.qvel.numpy())
  np.testing.assert_array_equal(pallas.efc_force.numpy(),
                                psd.efc_force.numpy())
  # every JAX method runs; an unknown one raises as in the JAX package
  cg = ts6.substep(start, 60, 'cg')
  assert bool(torch.isfinite(cg.qvel).all())
  with pytest.raises(ValueError, match='unknown solver method'):
    ts6.substep(start, 60, 'newton')


def test_rolling_off_raises_in_both_engines():
  with pytest.raises(ValueError, match='rolling'):
    JEnv('pad2-cube2', rolling='off')
  with pytest.raises(ValueError, match='rolling'):
    TEnv('pad2-cube2', rolling='off', device='cpu')


def test_psd_solve_rejects_bad_operands():
  ops = _torch(_operands(3, B=2))
  kw = dict(K=8, nlim=2, iterations=5)
  with pytest.raises(TypeError, match='float32'):
    SP.psd_solve(**dict(ops, R=ops['R'].double()), **kw)
  with pytest.raises(ValueError, match='contiguous'):
    SP.psd_solve(**dict(ops, X=ops['X'].transpose(1, 2).contiguous()
                        .transpose(1, 2)), **kw)
  with pytest.raises(ValueError, match='device meta'):
    SP.psd_solve(**{k: v.to('meta') for k, v in ops.items()}, **kw)
  with pytest.raises(ValueError, match='must be'):
    SP.psd_solve(**dict(ops, mu_t=ops['mu_t'][:, :4].contiguous()), **kw)
  assert SP.psd_solve.launches == 0


# ---------------------------------------------------------------------------
# the wrapper's launch plan (pure functions of the shapes and B)

PAD2CUBE2 = dict(nI=530, nv=39, nE=6, K=128)    # rolling=False, top-128


@pytest.mark.parametrize('B', [64, 1])
def test_plan_pad2cube2_is_a_resident_pair(B):
  """At the pad2-cube2 shapes every operand is resident on the SM, J's rows
  in registers (one thread per row); a pair of blocks splits an env while
  the card has an SM for each block."""
  lay = SP.plan(B, **PAD2CUBE2)
  assert lay == dict(cluster=2, threads=384, resident=True, jreg=40,
                     xreg=True, smem=lay['smem'])
  assert lay['threads'] >= 265                       # one thread per row
  assert lay['threads'] // 32 >= -(-(39 + 6) // 4)   # a warp per 4 outputs
  # half of X (39 padded rows of 268) + the row vectors
  assert 39 * 268 * 4 < lay['smem'] < 64 * 1024


@pytest.mark.parametrize('B,C', [(66, 2), (67, 1), (256, 1)])
def test_plan_pair_only_while_every_block_has_an_sm(B, C):
  lay = SP.plan(B, **PAD2CUBE2)
  assert lay['cluster'] == C and lay['resident'] and lay['jreg'] == 40
  if C == 1:
    assert lay['threads'] == 544                     # 530 rows, one block
    assert not lay['xreg']         # 96 registers a thread: no room for X
    # X (39 padded rows) + the row vectors: far from J + X = 165 KB
    assert 39 * 532 * 4 < lay['smem'] < 120 * 1024


@pytest.mark.parametrize('C,threads', [(1, 544), (2, 384), (4, 384)])
def test_plan_forced_cluster_splits_the_rows(C, threads):
  lay = SP.plan(64, **PAD2CUBE2, cluster=C)
  assert (lay['cluster'], lay['threads']) == (C, threads)
  assert lay['resident'] and lay['jreg'] == 40
  assert lay['smem'] < SP.plan(64, **PAD2CUBE2, cluster=1)['smem'] or C == 1


@pytest.mark.parametrize('B,shape,want', [
    # K=192 contacts, nv=63: J + X are 396 KB, resident only in a cluster
    (64, dict(nI=786, nv=63, nE=6, K=192),
     dict(cluster=2, resident=True, jreg=0)),
    # nv > 40: J in shared memory; one block when the batch is large
    (128, dict(nI=274, nv=45, nE=6, K=64),
     dict(cluster=1, resident=True, jreg=0)),
    # resident in no cluster of four: J, X stay in device memory
    (3, dict(nI=1298, nv=87, nE=6, K=320),
     dict(cluster=1, resident=False, jreg=0)),
    # no weld rows
    (64, dict(nI=530, nv=39, nE=0, K=128),
     dict(cluster=2, resident=True, jreg=40)),
], ids=['K192_nv63', 'nv45', 'not_resident', 'no_weld'])
def test_plan_by_shape(B, shape, want):
  lay = SP.plan(B, **shape)
  assert {k: lay[k] for k in want} == want
  assert lay['smem'] <= SP._SMEM_MAX
  assert lay['threads'] % 32 == 0 and lay['threads'] <= 1024
  if lay['jreg']:
    assert lay['threads'] <= SP._REG_THREADS


@pytest.mark.parametrize('kw,match', [
    (dict(nI=40000, nv=39, nE=6, K=128), 'fit no block'),
    (dict(**PAD2CUBE2, cluster=3), 'cluster=3'),
    (dict(nI=530, nv=39, nE=33, K=128), 'weld rows'),
], ids=['fits_nothing', 'bad_cluster', 'too_many_weld_rows'])
def test_plan_rejects(kw, match):
  with pytest.raises(ValueError, match=match):
    SP.plan(64, **kw)


def test_smem_bytes_counts_what_is_staged():
  """Resident costs X (and J unless its rows are in registers); a cluster
  halves the share."""
  base = dict(nI=530, nv=39, nE=6, K=128, C=1, threads=544)
  gone = SP._smem_bytes(**base, resident=False, jreg=0)
  regs = SP._smem_bytes(**base, resident=True, jreg=40)
  smem = SP._smem_bytes(**base, resident=True, jreg=0)
  assert regs - gone == 4 * 39 * 532                       # X, padded rows
  assert smem - regs == 4 * (530 * 39 + 4 + 2)             # J (+ alignment)
  half = SP._smem_bytes(**dict(base, C=2, threads=384), resident=True,
                        jreg=40)
  assert half < 0.6 * regs
  assert all(n % 16 == 0 for n in (gone, regs, smem, half))


def test_psd_solve_cluster_argument_on_cpu_runs_the_twin():
  ops = _torch(_operands(5, B=2))
  kw = dict(K=8, nlim=2, iterations=5)
  a = SP.psd_solve(**ops, **kw, cluster=2)
  b = SP.psd_solve_reference(**ops, **kw)
  assert torch.equal(a, b)
  assert SP.psd_solve.launches == 0


def test_kernel_library_is_keyed_by_shape_and_plan():
  """The PSD kernel is compiled per shape: the library's name and its -D
  constants follow the shapes and the plan, and nothing is built until a
  solve on the card asks for it."""
  from geeco_tpu_torch.utils import build
  spec = SP.build_spec(128, 530, 39, 6, 128, 9)
  assert {k: spec[k] for k in build.PSD_KEYS} == dict(
      nI=530, nv=39, nE=6, K=128, nlim=9, ngrp=4, form=0, cluster=1,
      threads=544, resident=True, jreg=40, xreg=False,
      **dict.fromkeys(SP.ORDER_KEYS, 0))
  path, args = build.psd_library(spec)
  assert path.startswith(build.BUILD_DIR) and path.endswith('.so')
  for flag in ('-DPSD_NI=530', '-DPSD_NV=39', '-DPSD_NE=6', '-DPSD_K=128',
               '-DPSD_NLIM=9', '-DPSD_NGRP=4', '-DPSD_FORM=0', '-DPSD_C=1',
               '-DPSD_THREADS=544',
               '-DPSD_RESIDENT=1', '-DPSD_JREG=40', '-DPSD_XREG=0'):
    assert flag in args
  assert build.psd_library(spec)[0] == path
  others = [SP.build_spec(64, 530, 39, 6, 128, 9),          # a pair
            SP.build_spec(128, 530, 39, 0, 128, 9),
            SP.build_spec(128, 786, 63, 6, 192, 9)]
  assert len({path, *(build.psd_library(s)[0] for s in others)}) == 4
  assert build.psd_library(spec, ('PSD_PROFILE=1',))[0] != path
  assert build._load_psd.cache_info().currsize == 0      # nvcc never ran
