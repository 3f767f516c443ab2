"""Port parity (the JAX package's levers and utilities): the block
Gauss-Jordan mass inverse (``mass_inverse='blockgj'``), the scan-unroll
hints, ``GeecoEnv``'s renderer options, and ``utils/profiling.py``, on the
CPU, against the JAX package where it has a counterpart.
"""

import concurrent.futures
import functools
import json
import os
import time

from tests.conftest import reference_xml
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core import mjcf as jmjcf
from geeco_tpu.core.model import make_state as jmake_state
from geeco_tpu.envs.base import ResetSpec as JSpec
from geeco_tpu.envs.base import make_env as jmake_env
from geeco_tpu.physics import dynamics as JD
from geeco_tpu.physics import kinematics as JK
from geeco_tpu.physics import linalg as JL
from geeco_tpu.render import rasterizer as JR
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.envs import base as EB
from geeco_tpu_torch.physics import dynamics as TD
from geeco_tpu_torch.physics import kinematics as TK
from geeco_tpu_torch.physics import linalg as TL
from geeco_tpu_torch.utils import profiling

torch.set_num_threads(1)

# the explicit inverse: float32 elimination in the same order, products
# summed in another; compared relative to each block's largest entry
MINV_RTOL = 1e-4
# qacc_smooth = M^-1 qfrc: the 1e11-damped world slides make it the
# difference of large terms (tests/test_torch_physics.py's tolerance)
QACC_TOL = dict(rtol=1e-4, atol=1e-4)
# one control step (2 substeps of 8 PSD iterations) from the same state
QPOS_ATOL = 1e-4
SMALL = dict(n_substeps=2, settle_steps=1, solver_iterations=8)


def _spd(rng, batch, n):
  a = rng.normal(size=(batch, n, n)).astype(np.float32)
  return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


def test_gj_inverse_matches_jax():
  rng = np.random.RandomState(0)
  A = _spd(rng, 3, 7)
  ref = np.asarray(JL.gj_inverse(jnp.asarray(A)))
  got = TL.gj_inverse(torch.as_tensor(A)).numpy()
  np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(got @ A, np.broadcast_to(np.eye(7), A.shape),
                             atol=1e-4)


@pytest.mark.parametrize('xml', ['geeco-pad2-cube2.xml',
                                 'geeco-pad2-cube2-clutter4.xml',
                                 'geeco-nut-cone.xml'])
def test_blockgj_smooth_dynamics_matches_jax(xml):
  """minv and qacc_smooth of 'blockgj' against the JAX package's, on a
  perturbed state of each scene; the port's 'chol' gives the same qacc."""
  jm, _ = jmjcf.load_model(reference_xml(xml))
  tm = convert.model_from_reference(jm)
  anc = JK.ancestor_mask(jm)
  np.testing.assert_array_equal(TK.ancestor_mask(tm), anc)
  blocks = TL.dof_blocks(anc)
  assert [b.tolist() for b in blocks] == [b.tolist()
                                          for b in JL.dof_blocks(anc)]
  assert len(blocks) > 1                  # the chain and the free bodies
  rng = np.random.RandomState(len(xml))
  st = jmake_state(jm)
  st = st.replace(
      qpos=jnp.asarray(np.asarray(st.qpos) + rng.normal(
          0, 0.01, st.qpos.shape), jnp.float32),
      qvel=jnp.asarray(rng.normal(0, 0.1, st.qvel.shape), jnp.float32))
  dt = jm.opt.timestep
  ref = jax.jit(lambda s: JD.smooth_dynamics(jm, s, anc, dt,
                                             mass_inverse='blockgj'))(st)
  tst = convert.state_from_reference(st)
  got = TD.smooth_dynamics(tm, tst, anc, tm.opt.timestep,
                           mass_inverse='blockgj')
  assert got.chol is None and ref.chol is None
  minv, minv_ref = got.minv[0].numpy(), np.asarray(ref.minv)
  for idx in blocks:
    sub = np.ix_(idx, idx)
    scale = np.abs(minv_ref[sub]).max()
    np.testing.assert_allclose(minv[sub] / scale, minv_ref[sub] / scale,
                               atol=MINV_RTOL, err_msg=str(idx))
  off = np.ones_like(minv, bool)
  for idx in blocks:
    off[np.ix_(idx, idx)] = False
  assert not minv[off].any()              # block-diagonal by construction
  np.testing.assert_allclose(got.qacc_smooth[0].numpy(),
                             np.asarray(ref.qacc_smooth), **QACC_TOL)
  chol = TD.smooth_dynamics(tm, tst, anc, tm.opt.timestep)
  assert chol.minv is None
  np.testing.assert_allclose(got.qacc_smooth.numpy(),
                             chol.qacc_smooth.numpy(), **QACC_TOL)


def test_unknown_mass_inverse_raises():
  with pytest.raises(ValueError, match='mass_inverse'):
    EB.make_env('pad2-cube2', mass_inverse='lu', device='cpu')


def _port_steps(obj, mocap, state_ref, cmd):
  """One control step of the port's env from the JAX reset state, under
  'blockgj' and under 'chol'."""
  out = {}
  for mi in ('blockgj', 'chol'):
    te = EB.make_env('pad2-cube2', frame_res=(64, 64), mass_inverse=mi,
                     device='cpu', **SMALL)
    tes = convert.env_state_from_reference(state_ref)
    out[mi] = te.step(tes, torch.as_tensor(cmd)[None]).phys.qpos[0].numpy()
  return out


def test_blockgj_control_step_matches_jax():
  fx = np.load(os.path.join(os.path.dirname(__file__), 'fixtures',
                            'mujoco_pickplace_pad2cube2.npz'))
  obj = fx['init_obj_qpos'].copy()
  obj[:, 2] -= 0.025
  je = jmake_env('pad2-cube2', frame_res=(64, 64), mass_inverse='blockgj',
                 **SMALL)
  jes = je.reset_to(JSpec(obj_qpos=jnp.asarray(obj),
                          mocap_qpos=jnp.asarray(fx['init_mocap_qpos']),
                          task_goal=jnp.asarray(0, jnp.int32),
                          task_object=jnp.asarray(0, jnp.int32)),
                    jax.random.PRNGKey(0))
  cmd = fx['cmds'][0]
  # the port in a worker thread while XLA compiles the JAX step
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    port = pool.submit(_port_steps, obj, fx['init_mocap_qpos'],
                       jax.tree.map(lambda x: x[None], jes), cmd)
    ref = np.asarray(jax.jit(je.step)(jes, jnp.asarray(cmd)).phys.qpos)
    got = port.result(timeout=600)
  np.testing.assert_allclose(got['blockgj'], ref, atol=QPOS_ATOL)
  np.testing.assert_allclose(got['blockgj'], got['chol'], atol=QPOS_ATOL)


@pytest.fixture(scope='module')
def small_env_state():
  te = EB.make_env('pad2-cube2', frame_res=(64, 64), device='cpu', **SMALL)
  return te, te.reset_random(2, torch.Generator().manual_seed(0))


@pytest.mark.parametrize('unroll', [1, 4, True])
def test_unroll_hints_leave_the_step_unchanged(small_env_state, unroll):
  te, es = small_env_state
  act = torch.tensor([[0.3, -0.2, 0.1, 1.0], [-0.1, 0.2, 0.0, -1.0]])
  ref = te.step(es, act).phys
  hinted = EB.make_env('pad2-cube2', frame_res=(64, 64), device='cpu',
                       substep_unroll=unroll, solver_unroll=unroll, **SMALL)
  got = hinted.step(es, act).phys
  assert torch.equal(got.qpos, ref.qpos) and torch.equal(got.qvel, ref.qvel)


@pytest.mark.parametrize('bad,err', [(-1, ValueError), (2.5, TypeError)])
def test_unroll_hints_validated_as_jax_scan(bad, err):
  """A bool or a non-negative int, as ``jax.lax.scan`` takes them."""
  if bad == -1:
    with pytest.raises(err, match='non-negative'):
      jax.lax.scan(lambda c, _: (c + 1, None), 0, None, length=3,
                   unroll=bad)
  for key in ('substep_unroll', 'solver_unroll'):
    with pytest.raises(err):
      EB.make_env('pad2-cube2', device='cpu', **{key: bad})


# every option of build_renderer, none at its default
EVERY_OPTION = dict(camera='external_camera_0', tile=8, tris_per_tile=80,
                    chunk=16, znear=0.06, zfar=8.0, mesh_face_budget=300,
                    tex_grid=4, depth_gl=True, cull=0, coarse=2,
                    coarse_k=400, mid_k=160, backend='pallas',
                    shadows=False, rect_pixel_texels=True,
                    analytic_rects=True)


def test_renderer_options_are_build_renderers_keywords():
  import inspect
  assert set(EB.RENDERER_OPTIONS) == set(EVERY_OPTION)
  jkeys = set(inspect.signature(JR.build_renderer).parameters) - {
      'model', 'assets', 'width', 'height'}
  assert set(EB.RENDERER_OPTIONS) == jkeys


def test_env_with_every_renderer_option_matches_jax():
  """GeecoEnv(renderer_kwargs=...) with every key builds the renderer the
  JAX env builds: the same frame of the same state."""
  te = EB.make_env('pad2-cube2', frame_res=(64, 64), device='cpu',
                   settle_steps=0, renderer_kwargs=EVERY_OPTION)
  je = jmake_env('pad2-cube2', frame_res=(64, 64),
                 renderer_kwargs=EVERY_OPTION)
  assert te.renderer_kwargs == EVERY_OPTION
  st = jmake_state(je.model)
  kin = jax.jit(lambda s: JK.fk(je.model, s))(st)
  rgba = jnp.asarray(te.rgba0)
  rgb_ref, depth_ref = jax.jit(je.renderer.render)(kin, rgba)
  rgb, depth = te.render_from_qpos(
      torch.as_tensor(np.asarray(st.qpos))[None],
      torch.cat([torch.as_tensor(np.asarray(st.mocap_pos[0])),
                 torch.as_tensor(np.asarray(st.mocap_quat[0]))])[None],
      torch.as_tensor(te.rgba0)[None])
  mism = (rgb[0].numpy() != np.asarray(rgb_ref)).any(-1)
  assert mism.mean() <= 1e-3, f'{mism.sum()} pixels differ'
  depth, depth_ref = depth[0].numpy(), np.asarray(depth_ref)
  assert 0.0 <= depth.min() and depth.max() <= 1.0       # depth_gl
  np.testing.assert_allclose(depth[~mism], depth_ref[~mism], rtol=1e-4,
                             atol=1e-4)
  assert te.renderer.path_counts == {'hierarchical': 1}


def test_unknown_renderer_option_raises_type_error():
  with pytest.raises(TypeError, match='analytic_rect'):
    EB.make_env('pad2-cube2', device='cpu',
                renderer_kwargs={'analytic_rect': True})
  with pytest.raises(TypeError, match='analytic_rect'):
    jmake_env('pad2-cube2', renderer_kwargs={'analytic_rect': True})


# ------------------------------------------------------------- profiling


def test_step_timer(tmp_path):
  """tests/test_utils.py's expectations of the JAX package's StepTimer."""
  jsonl = str(tmp_path / 't.jsonl')
  timer = profiling.StepTimer('unit', window=4, jsonl_path=jsonl)
  for _ in range(6):
    with timer:
      time.sleep(0.002)
  s = timer.stats()
  assert set(s) == {'mean_s', 'p50_s', 'p95_s', 'rate_hz'}
  assert 0.001 < s['mean_s'] < 0.2 and len(timer.times) == 4
  assert 'Hz' in timer.report()
  timer.close()
  lines = [json.loads(l) for l in open(jsonl).read().strip().splitlines()]
  assert [l['n'] for l in lines] == [1, 2, 3, 4, 5, 6]
  assert all(l['name'] == 'unit' and l['dt'] > 0 for l in lines)
  assert profiling.StepTimer('empty').report() == 'empty: no samples'


def test_trace_writes_a_chrome_trace(tmp_path):
  with profiling.trace(str(tmp_path / 'prof')):
    x = torch.randn(64, 64)
    (x @ x).sum()
  files = os.listdir(tmp_path / 'prof')
  assert len(files) == 1 and files[0].endswith('.json')
  path = tmp_path / 'prof' / files[0]
  assert path.stat().st_size > 0
  events = json.load(open(path))['traceEvents']
  assert any('mm' in e.get('name', '') for e in events)


def test_trainer_meta_path_rerenders_jax_frames(monkeypatch):
  """A JAX dataset meta whose renderer_kwargs name depth_gl and the
  analytic rects: the trainer's re-render env (run/train_e2evmc.py's meta
  path) renders the frames the JAX env renders from the same state.
  (Per-pixel texels: jitted, XLA moves cell-quantized texels that sit on a
  texel edge, tests/test_torch_render_options.py.)"""
  from geeco_tpu.data.episode import meta_info_dict
  from geeco_tpu_torch.run.train_e2evmc import render_env
  rkw = dict(depth_gl=True, analytic_rects=True, rect_pixel_texels=True,
             backend='pallas')
  je = jmake_env('pad2-cube2', frame_res=(64, 64), renderer_kwargs=rkw)
  meta = json.loads(json.dumps(meta_info_dict(je)))     # as on disk
  assert meta['renderer_kwargs'] == rkw
  # the settled set-up only fills the state's other fields: skip settling
  monkeypatch.setattr(EB, 'make_env', functools.partial(EB.make_env,
                                                        settle_steps=0))
  te = render_env(meta, device='cpu')
  assert te.renderer.depth_gl and te.renderer.scene.rect_geom.size
  st = jmake_state(je.model)
  rgba = np.asarray(te.rgba0)
  rgb_ref, depth_ref = jax.jit(je.renderer.render)(
      jax.jit(lambda s: JK.fk(je.model, s))(st), jnp.asarray(rgba))
  # the recorded state the trainer reads: full qpos, mocap pose, colours
  rgb, depth = te.render_from_qpos(
      torch.as_tensor(np.asarray(st.qpos))[None],
      torch.as_tensor(np.concatenate([np.asarray(st.mocap_pos[0]),
                                      np.asarray(st.mocap_quat[0])]))[None],
      torch.as_tensor(rgba)[None])
  mism = (rgb[0].numpy() != np.asarray(rgb_ref)).any(-1)
  assert mism.mean() <= 1e-3, f'{mism.sum()} pixels differ'
  np.testing.assert_allclose(depth[0].numpy()[~mism],
                             np.asarray(depth_ref)[~mism], rtol=1e-4,
                             atol=1e-4)
  assert float(depth.max()) <= 1.0
