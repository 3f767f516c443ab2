"""Port parity (the data modules): geeco_tpu_torch.data and the env options
the CLIs set, against the JAX package on the CPU.

1. Records: the expert's 3-step rollout with ``make_record_fn`` in both
   engines from one state (the JAX state carried into the port by
   ``core.convert.env_state_from_reference``): the JAX package's keys,
   shapes and dtypes, values to the env tests' tolerance; the port's frames
   equal to its own ``render``/``render_from_qpos`` of the recorded states
   (the JAX CPU default renders by flat binning, test_torch_render.py).
2. Batches: ``episode_pipeline`` and ``input_pipeline`` of both engines on
   one directory and seed yield identical arrays (a frame dataset, a
   state-only one, a TFRecord-only one).
3. Splits, task CSVs and reset specs as the JAX package's.
4. TFRecord files byte for byte as the JAX package's writer makes them.
5. The env options: ``renderer_kwargs`` (shadows off, binning caps 96/48)
   frames against JAX ``build_renderer(backend='pallas')`` with the same
   options; ``start_sphere_r`` draws in the JAX env's sphere.
"""

import concurrent.futures
import filecmp
import json
import os
import shutil

from tests.conftest import REPO_ROOT
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core import mjcf as jmjcf
from geeco_tpu.core.model import make_state as jmake_state
from geeco_tpu.core.model import set_joint_qpos as jset
from geeco_tpu.data import dataset as JD
from geeco_tpu.data import episode as JE
from geeco_tpu.data import splits as JS
from geeco_tpu.data import tasks as JTK
from geeco_tpu.data import tfrecord_io as JTF
from geeco_tpu.envs.base import make_env as jmake_env
from geeco_tpu.expert import policies as JP
from geeco_tpu.physics import kinematics as JK
from geeco_tpu.render import rasterizer as JR
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.data import dataset as TD
from geeco_tpu_torch.data import episode as TE
from geeco_tpu_torch.data import splits as TS
from geeco_tpu_torch.data import tasks as TTK
from geeco_tpu_torch.data import tfrecord_io as TTF
from geeco_tpu_torch.envs.base import make_env as tmake_env
from geeco_tpu_torch.expert import policies as P
from tests.test_torch_expert import FIXTURES, _jax_env_state, _spec

torch.set_num_threads(1)

# the scene at a small size: 64x64, 2 substeps of 8 solver iterations
SMALL_ENV = dict(frame_res=(64, 64), n_substeps=2, settle_steps=1,
                 solver_iterations=8)
STEPS = 3
# records after 3 control steps of the same float32 physics (the expert
# and env tests' tolerances: tests/test_torch_expert.py, test_torch_env.py)
REC_ATOL = 1e-4
# full frames: projections differ by float32 rounding, so a pixel on a
# triangle edge may flip (test_torch_render.py)
FRAME_MISMATCH_TOL = 1e-3


# ---------------------------------------------------------------- 1. records


def _port_start():
  fx = np.load(os.path.join(REPO_ROOT, 'tests', 'fixtures',
                            FIXTURES['pad2-cube2']))
  te = tmake_env('pad2-cube2', device='cpu', **SMALL_ENV)
  return te, te.reset_to(_spec(fx, 2))


@pytest.fixture(scope='module')
def recorded():
  """Both engines' records of the expert's 3 steps from one state."""
  # the port sets up in a worker thread while XLA compiles the JAX rollout
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    port = pool.submit(_port_start)
    je = jmake_env('pad2-cube2', **SMALL_ENV)
    expert = JP.make_expert(je)
    jrecord = JE.make_record_fn(je, with_frames=False, with_state=True)
    jroll = jax.jit(jax.vmap(lambda e: JP.rollout(
        je, e, expert, length=STEPS, record_fn=jrecord)))
    te, es = port.result(timeout=600)
  jes = _jax_env_state(es)
  _, jrec = jroll(jes)
  es0 = convert.env_state_from_reference(jes)
  trecord = TE.make_record_fn(te, with_frames=True, with_depth=True,
                              with_state=True)
  _, trec = P.rollout(te, es0, P.make_expert(te), length=STEPS,
                      record_fn=trecord)
  return je, te, es0, {k: np.asarray(v) for k, v in jrec.items()}, trec


def test_records_match_jax(recorded):
  je, te, _, jrec, trec = recorded
  got = {k: v.numpy() for k, v in trec.items()}
  assert set(got) == set(jrec) | {'rgb', 'depth'}
  for k, ref in jrec.items():
    assert got[k].shape == ref.shape, k
    assert got[k].dtype == ref.dtype, (k, got[k].dtype, ref.dtype)
    if np.issubdtype(ref.dtype, np.integer):
      np.testing.assert_array_equal(got[k], ref, err_msg=k)
    else:
      np.testing.assert_allclose(got[k], ref, atol=REC_ATOL, err_msg=k)
  assert got['step'].tolist() == [list(range(STEPS))] * 2
  assert got['rgb'].shape == (2, STEPS, 64, 64, 3)
  assert got['rgb'].dtype == np.uint8 and got['depth'].dtype == np.float32
  # the meta the dataset carries is the JAX package's
  assert TE.meta_info_dict(te) == JE.meta_info_dict(je)


def test_recorded_frames_are_the_renders(recorded):
  """The frames recorded at each step are the port's own render of that
  step's state, bit for bit: env.render of the start state, and
  render_from_qpos of every recorded full_qpos + mocap + colours."""
  _, te, es0, _, trec = recorded
  rgb0, depth0 = te.render(es0)
  assert torch.equal(trec['rgb'][:, 0], rgb0)
  assert torch.equal(trec['depth'][:, 0], depth0)
  for t in range(STEPS):
    rgb, depth = te.render_from_qpos(trec['full_qpos'][:, t],
                                     trec['mocap_qpos-robot0:mocap'][:, t],
                                     es0.rgba)
    assert torch.equal(trec['rgb'][:, t], rgb), t
    assert torch.equal(trec['depth'][:, t], depth), t


def test_record_fn_rejects_textures(recorded):
  _, te, es0, _, _ = recorded
  record = TE.make_record_fn(te, with_frames=False)
  with pytest.raises(NotImplementedError, match='item 17'):
    record(te, es0, torch.zeros(2, 4), None, textures=torch.zeros(1))


# ---------------------------------------------------------------- 2. batches

H = W = 16
T = 10
K = 3
NQ, NGEOM = 9, 5


def _episode(seed, kind):
  """A synthetic episode in the collect schema (data/episode.py)."""
  rng = np.random.RandomState(seed)
  ep = {
      'step': np.arange(T, dtype=np.int32),
      'ts': np.arange(T, dtype=np.float32) * 0.04,
      'cmd': np.clip(rng.randn(T, 4), -1, 1).astype(np.float32),
      'ctrl': rng.randn(T, 2).astype(np.float32),
      'mocap_qpos-robot0:mocap': rng.randn(T, 7).astype(np.float32),
      'goal_qpos': rng.randn(T, 7).astype(np.float32),
      'obj_qpos': rng.randn(T, 7).astype(np.float32),
  }
  for j in TD.ARM_JOINTS + TD.FINGER_JOINTS:
    ep[f'joint_qpos-{j}'] = rng.randn(T).astype(np.float32)
    ep[f'joint_qvel-{j}'] = rng.randn(T).astype(np.float32)
  if kind == 'states':
    ep['full_qpos'] = rng.randn(T, NQ).astype(np.float32)
    ep['rgba'] = rng.rand(NGEOM, 4).astype(np.float32)
  else:
    ep['rgb'] = rng.randint(0, 255, (T, H, W, 3), dtype=np.uint8)
    ep['depth'] = rng.rand(T, H, W).astype(np.float32)
  return ep


def _write_dataset(root, kind, n=7):
  meta = {'episode_length': T, 'img_height': H, 'img_width': W}
  os.makedirs(os.path.join(root, 'meta'))
  with open(os.path.join(root, 'meta', 'meta_info.json'), 'w') as fp:
    json.dump(meta, fp)
  names = []
  for i in range(n):
    name = f'replay_buffer_{i + 1:04d}'
    ctx = dict(meta, task_goal=f'goal{i % 2}', task_object=f'object{i % 3}')
    ep = _episode(i, kind)
    if kind == 'tfrecord':
      TTF.write_episode_tfrecord(
          os.path.join(root, 'data', name + '.tfrecord.zlib'), ep, ctx)
    else:
      TE.save_episode_npz(os.path.join(root, 'data', name + '.npz'), ep,
                          ctx)
    names.append(name)
  os.makedirs(os.path.join(root, 'splits', 'default'))
  for mode, sel in (('train', names[:5]), ('eval', names[5:]),
                    ('test', names[5:])):
    with open(os.path.join(root, 'splits', 'default', mode + '.txt'),
              'w') as fp:
      fp.write('\n'.join(sel) + '\n')
  return root


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
  base = tmp_path_factory.mktemp('tds')
  return {kind: _write_dataset(str(base / kind), kind)
          for kind in ('frames', 'states', 'tfrecord')}


def _assert_same(got, ref, where):
  assert type(got) is type(ref), where
  if isinstance(ref, dict):
    assert set(got) == set(ref), (where, set(got) ^ set(ref))
    for k in ref:
      _assert_same(got[k], ref[k], f'{where}.{k}')
  elif isinstance(ref, tuple):
    assert len(got) == len(ref), where
    for i, (g, r) in enumerate(zip(got, ref)):
      _assert_same(g, r, f'{where}[{i}]')
  else:
    assert got.dtype == ref.dtype, (where, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=where)


@pytest.mark.parametrize('pipeline', ['episode', 'input'])
@pytest.mark.parametrize('kind', ['frames', 'states', 'tfrecord'])
def test_pipelines_match_jax(datasets, kind, pipeline):
  ds = datasets[kind]
  with_depth = kind != 'states'
  if pipeline == 'episode':
    # one epoch: with two, the prefetch thread's second permutation and
    # the consumer's shift draws share one RandomState in either order
    kw = dict(batch_episodes=2, window_size=K, fetch_target=True,
              num_epochs=1, seed=5, with_depth=with_depth, aug_shift=2)
    got = list(TD.episode_pipeline(ds, 'default', 'train', **kw))
    ref = list(JD.episode_pipeline(ds, 'default', 'train', **kw))
  else:
    kw = dict(window_size=K, fetch_target=True, batch_size=4, seed=5,
              with_depth=with_depth)
    got = list(TD.input_pipeline(ds, 'default', 'train', **kw))
    ref = list(JD.input_pipeline(ds, 'default', 'train', **kw))
  assert len(got) == len(ref) > 1
  for i, (g, r) in enumerate(zip(got, ref)):
    _assert_same(g, r, f'{kind} {pipeline} batch {i}')
  if pipeline == 'episode':   # state-only batches ship the states to render
    assert ('qpos' in got[0]) == (kind == 'states')
    assert ('frames' in got[0]) == (kind != 'states')


def test_loaders_match_jax(datasets):
  for kind, ds in datasets.items():
    for path in TD.list_records(ds):
      assert path in JD.list_records(ds)
      got, gctx = TE.load_episode(path)
      ref, rctx = JE.load_episode(path)
      assert gctx == rctx, kind
      _assert_same(got, ref, path)
  assert TD.get_meta(ds) == JD.get_meta(ds)


# ---------------------------------------------------------------- 3. splits


@pytest.mark.parametrize('split_name,ratios', [('default', None),
                                                ('debug', None),
                                                ('custom', (0.5, 0.3, 0.2))])
def test_create_split_matches_jax(datasets, tmp_path, split_name, ratios):
  roots = {}
  for engine in ('port', 'jax'):
    roots[engine] = str(tmp_path / engine)
    shutil.copytree(datasets['frames'], roots[engine])
  got = TS.create_split(roots['port'], split_name, ratios=ratios, seed=3)
  ref = JS.create_split(roots['jax'], split_name, ratios=ratios, seed=3)
  assert got == ref
  for mode in ('train', 'eval', 'test'):
    assert filecmp.cmp(
        os.path.join(roots['port'], 'splits', split_name, f'{mode}.txt'),
        os.path.join(roots['jax'], 'splits', split_name, f'{mode}.txt'),
        shallow=False)


class EnvStub:
  obj_joint_names = ('object0:joint', 'object1:joint', 'goal0:joint',
                     'goal1:joint')
  goal_sites = ('goal0', 'goal1')
  cube_sites = ('object0', 'object1')


def test_tasks_match_jax(tmp_path):
  header, rows = TTK.generate_tasks('pad2-cube2', 6, seed=3)
  jheader, jrows = JTK.generate_tasks('pad2-cube2', 6, seed=3)
  assert header == jheader and rows == jrows
  path = str(tmp_path / 'init.csv')
  TTK.write_task_csv(path, header, rows)
  jpath = str(tmp_path / 'jinit.csv')
  JTK.write_task_csv(jpath, jheader, jrows)
  assert filecmp.cmp(path, jpath, shallow=False)
  for start, end in ((0, 10 ** 9), (1, 4)):
    got = TTK.load_reset_specs(EnvStub(), path, start, end)
    ref = JTK.load_reset_specs(EnvStub(), path, start, end)
    for name in ('obj_qpos', 'mocap_qpos', 'task_goal', 'task_object'):
      g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
      assert g.shape == r.shape, name
      np.testing.assert_array_equal(g, r, err_msg=name)
    assert got.obj_qpos.dtype == torch.float32
    assert got.task_goal.dtype == torch.int64 and got.arm_qpos is None


# ---------------------------------------------------------------- 4. tfrecord


@pytest.mark.parametrize('compression,name', [('zlib', 'ep.tfrecord.zlib'),
                                              ('none', 'ep.tfrecord')])
def test_tfrecord_bytes_match_jax(tmp_path, compression, name):
  ep = _episode(3, 'frames')
  ctx = {'episode_length': T, 'img_height': H, 'img_width': W,
         'task_goal': 'goal1', 'monitored_joints': ['a', 'b'],
         'expert_noise': 0.25}
  paths = {}
  for engine, mod in (('port', TTF), ('jax', JTF)):
    paths[engine] = str(tmp_path / engine / name)
    mod.write_episode_tfrecord(paths[engine], ep, ctx, compression)
  assert filecmp.cmp(paths['port'], paths['jax'], shallow=False)
  got, gctx = TE.load_episode(paths['port'])
  assert gctx['task_goal'] == 'goal1' and gctx['monitored_joints'] == ['a',
                                                                      'b']
  np.testing.assert_array_equal(got['rgb'], ep['rgb'])
  np.testing.assert_array_equal(got['step'], ep['step'])


def test_tfrecord_keeps_renderer_kwargs(tmp_path):
  """The collect context carries renderer_kwargs (a dict, which the JAX
  package's writer rejects): the port writes its JSON text, reads it back
  as the dict, and the JAX reader reads the file."""
  path = str(tmp_path / 'ep.tfrecord.zlib')
  rk = {'coarse_k': 96, 'mid_k': 48, 'shadows': False}
  TTF.write_episode_tfrecord(path, _episode(1, 'frames'),
                             {'img_height': H, 'img_width': W,
                              'renderer_kwargs': rk})
  _, ctx = TE.load_episode(path)
  assert ctx['renderer_kwargs'] == rk
  ep, jctx = JE.load_episode(path)
  assert ep['rgb'].shape == (T, H, W, 3)
  assert json.loads(jctx['renderer_kwargs'][0]) == rk


# ---------------------------------------------------------------- 5. options


@pytest.fixture(scope='module')
def frame64():
  """A JAX kin of pad2-cube2 with both cubes on the table and its colours
  (the frame of test_torch_render.py)."""
  jm, ja = jmjcf.load_model(os.path.join(
      REPO_ROOT, 'geeco_tpu', 'assets_gym', 'envs', 'geeco-pad2-cube2.xml'))
  st = jmake_state(jm)
  q = st.qpos
  for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                    ('robot0:slide2', 0.0)):
    q = jset(jm, q, name, val)
  for name, xy in (('object0:joint', (1.3, 0.6)),
                   ('object1:joint', (1.3, 0.9)),
                   ('goal0:joint', (1.45, 0.6)),
                   ('goal1:joint', (1.45, 0.9))):
    z = 0.3075 if name.startswith('object') else 0.296
    q = jset(jm, q, name, jnp.array([xy[0], xy[1], z, 1, 0, 0, 0]))
  kin = jax.jit(lambda s: JK.fk(jm, s))(st.replace(qpos=q))
  return jm, ja, kin, jm.geom_rgba


RENDER_OPTS = dict(shadows=False, coarse_k=96, mid_k=48)


def test_renderer_kwargs_match_jax(frame64):
  jm, ja, kin, rgba = frame64
  te = tmake_env('pad2-cube2', frame_res=(64, 64), device='cpu',
                 renderer_kwargs=RENDER_OPTS)
  r = te.renderer
  assert (r.shadows, r.coarse_k, r.mid_k) == (False, 96, 48)
  assert te.renderer_kwargs == RENDER_OPTS
  jr = JR.build_renderer(jm, ja, width=64, height=64, backend='pallas',
                         **RENDER_OPTS)
  rgb_ref, depth_ref = jax.jit(jr.render)(kin, rgba)
  rgb, depth = r.render(convert.kin_from_reference(kin),
                        torch.as_tensor(np.array(rgba))[None])
  rgb_ref, depth_ref = np.asarray(rgb_ref), np.asarray(depth_ref)
  mism = (rgb[0].numpy() != rgb_ref).any(-1)
  assert mism.mean() <= FRAME_MISMATCH_TOL, f'{mism.sum()} pixels differ'
  np.testing.assert_allclose(depth[0].numpy()[~mism], depth_ref[~mism],
                             rtol=1e-4, atol=1e-4)
  # the options change the frame: the default renderer casts shadows
  rgb_on, _ = tmake_env('pad2-cube2', frame_res=(64, 64),
                        device='cpu').renderer.render(
      convert.kin_from_reference(kin), torch.as_tensor(np.array(rgba))[None])
  assert not torch.equal(rgb_on, rgb)


def test_tex_grid_matches_jax_scene(frame64):
  jm, ja, _, _ = frame64
  for tex_grid in (0, 4):
    te = tmake_env('pad2-cube2', frame_res=(64, 64), device='cpu',
                   renderer_kwargs={'tex_grid': tex_grid})
    jr = JR.build_renderer(jm, ja, width=64, height=64, tex_grid=tex_grid)
    assert te.renderer.scene.tri.shape == jr.scene.tri.shape, tex_grid


def test_unported_renderer_options_raise():
  with pytest.raises(NotImplementedError, match='item'):
    tmake_env('pad2-cube2', device='cpu',
              renderer_kwargs={'analytic_rects': True})


def test_start_sphere_draws_in_the_jax_sphere():
  r = 0.2
  je = jmake_env('pad2-cube2', settle_steps=0, start_sphere_r=r)
  te = tmake_env('pad2-cube2', settle_steps=0, start_sphere_r=r,
                 device='cpu')
  np.testing.assert_array_equal(te.robot_xpos0, je.robot_xpos0)
  es = te.reset_random(256, torch.Generator().manual_seed(0))
  d = np.linalg.norm(es.phys.mocap_pos[:, 0].numpy() - je.robot_xpos0, axis=-1)
  je.setup()
  jes = jax.jit(jax.vmap(je.reset_random))(
      jax.random.split(jax.random.PRNGKey(0), 256))
  jd = np.linalg.norm(np.asarray(jes.phys.mocap_pos[:, 0]) - je.robot_xpos0,
                      axis=-1)
  # both inside the ball of radius r around the same centre, and filling it
  # (256 uniform draws: the largest radius is above 0.8 r but for 0.8^768)
  for dist in (d, jd):
    assert dist.max() <= r * (1 + 1e-5)
    assert dist.max() > 0.8 * r
