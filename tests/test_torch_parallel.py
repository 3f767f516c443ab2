"""Data parallelism of the port (``parallel/mesh.py``): two ranks against one,
on the CPU (gloo, file rendezvous), through the trainer's steps and the
collect and controller CLIs at a small size; and a train step on two ranks
against the JAX package's step sharded over two host devices.

Every multi-process run goes through ``mesh.launch`` with its own timeout
(``LAUNCH_TIMEOUT``): a rank that hangs is killed and the test fails.  The
ranks are spawned interpreters, so the functions they run live at this
module's top level and the reduced physics (``SMALL``) is put in place
inside each rank.  This module imports no JAX at its top: each rank
imports it, and the JAX side runs in a process of its own (``_jax_main``),
which asks XLA for two host devices before JAX is imported.
"""

import csv
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from geeco_tpu_torch.data.dataset import window_indices
from geeco_tpu_torch.envs import base as EB
from geeco_tpu_torch.models import snapshots
from geeco_tpu_torch.models import train as TT
from geeco_tpu_torch.models.e2evmc import make_model
from geeco_tpu_torch.models.params import (create_e2evmc_config,
                                           save_model_config)
from geeco_tpu_torch.parallel import mesh as PM
from geeco_tpu_torch.run import (dataset_tools, gym_pickplace, sim,
                                 train_e2evmc)

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 120    # seconds, each multi-process run
H = W = 16
T, K, B = 10, 3, 4      # episode length, window, batch (2 rows a rank)
CFG = dict(img_height=H, img_width=W, img_channels=3, window_size=K,
           proc_obs='dynimg', proc_tgt='dyndiff', dim_s_obs=20, dim_s_dyn=20,
           dim_s_diff=20, dim_h_lstm=16, dim_h_fc=16, lr=3e-3, batch_size=B,
           compute_dtype='float32', loss_weighting='cmd_mag',
           start_boost=2.0)
# two ranks against one: the same float32 graph on half the rows each, the
# batch means taken as the mean of the ranks' means, so sums run in another
# order (the trainer tests' METRIC_TOL).  The Adam moments are held as the
# trainer tests hold gradients, elementwise to MOMENT_RTOL of each tensor's
# largest entry.  Adam moves a weight by lr * m / sqrt(v): where a gradient
# is near zero that ratio is set by rounding, so the weights are held to
# lr / 30 (the trainer tests hold one step to 2 lr)
METRIC_TOL = dict(rtol=2e-5, atol=1e-6)
MOMENT_RTOL = 1e-4
WEIGHT_ATOL = 1e-4      # lr 3e-3 / 30
SMALL = dict(n_substeps=2, settle_steps=1, solver_iterations=8)
DEV = ['--device', 'cpu', '--seed', '0', '--frame_res', '64', '64']


def _episode_batch(seed=0):
  rng = np.random.RandomState(seed)
  widx = window_indices(T, K, pad_start=False).astype(np.int32)
  N = widx.shape[0]
  cmd = rng.uniform(-1, 1, (B, N, 4)).astype(np.float32)
  cmd[..., 3] = rng.choice([-1.0, 0.0, 1.0], size=(B, N))
  valid = np.ones((N,), bool)
  valid[-1] = False
  return {
      'frames': rng.randint(0, 256, (B, T, H, W, 3)).astype(np.uint8),
      'target_rgb': rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
      'jnt_state': rng.randn(B, T, 7).astype(np.float32),
      'widx': widx, 'valid': valid, 'cmd': cmd,
      'vel_target': rng.randn(B, N, 7).astype(np.float32),
      'ee_target': rng.randn(B, N, 7).astype(np.float32),
      'grp_target': rng.rand(B, N, 2).astype(np.float32),
      'pos_ee': rng.randn(B, N, 3).astype(np.float32),
      'pos_obj': rng.randn(B, N, 3).astype(np.float32),
  }


def _window_batch(seed, first_step):
  rng = np.random.RandomState(seed)
  step = np.arange(1, K + 1)[None].repeat(B, 0) + first_step
  step[B - 1] -= step[B - 1, 0]        # the last env (rank 1's) restarts
  feature = {
      'step': step.astype(np.int32),
      'rgb': rng.randint(0, 256, (B, K, H, W, 3)).astype(np.uint8),
      'jnt_state': rng.randn(B, K, 7).astype(np.float32),
      'ee_state': rng.randn(B, K, 7).astype(np.float32),
      'obj_state': rng.randn(B, K, 7).astype(np.float32),
      'target_rgb': rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
  }
  cmd = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
  cmd[:, 3] = rng.choice([-1.0, 0.0, 1.0], size=B)
  label = {'cmd': cmd, 'vel_target': rng.randn(B, 7).astype(np.float32),
           'ee_target': rng.randn(B, 7).astype(np.float32),
           'grp_target': rng.rand(B, 2).astype(np.float32)}
  return feature, label


def _train_steps(mode, mesh, weights=None, steps=2):
  """``steps`` train steps of the small model from seed 0's weights, or
  from ``weights`` (a state dict), in one process (mesh None) or on this
  rank -> loss, weights and Adam moments after them."""
  config = create_e2evmc_config(CFG)
  dev = 'cpu'
  if mode == 'episode':
    init_fn, train_step, _, _ = TT.make_episode_train_fns(
        config, True, chunk_windows=4, device=dev, mesh=mesh)
  else:
    init_fn, train_step, _, _ = TT.make_train_fns(config, True, device=dev,
                                                  mesh=mesh)
  ts = init_fn(torch.Generator().manual_seed(0), B)
  if weights is not None:
    ts.model.load_state_dict(weights)
  if mesh is not None:
    ts = TT.shard_train_state(ts, mesh)
  part = (lambda b: b) if mesh is None else (
      lambda b: TT.shard_batch(b, mesh))
  losses = []
  for i in range(steps):
    if mode == 'episode':
      batch = (train_e2evmc.to_device(part(_episode_batch(i)), dev),)
    else:
      batch = tuple(train_e2evmc.to_device(part(b), dev)
                    for b in _window_batch(i, first_step=5 * i))
    ts, m = train_step(ts, *batch)
    losses.append({k: float(v) for k, v in m.items()})
  opt = ts.optimizer.state_dict()['state']
  return dict(losses=losses,
              weights=[p.detach().clone() for p in ts.model.parameters()],
              m1=[opt[i]['exp_avg'] for i in sorted(opt)],
              m2=[opt[i]['exp_avg_sq'] for i in sorted(opt)])


def _train_rank(mode):
  return _train_steps(mode, PM.make_mesh(2))


class _ShiftEnv:
  """An env whose step adds the action to every row of its state: enough
  to see which rows a rank steps and where they land."""

  def step(self, es, action):
    return {'q': es['q'] + action[:, None], 'name': es['name']}


def _first_steps_rank(weights):
  """One train step in each mode from ``weights`` ({mode: state dict}),
  and ``batched_env_step`` on a [4] batch on this rank."""
  mesh = PM.make_mesh(2)
  out = {mode: _train_steps(mode, mesh, w, steps=1)
         for mode, w in weights.items()}
  es = {'q': torch.arange(12.0).reshape(4, 3), 'name': 'kept'}
  out['batched_env_step'] = PM.batched_env_step(_ShiftEnv(), mesh)(
      es, torch.arange(4.0))
  return out


@pytest.mark.parametrize('mode', ['episode', 'window'])
def test_train_steps_two_ranks_equal_one(mode, tmp_path):
  """Two steps on 2 ranks (rows split, weights replicated, gradients
  all-reduced) equal two steps on the whole batch in one process: every
  metric (the cmd_mag weights and the canary over the whole batch; in
  window mode the second batch's reset flag is set by rank 1's rows
  alone), every weight and both Adam moments."""
  one = _train_steps(mode, None)
  two = PM.launch(_train_rank, 2, mode, device='cpu',
                  init_dir=str(tmp_path), timeout=LAUNCH_TIMEOUT)
  for a, b in zip(two['losses'], one['losses']):
    assert a.keys() == b.keys()
    for k in b:
      np.testing.assert_allclose(a[k], b[k], err_msg=k, **METRIC_TOL)
  for key in ('weights', 'm1', 'm2'):
    assert len(two[key]) == len(one[key]) > 0
    for a, b in zip(two[key], one[key]):
      b = b.numpy()
      atol = (WEIGHT_ATOL if key == 'weights' else
              MOMENT_RTOL * np.abs(b).max())
      np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                                 err_msg=key)


def _jax_main(out):
  """In a process with two host devices: one train step of the JAX
  package's small model in each mode, its parameters replicated and its
  batch sharded over the two devices (``parallel.mesh.make_mesh``,
  ``models.train.shard_train_state``/``shard_batch``), from seeded
  weights; pickles the weights before, the metrics and the weights after."""
  import jax
  import jax.numpy as jnp
  from geeco_tpu.models import train as JT
  from geeco_tpu.models.params import create_e2evmc_config as jconfig
  from geeco_tpu.parallel.mesh import make_mesh
  assert len(jax.devices()) == 2, jax.devices()
  mesh = make_mesh(2)
  config = jconfig(CFG)
  rng = np.random.RandomState(0)
  res = {}
  for mode in ('episode', 'window'):
    if mode == 'episode':
      fns = JT.make_episode_train_fns(config, True, chunk_windows=4)
      batch = (_episode_batch(0),)
    else:
      fns = JT.make_train_fns(config, True)
      batch = _window_batch(0, first_step=0)
    init_fn, train_step = fns[0], fns[1]
    ts = jax.jit(lambda k: init_fn(k, B))(jax.random.PRNGKey(3))
    # seeded noise on every weight: zero-initialised heads would hide the
    # network behind them
    params = jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.randn(
        *x.shape)).astype(np.float32), ts.params)
    ts = JT.shard_train_state(ts.replace(params=params), mesh)
    batch = tuple(JT.shard_batch(b, mesh) for b in batch)
    assert len(batch[0]['jnt_state'].sharding.device_set) == 2
    ts, metrics = jax.jit(train_step)(ts, *batch)
    res[mode] = dict(before=params,
                     metrics={k: float(v) for k, v in metrics.items()},
                     after=jax.tree.map(np.asarray, ts.params))
  with open(out, 'wb') as f:
    pickle.dump(res, f)


@pytest.fixture(scope='module')
def two_ranks_from_jax(tmp_path_factory):
  """The JAX package's sharded steps (``_jax_main``), and one launch of 2
  port ranks: the first steps from the same weights in both modes, and a
  batched env step."""
  from geeco_tpu_torch.core.convert import e2evmc_params_from_reference
  tmp = tmp_path_factory.mktemp('jax')
  out = str(tmp / 'steps.pkl')
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, JAX_PLATFORMS='cpu',
             XLA_FLAGS='--xla_force_host_platform_device_count=2')
  subprocess.run([sys.executable, '-c',
                  'from tests.test_torch_parallel import _jax_main; '
                  f'_jax_main({out!r})'],
                 cwd=root, env=env, check=True, timeout=LAUNCH_TIMEOUT)
  with open(out, 'rb') as f:
    ref = pickle.load(f)
  port = PM.launch(_first_steps_rank, 2, {
      mode: e2evmc_params_from_reference(r['before'])
      for mode, r in ref.items()}, device='cpu', init_dir=str(tmp),
                   timeout=LAUNCH_TIMEOUT)
  return ref, port


@pytest.mark.parametrize('mode', ['episode', 'window'])
def test_train_step_two_ranks_equal_jax_sharded(mode, two_ranks_from_jax):
  """One train step on 2 ranks equals the JAX package's step with the
  batch sharded over 2 devices, from the same weights on the same batch:
  every metric (episode mode: the cmd_mag weights and the canary over the
  whole batch; window mode: the reset flag) and every weight after the
  step.  Tolerances of the trainer tests: metrics as above, weights 2 lr
  (Adam's first step is about lr * sign(g))."""
  from geeco_tpu_torch.core.convert import e2evmc_params_from_reference
  ref, two = two_ranks_from_jax[0][mode], two_ranks_from_jax[1][mode]
  got = two['losses'][0]
  assert got.keys() == ref['metrics'].keys()
  for k, v in ref['metrics'].items():
    np.testing.assert_allclose(got[k], v, err_msg=k, **METRIC_TOL)
  after = e2evmc_params_from_reference(ref['after'])
  names = [k for k, _ in make_model(create_e2evmc_config(CFG), True,
                                    'cpu').named_parameters()]
  assert sorted(names) == sorted(after) and len(two['weights']) == len(names)
  for name, w in zip(names, two['weights']):
    np.testing.assert_allclose(w.numpy(), after[name].numpy(), rtol=0,
                               atol=2 * CFG['lr'] + 1e-6, err_msg=name)


def test_batched_env_step_two_ranks(two_ranks_from_jax):
  """With a 2-rank mesh each rank steps its rows and every rank gets the
  whole batch back in global order: the step of the whole batch."""
  got = two_ranks_from_jax[1]['batched_env_step']
  assert got['name'] == 'kept'
  assert torch.equal(got['q'], _ShiftEnv().step(
      {'q': torch.arange(12.0).reshape(4, 3), 'name': 'kept'},
      torch.arange(4.0))['q'])


def test_shard_batch_rules():
  """The JAX package's rules: the frame slab, the window matrix and a
  single shared goal frame whole; every other leaf its rows; scalars
  whole; a leading dim the ranks do not divide raises."""
  batch = _episode_batch()
  batch['rgb_frames'] = np.zeros((B + K - 1, H, W, 3), np.uint8)
  batch['target_depth'] = np.zeros((1, H, W, 1), np.float32)
  batch['scale'] = np.float32(2.0)
  for rank in (0, 1):
    got = TT.shard_batch(batch, PM.Mesh(2, rank, torch.device('cpu')))
    for key in ('rgb_frames', 'widx', 'valid', 'target_depth', 'scale'):
      assert got[key] is batch[key], key
    for key in ('frames', 'target_rgb', 'jnt_state', 'cmd', 'pos_obj'):
      np.testing.assert_array_equal(got[key],
                                    batch[key][2 * rank:2 * rank + 2])
  with pytest.raises(ValueError, match=r"batch leaf 'cmd' has leading dim "
                     r'3 not divisible by the 2-device data axis'):
    TT.shard_batch({'cmd': np.zeros((3, 4))},
                   PM.Mesh(2, 0, torch.device('cpu')))
  torch_batch = TT.shard_batch({'x': torch.arange(4)},
                               PM.Mesh(2, 1, torch.device('cpu')))
  assert torch.equal(torch_batch['x'], torch.tensor([2, 3]))


def test_shard_env_batch_and_gather_in_one_rank():
  env_like = {'a': torch.arange(6).reshape(3, 2), 'n': 'kept'}
  one = PM.Mesh(1, 0, torch.device('cpu'))
  assert PM.shard_env_batch(env_like, one)['n'] == 'kept'
  assert torch.equal(PM.all_gather_rows(env_like['a'], one), env_like['a'])
  assert PM.batched_env_step(EB.GeecoEnv, one) is EB.GeecoEnv.step
  with pytest.raises(RuntimeError, match='launch'):
    PM.make_mesh(2)


# ------------------------------------------------------------ the CLIs


def _sim_rank(argv):
  """A rank of a --num_devices CLI run with the reduced physics."""
  sim.GeecoEnv = functools.partial(EB.GeecoEnv, **SMALL)
  return gym_pickplace.main(gym_pickplace.parse(argv))


def _sim_one(argv):
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(sim, 'GeecoEnv', functools.partial(EB.GeecoEnv, **SMALL))
    return gym_pickplace.main(gym_pickplace.parse(argv))


def _collect_argv(wrk, n_devices):
  return DEV + ['--wrk_dir', wrk, '--sim_mode', 'collect',
                '--dataset_formats', 'npz', '--rendering_mode', 'tfrecord',
                '--num_envs', '4', '--end_idx', '6', '--max_episode_steps',
                '3', '--perturb_prefix', '1', '--expert_noise', '0.05',
                '--num_devices', str(n_devices)]


@pytest.fixture(scope='module')
def collected(tmp_path_factory):
  """The same collect (6 episodes, chunks of 4 envs) on one rank and on
  two; the one-rank dataset gets a split of only test episodes."""
  root = tmp_path_factory.mktemp('collect')
  one, two = str(root / 'one'), str(root / 'two')
  rate = _sim_one(_collect_argv(one, 1))
  rate2 = PM.launch(_sim_rank, 2, _collect_argv(two, 2), device='cpu',
                    init_dir=str(root), timeout=LAUNCH_TIMEOUT)
  dataset = os.path.join(one, 'collect')
  dataset_tools.main(dataset_tools.parse([
      'create_splits', '--dataset_dir', dataset, '--split_name', 'test',
      '--ratios', '0', '0', '1']))
  return dict(one=one, two=two, rates=(rate, rate2), dataset=dataset)


def test_collect_two_ranks_writes_one_ranks_episodes(collected):
  """collect --num_devices 2 writes the episodes --num_devices 1 writes:
  the same files and names (two chunks of 4, the second cut to 2: rank 1
  has none there), the same recorded arrays, the same meta."""
  one, two = collected['one'], collected['two']
  rate, rate2 = collected['rates']
  assert rate2 == rate
  data1 = os.path.join(one, 'collect', 'data')
  data2 = os.path.join(two, 'collect', 'data')
  names = sorted(os.listdir(data1))
  assert [n for n in names if n.endswith('.npz')] == [
      f'replay_buffer_{i:04d}.npz' for i in range(1, 7)]
  assert sorted(os.listdir(data2)) == names
  for name in names:
    if name.endswith('.json'):           # the episode's context
      with open(os.path.join(data1, name)) as f1, \
          open(os.path.join(data2, name)) as f2:
        assert f1.read() == f2.read(), name
      continue
    a, b = np.load(os.path.join(data1, name)), np.load(
        os.path.join(data2, name))
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
      if a[key].dtype.kind in 'fc':
        np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-5,
                                   err_msg=f'{name}:{key}')
      else:
        np.testing.assert_array_equal(b[key], a[key],
                                      err_msg=f'{name}:{key}')
  with open(os.path.join(one, 'collect', 'meta_info.json')) as f1, \
      open(os.path.join(two, 'collect', 'meta_info.json')) as f2:
    assert f1.read() == f2.read()


def _model_dir(path):
  config = create_e2evmc_config(dict(CFG, img_height=64, img_width=64,
                                     window_size=2))
  os.makedirs(path)
  save_model_config(config, os.path.join(path, 'e2evmc_config.json'))
  model = make_model(config, True, 'cpu', torch.Generator().manual_seed(1))
  with torch.no_grad():       # the heads act: not all-zero commands
    for p in model.parameters():
      p.add_(0.05 * torch.randn(p.shape,
                                generator=torch.Generator().manual_seed(2)))
  snapshots.save_checkpoint(path, 1, model)
  return path


def _controller_argv(wrk, model_dir, n_devices, dataset=None):
  argv = DEV + ['--wrk_dir', wrk, '--sim_mode', 'controller',
                '--model_dir', model_dir, '--goal_condition', 'target',
                '--num_envs', '4', '--end_idx', '4', '--max_episode_steps',
                '2', '--rendering_mode', 'none', '--num_devices',
                str(n_devices)]
  if dataset:       # the test split's resets, colours and goal frames
    argv += ['--dataset_dir', dataset, '--split_name', 'test',
             '--end_idx', '6']
  return argv


def _rows(path):
  with open(path, newline='') as f:
    return list(csv.reader(f, delimiter=';'))


@pytest.mark.parametrize('resets', ['random', 'dataset'])
def test_controller_rows_two_ranks_equal_one(collected, tmp_path, resets):
  """The batched controller on 2 ranks: the metric rows of every episode
  in global order (random resets: 4 envs; the dataset's test split: its
  6 episodes in chunks of 4, the last cut to 2), written by rank 0, equal
  to the rows of 1 rank, the episodes' colours included."""
  model_dir = _model_dir(str(tmp_path / 'model'))
  dataset = collected['dataset'] if resets == 'dataset' else None
  one, two = str(tmp_path / 'one'), str(tmp_path / 'two')
  rows1 = _sim_one(_controller_argv(one, model_dir, 1, dataset))
  rows2 = PM.launch(_sim_rank, 2, _controller_argv(two, model_dir, 2,
                                                   dataset),
                    device='cpu', init_dir=str(tmp_path),
                    timeout=LAUNCH_TIMEOUT)
  n = 6 if dataset else 4
  assert [r['episode_id'] for r in rows2] == list(range(1, n + 1))
  for a, b in zip(rows2, rows1):
    for key in sim.EVAL_FIELDS:
      if isinstance(b[key], float):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
      else:
        assert a[key] == b[key], key
    if dataset:
      assert torch.equal(a['_rgba'], b['_rgba'])
    else:
      assert a['_rgba'] is b['_rgba'] is None
  csv1 = _rows(os.path.join(one, 'controller', 'eval_results.csv'))
  csv2 = _rows(os.path.join(two, 'controller', 'eval_results.csv'))
  assert csv2[0] == csv1[0] and len(csv2) == len(csv1) == n + 1
  for r2, r1 in zip(csv2[1:], csv1[1:]):
    assert r2[:4] == r1[:4]                 # ids and the success flags
    np.testing.assert_allclose(np.float64(r2[4:8]), np.float64(r1[4:8]),
                               rtol=1e-5, atol=1e-5)


def test_num_devices_checks_before_any_rank_starts(tmp_path):
  """A CUDA run with fewer cards visible than --num_devices raises, in the
  sim CLI and in the trainer; a batch the devices do not divide exits with
  the JAX package's message."""
  if torch.cuda.device_count() >= 2:
    pytest.skip('two cards are visible')
  for device in ('cuda', None):
    argv = ['--wrk_dir', str(tmp_path), '--sim_mode', 'collect',
            '--num_envs', '4', '--num_devices', '2']
    if device:
      argv += ['--device', device]
    with pytest.raises(RuntimeError, match='--num_devices 2'):
      gym_pickplace.main(gym_pickplace.parse(argv))
  with pytest.raises(RuntimeError, match='--num_devices 2'):
    train_e2evmc.main(train_e2evmc.parse([
        '--model_dir', str(tmp_path / 'm'), '--device', 'cuda',
        '--num_devices', '2']))
  with pytest.raises(SystemExit, match='--num_envs 3 not divisible by '
                     '--num_devices 2'):
    gym_pickplace.main(gym_pickplace.parse(DEV + [
        '--wrk_dir', str(tmp_path), '--sim_mode', 'collect', '--num_envs',
        '3', '--num_devices', '2']))
