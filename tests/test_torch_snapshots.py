"""Port parity (checkpoints and serving): geeco_tpu_torch.models.snapshots
and models.predictor on the CPU.

1. Snapshots: a checkpoint restores the weights bit for bit and the rolling
   GC keeps the last ones; a train state restored into a fresh trainer
   takes the next step exactly as the unbroken run does (Adam's moments and
   its own step count come back); the best-K snapshot index, its order and
   its GC match the JAX package's on the same losses.
2. The predictors against the JAX package's, with the flax weights carried
   across by ``convert.e2evmc_params_from_reference`` and served from the
   port's own checkpoint file: window mode with the dynamic image (compared
   from the first window of distinct frames on: a padded start window's
   dynamic image is rounding noise, ROADMAP Queue 3), persistent mode with
   proc_obs='sequence', encoders 20 wide.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.models import e2evmc as JM
from geeco_tpu.models import predictor as JPR
from geeco_tpu.models import snapshots as JSN
from geeco_tpu.models.params import create_e2evmc_config
from geeco_tpu_torch.core.convert import e2evmc_params_from_reference
from geeco_tpu_torch.models import e2evmc as TM
from geeco_tpu_torch.models import predictor as TPR
from geeco_tpu_torch.models import snapshots as TSN
from geeco_tpu_torch.models import train as TT
from geeco_tpu_torch.models.params import save_model_config
from tests.test_torch_train import _state_batch, _stub_torch, _torch_batch

torch.set_num_threads(1)

S = 32      # frame side: the encoders reach 1x1 maps
# float32 model in both engines: the same graph, sums in another order
F32_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 7   # predict calls per episode


def _cfg(**kw):
  # encoders 20 wide: the last GroupNorm (1x1) is one group of 20 channels
  d = dict(img_height=S, img_width=S, window_size=3, dim_s_obs=20,
           dim_s_dyn=20, dim_s_diff=20, dim_h_lstm=16, dim_h_fc=16,
           compute_dtype='float32', lr=3e-3)
  d.update(kw)
  return create_e2evmc_config(d)


def _small_model(seed=0):
  return TM.make_model(_cfg(), True, device='cpu',
                       generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------- 1. snapshots


def test_checkpoint_roundtrip_and_rolling_gc(tmp_path):
  d = str(tmp_path)
  model = _small_model(1)
  for step in (3, 7, 12):
    path = TSN.save_checkpoint(d, step, model, keep_last=2)
  assert os.path.basename(path) == 'ckpt-00000012.pt'
  assert sorted(os.listdir(d)) == ['ckpt-00000007.pt', 'ckpt-00000012.pt']
  assert TSN.latest_checkpoint(d) == path and TSN.checkpoint_step(path) == 12
  fresh = TSN.restore_params(path, _small_model(2))
  for (k, a), b in zip(model.state_dict().items(),
                       fresh.state_dict().values()):
    assert torch.equal(a, b), k
  # a plain state_dict of tensors: loadable without unpickling code
  assert isinstance(torch.load(path, weights_only=True), dict)


def test_train_state_resumes_the_unbroken_run(tmp_path):
  """Step 1, save, step 2 (unbroken) against restore + step 2: the same
  loss and the same weights and moments after it, bit for bit."""
  cfg = _cfg(window_size=3, img_height=16, img_width=16)
  init_fn, train_step, _, _ = TT.make_episode_train_fns(
      cfg, True, chunk_windows=4, render_fn=_stub_torch, aug_pad=3,
      device='cpu')
  batches = [_torch_batch(_state_batch(cfg, True, True, seed=s))
             for s in (0, 1)]
  ts, _ = train_step(init_fn(torch.Generator().manual_seed(0), 2),
                     batches[0])
  path = TSN.save_train_state(str(tmp_path), ts.step, ts)
  assert os.path.basename(path) == 'state-00000001.pt'
  assert TSN.latest_train_state(str(tmp_path)) == path
  ts_a, m_a = train_step(ts, batches[1])
  resumed = TSN.restore_train_state(
      path, init_fn(torch.Generator().manual_seed(5), 2))
  assert resumed.step == 1
  ts_b, m_b = train_step(resumed, batches[1])
  assert ts_b.step == ts_a.step == 2
  for k in m_a:
    assert torch.equal(m_a[k], m_b[k]), k
  for a, b in zip(ts_a.model.parameters(), ts_b.model.parameters()):
    assert torch.equal(a, b)
    sa, sb = ts_a.optimizer.state[a], ts_b.optimizer.state[b]
    assert float(sa['step']) == float(sb['step']) == 2.0
    assert sb['step'].device.type == 'cpu'
    assert torch.equal(sa['exp_avg'], sb['exp_avg'])
    assert torch.equal(sa['exp_avg_sq'], sb['exp_avg_sq'])


def test_best_k_snapshots_match_jax(tmp_path):
  """The same checkpoints and eval losses through both engines' export:
  the same index (steps, losses, order), the same snapshots kept, the same
  best one."""
  losses = {1: 0.5, 2: 0.3, 3: 0.7, 4: 0.2, 5: 0.45, 6: 0.31}
  model = _small_model()
  dirs = {'port': str(tmp_path / 'port'), 'jax': str(tmp_path / 'jax')}
  for d in dirs.values():
    os.makedirs(d)
    with open(os.path.join(d, 'e2evmc_config.json'), 'w') as fp:
      fp.write('{}')
  for step, loss in losses.items():
    TSN.save_checkpoint(dirs['port'], step, model)
    TSN.export_snapshot(dirs['port'], loss, num_best=3)
    JSN.save_checkpoint(dirs['jax'], step, {'w': np.zeros(3, np.float32)})
    JSN.export_snapshot(dirs['jax'], loss, num_best=3)
  got = TSN.load_snapshot_index(dirs['port'])
  ref = JSN.load_snapshot_index(dirs['jax'])
  strip = lambda idx, d: [(e['step'], e['loss'], os.path.relpath(e['dir'], d))
                          for e in idx]
  assert strip(got, dirs['port']) == strip(ref, dirs['jax'])
  assert [e['step'] for e in got] == [4, 2, 6]
  kept = {e: sorted(os.listdir(os.path.join(d, 'snapshots')))
          for e, d in dirs.items()}
  assert kept['port'] == kept['jax']
  snap = os.path.join(dirs['port'], 'snapshots', 'snapshot-00000004')
  assert sorted(os.listdir(snap)) == ['ckpt-00000004.pt', 'e2evmc_config.json']
  assert TSN.best_snapshot(dirs['port']) == os.path.join(
      snap, 'ckpt-00000004.pt')
  assert os.path.basename(JSN.best_snapshot(dirs['jax'])).startswith(
      'ckpt-00000004')


# ---------------------------------------------------------------- 2. serving


def _jax_params(cfg, goal, seed=0):
  """Perturbed flax parameters (zero-initialised heads would predict 0)."""
  jm = JM.make_model(cfg, goal)
  K = cfg.window_size
  frames = np.zeros((1, K, S, S, 3), np.float32)
  jnt = np.zeros((1, K, 7), np.float32)
  args = (frames, jnt, frames[:, 0]) if goal else (frames, jnt)
  params = jax.jit(lambda k: jm.init(k, *args, None, jnp.asarray(True)))(
      jax.random.PRNGKey(seed))['params']
  rng = np.random.RandomState(seed + 1)
  return jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.randn(
      *x.shape)).astype(np.float32), params)


def _port_predictor(cls, cfg, params, model_dir, **kw):
  """The port's predictor served from its own checkpoint of the weights."""
  model = TM.make_model(cfg, cls.goal_conditioned, device='cpu')
  model.load_state_dict(e2evmc_params_from_reference(params))
  os.makedirs(model_dir, exist_ok=True)
  save_model_config(cfg, os.path.join(model_dir, 'e2evmc_config.json'))
  TSN.save_checkpoint(model_dir, 10, model)
  return cls(model_dir, device='cpu', **kw)


@pytest.mark.parametrize('mode', ['window_dynimg', 'persistent_sequence'])
def test_predictor_matches_jax(tmp_path, mode):
  if mode == 'window_dynimg':
    cfg = _cfg(proc_obs='dynimg', proc_tgt='dyndiff')
    goal, carry_mode, first = True, None, cfg.window_size - 1
    tcls, jcls = TPR.GoalE2EVMCPredictor, JPR.GoalE2EVMCPredictor
  else:
    cfg = _cfg(proc_obs='sequence', proc_tgt='constant')
    goal, carry_mode, first = False, 'persistent', 0
    tcls, jcls = TPR.E2EVMCPredictor, JPR.E2EVMCPredictor
  params = _jax_params(cfg, goal)
  tp = _port_predictor(tcls, cfg, params, str(tmp_path / 'm'),
                       carry_mode=carry_mode)
  jp = jcls('', config=cfg, params=params, carry_mode=carry_mode)
  assert tp.carry_mode == jp.carry_mode == (
      'window' if carry_mode is None else 'persistent')
  rng = np.random.RandomState(4)
  for episode in range(2):
    tp.reset()
    jp.reset()
    if goal:
      tgt = rng.rand(S, S, 3).astype(np.float32)
      tp.set_goal(tgt)
      jp.set_goal(tgt)
    for t in range(STEPS):
      frame = rng.rand(S, S, 3).astype(np.float32)
      jnt = rng.randn(7).astype(np.float32)
      got, ref = tp.predict(frame, jnt), jp.predict(frame, jnt)
      assert set(got) == set(ref)
      if t < first:
        continue
      for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), **F32_TOL,
                                   err_msg=f'{mode} episode {episode} t={t} '
                                   f'{k}')
  assert set(got) >= {'cmd_ee', 'cmd_grp', 'pos_ee', 'pos_obj'}


def test_predictor_validates_inputs(tmp_path):
  cfg = _cfg()
  params = _jax_params(cfg, True)
  tp = _port_predictor(TPR.GoalE2EVMCPredictor, cfg, params,
                       str(tmp_path / 'm'))
  with pytest.raises(ValueError, match='shape'):
    tp.predict(np.zeros((S, S + 1, 3), np.float32), np.zeros(7))
  with pytest.raises(ValueError, match='normalized'):
    tp.predict(np.full((S, S, 3), 2.0, np.float32), np.zeros(7))
  with pytest.raises(ValueError, match='shape'):
    tp.set_goal(np.zeros((4, 4, 3), np.float32))
  with pytest.raises(FileNotFoundError):
    TPR.GoalE2EVMCPredictor(str(tmp_path / 'empty'), config=cfg,
                            device='cpu')
