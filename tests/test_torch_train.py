"""Port parity (trainer): geeco_tpu_torch.models.train against the JAX
package's make_train_fns / make_episode_train_fns on the CPU, from the same
perturbed parameters and the same batch.

Each case compares every metric, every gradient after the optax-style
global-norm clip, and the parameters after one Adam step.  Adam's first step
moves a parameter by about lr * sign(g), so where |g| is near zero the two
engines may step opposite ways: parameters are compared to 2 * lr, the
gradients tightly.  The whole slice, re-rendering through
``GeecoEnv.render_from_qpos``, is in test_torch_train_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geeco_tpu.data.dataset import window_indices as jwindow_indices
from geeco_tpu.models import train as JT
from geeco_tpu.models.params import create_e2evmc_config
from geeco_tpu_torch.core.convert import e2evmc_params_from_reference
from geeco_tpu_torch.data.dataset import window_indices
from geeco_tpu_torch.models import train as TT

torch.set_num_threads(1)

H = W = 16
T = 10     # episode length
K = 3      # window size
B = 2      # episodes per batch
NQ = 9
# metrics and gradients: the same float32 graph, sums in another order
METRIC_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_RTOL = 1e-4        # of the largest |g| of each tensor, elementwise
# The dynamic image of a window whose frames are all equal (a padded start
# window; a target frame equal to the current one) is float32 rounding noise
# scaled by 1/1e-6: its value depends on the order of the sums (XLA's fused
# jit and JAX's eager ops already disagree there by ~1e-2).  The batches
# here have no such window: no padded starts, targets apart from the frames.


def _config(**kw):
  # encoder widths 20: the last conv's GroupNorm is then one group of 20
  # at 1x1 (at 16 px); with 8 groups of 2 channels each group's variance is
  # that of two numbers, and flax's E[x^2] - E[x]^2 amplifies rounding there
  # to ~1e-3 on the features, in either engine
  base = dict(img_height=H, img_width=W, img_channels=3, window_size=K,
              proc_obs='dynimg', proc_tgt='dyndiff', dim_s_obs=20,
              dim_s_dyn=20, dim_s_diff=20, dim_h_lstm=16, dim_h_fc=16,
              lr=3e-3, compute_dtype='float32')
  base.update(kw)
  return create_e2evmc_config(base)


def _jax_params(init_fn, seed=3):
  """A JAX trainer's initial params (init traced once: eager flax init runs
  op by op and takes the CPU ~15 s)."""
  return jax.jit(lambda k: init_fn(k, B).params)(jax.random.PRNGKey(seed))


def _perturbed(params, seed=0, scale=0.05):
  """Every leaf plus seeded noise: zero-initialised heads would make every
  prediction 0 and hide the whole network behind them."""
  rng = np.random.RandomState(seed)
  return jax.tree.map(
      lambda x: (np.asarray(x) + scale * rng.randn(*x.shape)).astype(
          np.float32), params)


# A deterministic pseudo-renderer written the same way in both engines: the
# pixels are integer functions of three exactly representable state values,
# so both engines make the same uint8 frames.
def _stub_jax(q, mc, rgba):
  v = (jnp.floor(q[0] * 64) + 3 * jnp.floor(mc[0] * 64) +
       5 * jnp.floor(rgba[0, 0] * 64)).astype(jnp.int32)
  x = (jnp.arange(H * W * 3, dtype=jnp.int32) * 37 + v) % 256
  return x.reshape(H, W, 3).astype(jnp.uint8), jnp.zeros((H, W))


def _stub_torch(q, mc, rgba):
  v = (torch.floor(q[:, 0] * 64) + 3 * torch.floor(mc[:, 0] * 64) +
       5 * torch.floor(rgba[:, 0, 0] * 64)).int()
  x = (torch.arange(H * W * 3, dtype=torch.int32) * 37 + v[:, None]) % 256
  return (x.reshape(-1, H, W, 3).to(torch.uint8),
          torch.zeros((q.shape[0], H, W)))


def _state_batch(cfg, goal, aug_shift, seed=0, T_=T, nq=NQ, ngeom=4):
  """A state-only episode batch (data/dataset.py layout), numpy."""
  rng = np.random.RandomState(seed)
  widx = jwindow_indices(T_, cfg.window_size, pad_start=False).astype(
      np.int32)
  N = widx.shape[0]
  J = cfg.dim_jnt_state
  cmd = rng.uniform(-1, 1, (B, N, 4)).astype(np.float32)
  cmd[..., 3] = rng.choice([-1.0, 0.0, 1.0], size=(B, N))
  b = {
      'widx': widx, 'valid': np.ones((N,), bool),
      'jnt_state': rng.randn(B, T_, J).astype(np.float32),
      'cmd': cmd,
      'vel_target': rng.randn(B, N, J).astype(np.float32),
      'ee_target': rng.randn(B, N, 7).astype(np.float32),
      'grp_target': rng.rand(B, N, 2).astype(np.float32),
      'pos_ee': rng.randn(B, N, 3).astype(np.float32),
      'pos_obj': rng.randn(B, N, 3).astype(np.float32),
      'qpos': rng.randn(B, T_, nq).astype(np.float32),
      'mocap': rng.randn(B, T_, 7).astype(np.float32),
      'rgba': rng.rand(B, ngeom, 4).astype(np.float32),
  }
  b['valid'][-1] = False      # a masked row besides the chunk padding
  if goal:
    b['tgt_qpos'] = rng.randn(B, nq).astype(np.float32)
    b['tgt_mocap'] = rng.randn(B, 7).astype(np.float32)
  if aug_shift:
    b['aug_shift'] = np.asarray([[1, -2], [-3, 2]], np.int32)  # -3 clamps
  return b


def _torch_batch(b):
  return {k: torch.as_tensor(np.array(v)).long() if k in ('widx', 'aug_shift')
          else torch.as_tensor(np.array(v)) for k, v in b.items()}


def _jax_step(fns, params, batch):
  """JAX: every metric, the clipped gradients and the params after one
  step, from the eval loss (the train step's loss) and the train step's
  optimizer."""
  _, _, eval_step, tx = fns

  def f(p):   # the eval step reads only the params of its state
    m = eval_step(JT.TrainState(params=p, opt_state=(), lstm_carry=(),
                                step=0), batch)
    return m['loss'], m

  (_, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
  norm = optax.global_norm(grads)
  clipped = jax.tree.map(lambda g: jnp.where(norm < 1.0, g, g / norm), grads)
  updates, _ = tx.update(grads, tx.init(params), params)
  new = optax.apply_updates(params, updates)
  return ({k: float(v) for k, v in metrics.items()}, clipped, new)


def _compare(cfg, ts, metrics, jmetrics, jgrads, jnew, label=''):
  assert set(metrics) == set(jmetrics), (set(metrics), set(jmetrics))
  for k, v in jmetrics.items():
    np.testing.assert_allclose(float(metrics[k]), v, err_msg=label + k,
                               **METRIC_TOL)
  grads = e2evmc_params_from_reference(jgrads)
  named = dict(ts.model.named_parameters())
  assert set(grads) == set(named)
  for k, g in grads.items():
    got = named[k].grad.numpy()
    scale = float(np.abs(g.numpy()).max())
    np.testing.assert_allclose(got, g.numpy(), rtol=0,
                               atol=GRAD_RTOL * scale + 1e-9,
                               err_msg=label + k)
  for k, p in e2evmc_params_from_reference(jnew).items():
    np.testing.assert_allclose(named[k].detach().numpy(), p.numpy(), rtol=0,
                               atol=2 * cfg.lr + 1e-6, err_msg=label + k)


@pytest.mark.parametrize('kw,goal,aug', [
    (dict(), True, False),
    (dict(train_carry='bptt', loss_weighting='cmd_mag', start_boost=6.0,
          start_boost_windows=4), True, True),
    (dict(loss_weighting='cmd_mag', start_boost=6.0, start_boost_windows=4,
          control_mode='velocity'), True, False),
    (dict(train_carry='bptt', control_mode='velocity', proc_obs='sequence',
          proc_tgt='constant'), False, True),
    (dict(start_boost=6.0, start_boost_windows=4, proc_obs='sequence',
          proc_tgt='constant'), False, False),
], ids=['stateless', 'bptt-cmd_mag-boost-shift', 'velocity-cmd_mag-boost',
        'uncond-bptt-velocity-shift', 'uncond-boost'])
def test_episode_step_matches_jax(kw, goal, aug):
  """One eval + train step of the episode trainer on a state-only batch
  re-rendered by the stub, chunk padding and a clamped render pad
  included (N=8 windows in chunks of 3; 20 frames in renders of 8)."""
  cfg = _config(**kw)
  b = _state_batch(cfg, goal, aug)
  opts = dict(chunk_windows=3, render_chunk=8, aug_pad=2 if aug else 0)
  jfns = JT.make_episode_train_fns(cfg, goal, render_fn=_stub_jax, **opts)
  params = _perturbed(_jax_params(jfns[0]))
  jm, jgrads, jnew = _jax_step(jfns, params, jax.tree.map(jnp.asarray, b))

  init_fn, train_step, eval_step, _ = TT.make_episode_train_fns(
      cfg, goal, render_fn=_stub_torch, device='cpu', **opts)
  ts = init_fn()
  ts.model.load_state_dict(e2evmc_params_from_reference(params))
  tb = _torch_batch(b)
  em = eval_step(ts, tb)
  ts, m = train_step(ts, tb)
  assert ts.step == 1
  for k in em:
    assert float(em[k]) == pytest.approx(float(m[k]), rel=1e-6, abs=1e-7), k
  _compare(cfg, ts, m, jm, jgrads, jnew)


def test_per_window_step_matches_jax():
  """make_train_fns: one train step on a goal-conditioned dynimg window
  batch at 64x64 with a carried-in LSTM state (reset False), then eval."""
  cfg = create_e2evmc_config(dict(
      img_height=64, img_width=64, window_size=4, dim_s_obs=32, dim_s_dyn=32,
      dim_s_diff=32, dim_h_lstm=16, dim_h_fc=16, proc_obs='dynimg',
      proc_tgt='dyndiff', compute_dtype='float32', lr=1e-3))
  rng = np.random.RandomState(1)
  n = 2
  feature = {
      'step': np.ones((n, 4), np.int32),
      'rgb': rng.rand(n, 4, 64, 64, 3).astype(np.float32),
      'depth': np.zeros((n, 4, 64, 64, 1), np.float32),
      'jnt_state': rng.randn(n, 4, 7).astype(np.float32),
      'ee_state': rng.randn(n, 4, 7).astype(np.float32),
      'obj_state': rng.randn(n, 4, 7).astype(np.float32),
      'target_rgb': rng.rand(n, 64, 64, 3).astype(np.float32),
      'target_depth': np.zeros((n, 64, 64, 1), np.float32),
  }
  label = {'cmd': np.asarray([[0.1, -0.2, 0.3, 1.0], [0.0, 0.1, -0.1, -0.4]],
                             np.float32),
           'vel_target': rng.randn(n, 7).astype(np.float32),
           'ee_target': rng.randn(n, 7).astype(np.float32),
           'grp_target': rng.randn(n, 2).astype(np.float32)}
  carry = tuple(rng.randn(n, 16).astype(np.float32) for _ in range(2))

  jinit, jtrain, jeval, _ = JT.make_train_fns(cfg, True)
  params = _perturbed(_jax_params(jinit), seed=2)
  jts = JT.TrainState(
      params=params, lstm_carry=carry, step=jnp.zeros((), jnp.int32),
      opt_state=optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adam(cfg.lr)).init(params))
  jf = jax.tree.map(jnp.asarray, feature)
  jl = jax.tree.map(jnp.asarray, label)

  def f(p):
    m = jeval(jts.replace(params=p), jf, jl)
    return m['loss'], m
  (_, jm), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
  norm = optax.global_norm(grads)
  jgrads = jax.tree.map(lambda g: jnp.where(norm < 1.0, g, g / norm), grads)
  jts2, jtm = jax.jit(jtrain)(jts, jf, jl)

  init_fn, train_step, eval_step, _ = TT.make_train_fns(cfg, True,
                                                        device='cpu')
  ts = init_fn(batch_size=n)
  ts.model.load_state_dict(e2evmc_params_from_reference(params))
  ts = ts.replace(lstm_carry=tuple(torch.as_tensor(c) for c in carry))
  tf = {k: torch.as_tensor(v) for k, v in feature.items()}
  tl = {k: torch.as_tensor(v) for k, v in label.items()}
  em = eval_step(ts, tf, tl)
  for k, v in jm.items():
    np.testing.assert_allclose(float(em[k]), float(v), err_msg=k,
                               **METRIC_TOL)
  ts, m = train_step(ts, tf, tl)
  _compare(cfg, ts, m, {k: float(v) for k, v in jtm.items()}, jgrads,
           jts2.params)
  for got, ref in zip(ts.lstm_carry, jts2.lstm_carry):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_render_chunks_and_aug_pad_guard():
  """ceil(B*T / render_chunk) chunk renders + one for the targets; an
  aug_shift batch needs aug_pad > 0."""
  cfg = _config()
  calls = []

  def counting(q, mc, rgba):
    calls.append(q.shape[0])
    return _stub_torch(q, mc, rgba)

  b = _torch_batch(_state_batch(cfg, True, True))
  _, _, eval_step, _ = TT.make_episode_train_fns(
      cfg, True, chunk_windows=4, render_fn=counting, render_chunk=6,
      aug_pad=3, device='cpu')
  ts = TT.make_episode_train_fns(cfg, True, device='cpu')[0]()
  eval_step(ts, b)
  assert calls == [6, 6, 6, 6, B]          # 20 frames -> 4 chunks, targets
  _, _, eval_nopad, _ = TT.make_episode_train_fns(
      cfg, True, render_fn=_stub_torch, device='cpu')
  with pytest.raises(ValueError, match='aug_pad=0'):
    eval_nopad(ts, b)


def _closure(fn, name):
  """The function ``name`` a closure ``fn`` refers to."""
  return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_shift_frames_matches_jax():
  """The port's gather against the JAX package's own _shift_frames (edge
  pad, then lax.dynamic_slice), shifts beyond the padding included: the
  slice counts a negative start from the end, then clamps it."""
  jshift = _closure(_closure(JT.make_episode_train_fns(
      _config(), True, render_fn=_stub_jax, aug_pad=2)[1],
      '_materialize_frames'), '_shift_frames')
  rng = np.random.RandomState(0)
  img = rng.randint(0, 255, (5, 2, 7, 9, 3)).astype(np.uint8)
  s = 2
  dy, dx = np.asarray([1, -3, 0, 2, -5]), np.asarray([-2, 2, 5, -1, 3])
  got = TT._shift_frames(torch.as_tensor(img), torch.as_tensor(dy),
                         torch.as_tensor(dx), s).numpy()
  for i in range(5):
    np.testing.assert_array_equal(got[i], np.asarray(jshift(
        jnp.asarray(img[i]), jnp.asarray(dy[i]), jnp.asarray(dx[i]), s)))


def test_window_indices_match_jax():
  for T_, K_ in ((10, 3), (99, 4), (4, 4)):
    for pad in (True, False):
      np.testing.assert_array_equal(window_indices(T_, K_, pad),
                                    jwindow_indices(T_, K_, pad))
