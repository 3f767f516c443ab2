"""Port parity (closed loop): geeco_tpu_torch.models.closed_loop on the CPU.

The policy half of a control step (ring buffer, carry, forward, action) is
held against the JAX package's own ``policy_step``, vmapped over the envs,
for a sequence of frames in both carry modes; a tiny ``evaluate_batched``
drives render, policy and physics together (as tests/test_closed_loop.py,
at 64 px: the port's renderer takes multiples of its 64-px coarse region).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.models import closed_loop as JC
from geeco_tpu.models import e2evmc as JE
from geeco_tpu.models.params import create_e2evmc_config
from geeco_tpu_torch.core.convert import e2evmc_params_from_reference
from geeco_tpu_torch.envs.base import make_env
from geeco_tpu_torch.models import closed_loop as TC
from geeco_tpu_torch.models import e2evmc as TE
from geeco_tpu_torch.parallel import mesh as PM

torch.set_num_threads(1)

S = 32
B = 3
STEPS = 4
# float32 forward in both engines (tests/test_torch_models.py)
TOL = dict(rtol=1e-4, atol=1e-5)


def _config(**kw):
  d = {'img_height': S, 'img_width': S, 'proc_obs': 'dynimg',
       'proc_tgt': 'dyndiff', 'dim_s_obs': 20, 'dim_s_dyn': 20,
       'dim_s_diff': 20, 'dim_h_lstm': 8, 'dim_h_fc': 8, 'window_size': 3,
       'compute_dtype': 'float32'}
  d.update(kw)
  return create_e2evmc_config(d)


def _closure(fn, name):
  return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.mark.parametrize('carry_mode,proc_obs', [
    ('window', 'dynimg'), ('window', 'sequence'), ('persistent', 'sequence')])
def test_policy_step_matches_jax(carry_mode, proc_obs):
  """For proc_obs='dynimg' the actions are compared from the first full
  window on: a window padded with copies of the first frame is static, and
  the dynamic image of a static window is float32 rounding noise divided by
  1e-6 (see tests/test_torch_train.py), different in every engine.  Its
  persistent carry would carry that noise on, so the persistent mode runs
  the sequence variant."""
  cfg = _config(proc_obs=proc_obs)
  rng = np.random.RandomState(0)
  frames = rng.rand(STEPS, B, S, S, 3).astype(np.float32)
  jnts = rng.randn(STEPS, B, 7).astype(np.float32)
  tgt = rng.rand(B, S, S, 3).astype(np.float32)
  jm = JE.make_model(cfg, True)
  params = jax.jit(lambda k: jm.init(
      k, frames[0][:, None].repeat(3, 1), jnts[0][:, None].repeat(3, 1), tgt,
      None, jnp.asarray(True)))(jax.random.PRNGKey(0))['params']
  params = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.randn(
      *x.shape)).astype(np.float32), params)

  # the JAX policy half, per env, vmapped over the batch (the env is not
  # used by it)
  jpolicy = jax.jit(jax.vmap(_closure(JC.make_closed_loop(
      None, cfg, True, carry_mode), 'policy_step'),
      in_axes=(None, 0, 0, 0, 0)))
  jps = jax.tree.map(lambda x: jnp.stack([x] * B),
                     JC.init_policy_state(cfg))
  tm = TE.make_model(cfg, True, device='cpu')
  tm.load_state_dict(e2evmc_params_from_reference(params))
  tpolicy = TC.make_closed_loop(None, cfg, True, carry_mode).policy_step
  tps = TC.init_policy_state(cfg, B)
  tt = torch.as_tensor(tgt)
  for t in range(STEPS):
    ja, jps = jpolicy(params, jps, frames[t], jnts[t], tgt)
    ta, tps = tpolicy(tm, tps, torch.as_tensor(frames[t]),
                      torch.as_tensor(jnts[t]), tt)
    ja = np.asarray(ja)
    np.testing.assert_array_equal(tps.frames.numpy(), np.asarray(jps.frames))
    np.testing.assert_array_equal(tps.jnt.numpy(), np.asarray(jps.jnt))
    assert bool(tps.started.all())
    if proc_obs == 'dynimg' and t < cfg.window_size - 1:
      continue
    np.testing.assert_allclose(ta[:, :3].numpy(), ja[:, :3], err_msg=str(t),
                               **TOL)
    np.testing.assert_array_equal(ta[:, 3].numpy(), ja[:, 3])
    for got, ref in zip(tps.carry, jps.carry):
      np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, 0], **TOL)
  assert np.abs(ja[:, :3]).max() > 1e-3       # perturbed heads act


@pytest.fixture(scope='module')
def env():
  e = make_env('pad1-cube1', frame_res=(64, 64), settle_steps=1,
               n_substeps=4, solver_iterations=8, device='cpu')
  e.setup()
  return e


def test_closed_loop_batched_eval(env, monkeypatch):
  """Reset, two closed-loop control steps of two envs, eval-video frames:
  finite metrics, bounded goal distances."""
  cfg = _config(img_height=64, img_width=64, window_size=2)
  model = TE.make_model(cfg, True, device='cpu')
  agg, frames = TC.evaluate_batched(
      env, cfg, model, True, 2, torch.Generator().manual_seed(1), n_steps=2,
      collect_frames=1)
  assert frames.shape == (2, 1, 64, 64, 3) and frames.dtype == np.uint8
  assert agg['task_success'].shape == (2,)
  for k, v in agg.items():
    assert bool(torch.isfinite(v).all()), k
  assert float(agg['min_goal_dist'].min()) >= 0.0
  assert float(agg['max_goal_dist'].max()) < 2.0
  # per-step background frames: step t renders with frame t on the wall
  R = env.renderer.scene.tex_res
  tex = torch.rand((2, R, R, 3), generator=torch.Generator().manual_seed(2))
  seen = []
  render = env.render

  def spy(es, textures=None):
    seen.append(textures)
    return render(es, textures=textures)

  monkeypatch.setattr(env, 'render', spy)
  agg_t, frames_t = TC.evaluate_batched(
      env, cfg, model, True, 2, torch.Generator().manual_seed(1), n_steps=2,
      collect_frames=1, step_textures=tex)
  monkeypatch.undo()
  assert frames_t.shape == frames.shape
  assert [torch.equal(s, env.background_textures(t))
          for s, t in zip(seen, tex)] == [True, True]
  assert bool(torch.isfinite(agg_t['min_goal_dist']).all())
  # a one-rank mesh runs the whole batch: the same metrics and frames
  # (two ranks: tests/test_torch_parallel.py)
  agg_m, frames_m = TC.evaluate_batched(
      env, cfg, model, True, 2, torch.Generator().manual_seed(1), n_steps=2,
      collect_frames=1, mesh=PM.Mesh(1, 0, torch.device('cpu')))
  assert np.array_equal(frames_m, frames)
  for k, v in agg.items():
    assert torch.equal(agg_m[k], v), k


def test_synth_target_frames_moves_the_task_object(env, monkeypatch):
  """The goal frame renders the task object on its task goal site (xy; its
  height and orientation kept), the other objects where they are, in one
  render of the batch, and leaves the state as it was."""
  cfg = _config(img_height=64, img_width=64)
  es = env.reset_random(2, torch.Generator().manual_seed(2))
  qpos = es.phys.qpos.clone()
  seen = []
  render = env.renderer.render
  monkeypatch.setattr(env.renderer, 'render',
                      lambda kin, rgba: seen.append(kin) or render(kin, rgba))
  tgt = TC.synth_target_frames(env, cfg, es)
  assert tgt.shape == (2, 64, 64, 3) and tgt.dtype == torch.float32
  assert 0.0 <= float(tgt.min()) and float(tgt.max()) <= 1.0
  assert torch.equal(es.phys.qpos, qpos) and len(seen) == 1
  kin, kin0 = seen[0], env.kin(es)
  obj = env.task_object_pos(es, kin)
  torch.testing.assert_close(obj[:, :2], env.task_goal_pos(es, kin0)[:, :2],
                             rtol=0, atol=1e-5)
  torch.testing.assert_close(obj[:, 2], env.task_object_pos(es, kin0)[:, 2],
                             rtol=0, atol=1e-6)
