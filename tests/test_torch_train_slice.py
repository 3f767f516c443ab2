"""Port parity (the trainer's whole slice): the episode eval step with
``render_fn = env.render_from_qpos`` in both engines, GeecoEnv('pad2-cube2')
at 64x64 on the CPU (the JAX env on its Pallas raster path,
``backend='pallas'``, in interpret mode), and the port's render_from_qpos
against its own env.render.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.envs.base import make_env as jmake_env
from geeco_tpu.models import train as JT
from geeco_tpu.models.params import create_e2evmc_config
from geeco_tpu_torch.core.convert import e2evmc_params_from_reference
from geeco_tpu_torch.envs.base import make_env as tmake_env
from geeco_tpu_torch.models import train as TT
from tests.test_torch_train import B, _jax_params, _perturbed, _state_batch
from tests.test_torch_train import _torch_batch

torch.set_num_threads(1)

# frames: projections differ by float32 rounding, so a pixel on a triangle
# edge may flip (test_torch_render.py's tolerance); the metrics see those
# pixels through the encoders
FRAME_MISMATCH_TOL = 1e-3
SLICE_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
# each loss term of the port moves by more than this share when only the
# rendered states change: the frames reach the metrics, so the parity above
# is one of the frames too
FRAME_SENSITIVITY = 5 * SLICE_LOSS_TOL['rtol']

SLICE_ENV = dict(frame_res=(64, 64), n_substeps=2, settle_steps=1,
                 solver_iterations=8)
SLICE_T = 3


def _port_env():
  te = tmake_env('pad2-cube2', device='cpu', **SLICE_ENV)
  te.setup()
  return te


@pytest.fixture(scope='module')
def slice_envs():
  # the port sets up in a worker thread while XLA compiles the JAX side
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    port = pool.submit(_port_env)
    je = jmake_env('pad2-cube2', renderer_kwargs={'backend': 'pallas'},
                   **SLICE_ENV)
    phys = je.setup()
    te = port.result(timeout=600)
  return je, te, phys


def test_render_from_qpos_is_render(slice_envs):
  """The port's render_from_qpos of a state equals env.render of it, bit for
  bit."""
  te = slice_envs[1]
  es = te.reset_random(2, torch.Generator().manual_seed(0))
  mocap = torch.cat([es.phys.mocap_pos[:, 0], es.phys.mocap_quat[:, 0]], -1)
  rgb, depth = te.render_from_qpos(es.phys.qpos, mocap, es.rgba)
  rgb_r, depth_r = te.render(es)
  assert rgb.shape == (2, 64, 64, 3) and rgb.dtype == torch.uint8
  assert torch.equal(rgb, rgb_r) and torch.equal(depth, depth_r)
  with pytest.raises(NotImplementedError):
    te.render_from_qpos(es.phys.qpos, mocap, es.rgba, textures=rgb)


def test_episode_slice_through_render_from_qpos(slice_envs):
  """The episode eval step with render_fn = env.render_from_qpos in both
  engines (pad2-cube2, B=2 episodes of 3 steps, 64x64): the frames to the
  render tests' tolerance, the metrics to a looser one."""
  je, te, phys = slice_envs
  # encoders 20 wide: their last GroupNorm (1x1 at 64 px) is one group of
  # 20; at 8 wide, 8 groups of one value each would normalise every feature
  # to its bias and hide the frames
  cfg = create_e2evmc_config(dict(
      img_height=64, img_width=64, window_size=2, proc_obs='dynimg',
      proc_tgt='dyndiff', dim_s_obs=20, dim_s_dyn=20, dim_s_diff=20,
      dim_h_lstm=8, dim_h_fc=8, compute_dtype='float32',
      loss_weighting='cmd_mag', start_boost=6.0, start_boost_windows=2))
  rng = np.random.RandomState(0)
  q0 = np.asarray(phys.qpos)
  qpos = (q0[None, None] + 0.01 * rng.randn(B, SLICE_T, q0.shape[0])
          ).astype(np.float32)
  mocap = np.concatenate([np.asarray(phys.mocap_pos)[0],
                          np.asarray(phys.mocap_quat)[0]]).astype(np.float32)
  b = _state_batch(cfg, True, False, T_=SLICE_T, nq=q0.shape[0],
                   ngeom=te.model.ngeom)
  b.update(qpos=qpos, mocap=np.broadcast_to(mocap, (B, SLICE_T, 7)).copy(),
           rgba=np.broadcast_to(np.asarray(te.rgba0, np.float32),
                                (B,) + te.rgba0.shape).copy(),
           tgt_qpos=(q0 + 0.01 * rng.randn(B, q0.shape[0])).astype(
               np.float32), tgt_mocap=np.broadcast_to(mocap, (B, 7)))
  b['valid'][:] = True

  flat = [x.reshape((B * SLICE_T,) + x.shape[2:]) for x in (qpos, b['mocap'])]
  rgba = np.repeat(b['rgba'], SLICE_T, axis=0)
  jrgb, _ = jax.jit(jax.vmap(je.render_from_qpos))(flat[0], flat[1], rgba)
  trgb, _ = te.render_from_qpos(*(torch.as_tensor(x) for x in flat),
                                torch.as_tensor(rgba))
  mism = (trgb.numpy() != np.asarray(jrgb)).any(-1)
  assert mism.mean() <= FRAME_MISMATCH_TOL, f'{mism.sum()} pixels differ'
  assert trgb.reshape(-1, 3).float().std(0).mean() > 10     # not flat

  opts = dict(chunk_windows=2, render_chunk=4)
  jfns = JT.make_episode_train_fns(cfg, True, render_fn=je.render_from_qpos,
                                   **opts)
  params = _perturbed(_jax_params(jfns[0]))
  jm = jax.jit(jfns[2])(JT.TrainState(params=params, opt_state=(),
                                      lstm_carry=(), step=0),
                        jax.tree.map(jnp.asarray, b))
  _, _, eval_step, _ = TT.make_episode_train_fns(
      cfg, True, render_fn=te.render_from_qpos, device='cpu', **opts)
  ts = TT.make_episode_train_fns(cfg, True, device='cpu')[0]()
  ts.model.load_state_dict(e2evmc_params_from_reference(params))
  tm = eval_step(ts, _torch_batch(b))
  assert set(tm) == set(jm)
  for k, v in jm.items():
    np.testing.assert_allclose(float(tm[k]), float(v), err_msg=k,
                               **SLICE_LOSS_TOL)

  # the same batch with the rendered states moved: only the frames change
  moved = dict(b, qpos=(qpos + 0.05 * rng.randn(*qpos.shape)).astype(
      np.float32))
  tm_moved = eval_step(ts, _torch_batch(moved))
  for k in (k for k in tm if k.startswith('loss_')):
    a, b_ = float(tm[k]), float(tm_moved[k])
    assert abs(b_ - a) > FRAME_SENSITIVITY * abs(a), \
        f'{k} does not see the frames: {a} -> {b_}'
