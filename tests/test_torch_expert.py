"""Port parity (the scripted experts): geeco_tpu_torch/expert/policies.py
against geeco_tpu/expert/policies.py, on the CPU.

1. The cases of tests/test_expert.py, through a batched fake env.
2. Both experts against the JAX experts (``jax.vmap(step_fn)``) on the same
   states: B=2 envs of the pick and push scenes after the port's
   ``reset_to`` of the recorded MuJoCo fixtures (the pick scene's 3 expert
   steps later; the port's reset_to and step are held against JAX in
   test_torch_env.py), each carried into a JAX EnvState and back through
   ``core.convert``, from several expert phases.
3. A 3-step ``rollout`` with DART action noise against the JAX rollout from
   the same start, on the fused-solve configuration (rolling=False,
   solver_method='pallas').
"""

import concurrent.futures
import os

from tests.conftest import REPO_ROOT
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core.model import State as JState
from geeco_tpu.core.model import make_state as jmake_state
from geeco_tpu.envs.base import EnvState as JEnvState
from geeco_tpu.envs.base import make_env as jmake_env
from geeco_tpu.expert import policies as JP
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.data import episode as TE
from geeco_tpu_torch.envs.base import ResetSpec
from geeco_tpu_torch.envs.base import make_env as tmake_env
from geeco_tpu_torch.expert import policies as P

# The tensors here are small: one intra-op thread is as fast, and it keeps
# the parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

FIXTURES = {
    'pad2-cube2': 'mujoco_pickplace_pad2cube2.npz',
    'push-pad2-cube2': 'mujoco_pushing_pushpad2cube2.npz',
}
# expert outputs from the same state: float32 vector math, same order
ACT_ATOL = 1e-5
# after 3 control steps (60 substeps of 60 PSD iterations) in float32, as
# test_torch_env.py
QPOS_ATOL = 1e-4


# ---------------------------------------------------------------- 1. fakes


class FakeEnv:
  """Batched stand-in for the env: fixed grip/object/pad per env."""
  task = 'pickplace'

  def __init__(self, grip, obj, pad, batch=2):
    as_b = lambda v: torch.as_tensor(np.asarray(v, np.float32)).expand(
        batch, 3)
    self.grip, self.obj, self.pad = as_b(grip), as_b(obj), as_b(pad)

  def kin(self, es):
    return None

  def grip_pos(self, kin):
    return self.grip

  def task_object_pos(self, es, kin):
    return self.obj

  def task_goal_pos(self, es, kin):
    return self.pad


class PushEnv(FakeEnv):
  task = 'pushing'


def _step(env, xs):
  return P.make_expert(env)(None, xs)


def _phase(xs):
  phases = set(xs.phase.tolist())
  assert len(phases) == 1, phases
  return phases.pop()


def _close(got, want, atol=1e-6):
  np.testing.assert_allclose(got.numpy(), np.broadcast_to(
      np.asarray(want, np.float32), got.shape), atol=atol)


def test_pickplace_pre_grasp_action():
  env = FakeEnv(grip=[1.0, 0.5, 0.9], obj=[1.2, 0.7, 0.3], pad=[1.4, 0.9, 0.3])
  action, xs = _step(env, P.init_expert_state(2))
  # action = (obj - grip + [0,0,0.05]) * 6, gripper OPEN
  expect = (np.array([0.2, 0.2, -0.6]) + [0, 0, 0.05]) * 6.0
  _close(action[:, :3], expect, atol=1e-5)
  assert (action[:, 3] == 1.0).all()
  assert _phase(xs) == 0


def test_pickplace_full_phase_progression():
  obj = np.array([1.2, 0.7, 0.3])
  pad = np.array([1.4, 0.9, 0.3])
  xs = P.init_expert_state(2)
  # 1) gripper reaches pre-grasp pose -> GRASP
  action, xs = _step(FakeEnv(grip=obj + [0, 0, 0.0501], obj=obj, pad=pad), xs)
  assert _phase(xs) == 1
  assert (action[:, 3] == -1.0).all()  # CLOSE
  # 2) gripper reaches object -> POST_GRASP, captures grip+0.05 target
  action, xs = _step(FakeEnv(grip=obj + [0, 0, 0.001], obj=obj, pad=pad), xs)
  assert _phase(xs) == 2
  _close(xs.aux, obj + [0, 0, 0.001 + 0.05])
  # 3) lifted to post-grasp pose -> MOVE, captures pad + 0.175
  aux = xs.aux[0].numpy()
  env = FakeEnv(grip=aux, obj=obj + [0, 0, 0.05], pad=pad)
  action, xs = _step(env, xs)
  assert _phase(xs) == 3
  _close(xs.target, pad + [0, 0, 0.175])
  # MOVE action = (target - obj) * 6, CLOSE
  action, xs2 = _step(env, xs)
  _close(action[:, :3], (xs.target[0].numpy() - (obj + [0, 0, 0.05])) * 6.0,
         atol=1e-4)
  # 4) object reaches goal -> DROP; DROP holds [0,0,0.025,OPEN] forever
  target = xs.target[0].numpy()
  env = FakeEnv(grip=target, obj=target, pad=pad)
  action, xs = _step(env, xs)
  assert _phase(xs) == 4
  _close(action, [0, 0, 0.025, 1.0])
  action, xs = _step(env, xs)
  assert _phase(xs) == 4


def test_pushing_phase_progression():
  obj = np.array([1.25, 0.7, 0.3])
  pad = np.array([1.4, 0.9, 0.3])
  xs = P.init_expert_state(2)
  # PRE_PUSH_X: move behind object in -x
  action, xs = _step(PushEnv(grip=[1.0, 0.7, 0.3], obj=obj, pad=pad), xs)
  assert _phase(xs) == 0
  _close(action[:, :3], (obj - np.array([1.0, 0.7, 0.3]) - [0.1, 0, 0]) * 6.0,
         atol=1e-5)
  assert (action[:, 3] == -1.0).all()  # pushing keeps the gripper CLOSED
  # reach pre-push pose -> PUSH_X with target [pad.x, obj.y, obj.z]
  action, xs = _step(PushEnv(grip=obj - [0.1, 0, 0], obj=obj, pad=pad), xs)
  assert _phase(xs) == 1
  _close(xs.target, [pad[0], obj[1], obj[2]])
  # object reaches x-target but y misaligned -> BACKOFF with sign
  obj2 = np.array([pad[0], obj[1], obj[2]])
  env = PushEnv(grip=obj2 - [0.05, 0, 0], obj=obj2, pad=pad)
  action, xs = _step(env, xs)
  assert _phase(xs) == 2
  assert (xs.aux[:, 0] == -1.0).all()  # goal.y > obj.y: approach from -y
  # 3 backoff steps with action [-0.6, 0, 0, CLOSE]
  _close(action, [-0.6, 0, 0, -1.0])
  for _ in range(2):
    action, xs = _step(env, xs)
  assert _phase(xs) == 3
  # PRE_PUSH_Y reached -> PUSH_Y with target [obj.x, pad.y, obj.z]
  action, xs = _step(PushEnv(grip=obj2 + [0, -0.1, 0], obj=obj2, pad=pad), xs)
  assert _phase(xs) == 4
  _close(xs.target, [obj2[0], pad[1], obj2[2]])
  # object aligned in y -> IDLE with no-op
  obj3 = np.array([pad[0], pad[1], obj[2]])
  action, xs = _step(PushEnv(grip=obj3 - [0, 0.1, 0], obj=obj3, pad=pad), xs)
  assert _phase(xs) == 5
  _close(action, [0, 0, 0, 0])


def test_pushing_skips_y_phase_when_aligned():
  obj = np.array([1.25, 0.9, 0.3])
  pad = np.array([1.4, 0.9005, 0.3])  # already aligned in y
  xs = P.init_expert_state(2)
  action, xs = _step(PushEnv(grip=obj - [0.1, 0, 0], obj=obj, pad=pad), xs)
  assert _phase(xs) == 1   # -> PUSH_X
  obj2 = np.array([pad[0], obj[1], obj[2]])
  action, xs = _step(PushEnv(grip=obj2 - [0.05, 0, 0], obj=obj2, pad=pad), xs)
  assert _phase(xs) == 5   # straight to IDLE


def test_envs_in_different_phases():
  """Per-env transitions: env 0 advances, env 1 does not."""
  obj = np.array([1.2, 0.7, 0.3])
  env = FakeEnv(grip=obj + [0, 0, 0.0501], obj=obj, pad=[1.4, 0.9, 0.3])
  env.grip = torch.stack([env.grip[0], env.grip[1] + 0.1])
  action, xs = _step(env, P.init_expert_state(2))
  assert xs.phase.tolist() == [1, 0]
  assert action[:, 3].tolist() == [-1.0, 1.0]


# ------------------------------------------------------- 2. and 3. engines


def _spec(fx, batch):
  obj = fx['init_obj_qpos'].copy()
  obj[:, 2] -= 0.025   # reset_to re-adds the table-height adjust
  tile = lambda a: torch.as_tensor(a)[None].expand((batch,) + a.shape)
  # env 1 takes the other cube to the other pad
  return ResetSpec(obj_qpos=tile(obj), mocap_qpos=tile(fx['init_mocap_qpos']),
                   task_goal=torch.arange(batch) % 2,
                   task_object=torch.arange(batch) % 2)


def _jax_env_state(es):
  """The port's batched EnvState as a batched JAX EnvState (numpy leaves)."""
  j = lambda t: jnp.asarray(t.numpy())
  p = es.phys
  phys = JState(qpos=j(p.qpos), qvel=j(p.qvel), ctrl=j(p.ctrl),
                mocap_pos=j(p.mocap_pos), mocap_quat=j(p.mocap_quat),
                time=j(p.time), efc_force=j(p.efc_force))
  B = p.qpos.shape[0]
  return JEnvState(phys=phys, ts=j(es.ts).astype(jnp.int32),
                   task_goal=j(es.task_goal).astype(jnp.int32),
                   task_object=j(es.task_object).astype(jnp.int32),
                   goal_pos=j(es.goal_pos), rgba=j(es.rgba),
                   rng=jax.random.split(jax.random.PRNGKey(0), B))


def _jax_expert_state(xs):
  return JP.ExpertState(phase=jnp.asarray(xs.phase.numpy(), jnp.int32),
                        target=jnp.asarray(xs.target.numpy()),
                        aux=jnp.asarray(xs.aux.numpy()),
                        count=jnp.asarray(xs.count.numpy(), jnp.int32))


NOISE = np.random.RandomState(0).normal(0, 0.1, (2, 3, 4)).astype(np.float32)
ENV_KW = dict(frame_res=(64, 64), settle_steps=1, rolling=False,
              solver_method='pallas')


def _record(env, es, action, xs, textures=None):
  return {'action': action, 'phase': xs.phase}


def _port_side(shapes):
  """The port's part for one scene, run in a worker thread while JAX
  starts up: the env, its B=2 reset_to state and the state the expert
  parity runs on (the pick scene's after the noisy 3-step rollout, the
  push scene's the reset state)."""
  fx = np.load(os.path.join(REPO_ROOT, 'tests', 'fixtures', FIXTURES[shapes]))
  te = tmake_env(shapes, device='cpu', **ENV_KW)
  es0 = te.reset_to(_spec(fx, 2))
  es, recs = es0, None
  if shapes == 'pad2-cube2':
    es, recs = P.rollout(te, es0, P.make_expert(te), length=100,
                         record_fn=_record,
                         action_noise=torch.as_tensor(NOISE))
  return te, es0, es, recs


def _jax_rollout(je):
  """The JAX rollout of the noisy 3-step episode over B=2 envs, compiled
  ahead from the states' shapes."""
  one = JEnvState(phys=je.stepper.init_state(jmake_state(je.model)),
                  ts=jnp.zeros((), jnp.int32),
                  task_goal=jnp.zeros((), jnp.int32),
                  task_object=jnp.zeros((), jnp.int32),
                  goal_pos=jnp.zeros(3), rgba=jnp.asarray(je.rgba0),
                  rng=jax.random.PRNGKey(0))
  shapes = jax.tree.map(
      lambda x: jax.ShapeDtypeStruct((2,) + x.shape, x.dtype), one)
  expert = JP.make_expert(je)
  fn = jax.jit(jax.vmap(lambda e, n: JP.rollout(
      je, e, expert, record_fn=_record, action_noise=n)))
  return fn.lower(shapes, jnp.asarray(NOISE)).compile()


@pytest.fixture(scope='module')
def scenes():
  """Per scene: (JAX env, port env, reset state, later state, records);
  and the compiled JAX rollout."""
  # one port thread: torch.func.jvp's forward-AD levels are process-wide,
  # so two threads running the port's bias forces at once break them
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    port = {shapes: pool.submit(_port_side, shapes) for shapes in FIXTURES}
    jenvs = {shapes: jmake_env(shapes, **ENV_KW) for shapes in FIXTURES}
    jrollout = _jax_rollout(jenvs['pad2-cube2'])
    port = {shapes: f.result(timeout=600) for shapes, f in port.items()}
  return ({shapes: (jenvs[shapes],) + port[shapes] for shapes in FIXTURES},
          jrollout)


def _expert_states(te, es):
  """ExpertStates from several phases on the same env states: the start,
  and each later phase with its captures set near the present pose."""
  kin = te.kin(es)
  grip = te.grip_pos(kin)
  obj = te.task_object_pos(es, kin)
  B = grip.shape[0]
  out = []
  for phase in range(6 if te.task == 'pushing' else 5):
    xs = P.init_expert_state(B)
    aux = grip + torch.tensor([0.0, 0.0, 0.002]) if te.task != 'pushing' \
        else torch.tensor([[-1.0, 0.9, 0.0], [1.0, 0.6, 0.0]])
    out.append(xs._replace(phase=torch.full((B,), phase), aux=aux,
                           target=obj + torch.tensor([0.004, 0.0, 0.0]),
                           count=torch.tensor([0, 2])))
  return out


@pytest.mark.parametrize('shapes', list(FIXTURES))
def test_expert_matches_jax(scenes, shapes):
  je, te, _, es, _ = scenes[0][shapes]
  jes = _jax_env_state(es)
  got_es = convert.env_state_from_reference(jes)
  jstep = jax.jit(jax.vmap(JP.make_expert(je)))
  step = P.make_expert(te)
  phases = set()
  for xs in _expert_states(te, es):
    ja, jxs = jstep(jes, _jax_expert_state(xs))
    got_xs = convert.expert_state_from_reference(_jax_expert_state(xs))
    a, txs = step(got_es, got_xs)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ACT_ATOL)
    np.testing.assert_array_equal(txs.phase.numpy(), np.asarray(jxs.phase))
    np.testing.assert_array_equal(txs.count.numpy(), np.asarray(jxs.count))
    np.testing.assert_allclose(txs.target.numpy(), np.asarray(jxs.target),
                               atol=ACT_ATOL)
    np.testing.assert_allclose(txs.aux.numpy(), np.asarray(jxs.aux),
                               atol=ACT_ATOL)
    phases |= set(txs.phase.tolist())
  assert len(phases) >= 4, phases


def test_rollout_with_noise_matches_jax(scenes):
  _, _, es0, tfin, tr = scenes[0]['pad2-cube2']
  jfin, jr = scenes[1](_jax_env_state(es0), jnp.asarray(NOISE))
  # the noise's time axis set the length (3, not the 100 asked for)
  assert tr['action'].shape == (2, 3, 4) and tr['phase'].shape == (2, 3)
  # step 0 acts on the shared start state
  np.testing.assert_allclose(tr['action'][:, 0].numpy(),
                             np.asarray(jr['action'])[:, 0], atol=ACT_ATOL)
  np.testing.assert_allclose(tr['action'].numpy(), np.asarray(jr['action']),
                             atol=10 * QPOS_ATOL)
  np.testing.assert_array_equal(tr['phase'].numpy(), np.asarray(jr['phase']))
  # the executed action carried the noise in both engines: 3 steps of
  # 0.1-sigma noise move the arm by millimetres, far above QPOS_ATOL
  np.testing.assert_allclose(tfin.phys.qpos.numpy(),
                             np.asarray(jfin.phys.qpos), atol=QPOS_ATOL)
  assert tfin.ts.tolist() == (es0.ts + 3).tolist()


def test_rollout_rejects_step_textures(scenes):
  """Per-step background frames reach the record function, step by step;
  a texel grid of the wrong size is rejected by the render."""
  _, te, es, _, _ = scenes[0]['pad2-cube2']
  R = te.renderer.scene.tex_res
  tex = torch.rand((2, R, R, 3), generator=torch.Generator().manual_seed(0))
  seen = []

  def record(env, es_t, action, xs, textures=None):
    seen.append(textures)
    return action

  P.rollout(te, es, P.make_expert(te), length=2, record_fn=record,
            step_textures=tex)
  assert len(seen) == 2 and all(torch.equal(s, t) for s, t in zip(seen, tex))
  frame_fn = TE.make_record_fn(te, with_frames=True, with_depth=False)
  with pytest.raises(ValueError, match='textures'):
    P.rollout(te, es, P.make_expert(te), length=1, record_fn=frame_fn,
              step_textures=torch.zeros(1, 8, 8, 3))
