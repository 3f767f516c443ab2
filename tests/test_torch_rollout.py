"""The closed loop's step-wise rollout (``models/closed_loop.py`` ``Rollout``)
on the CPU: stepped by hand or through ``evaluate_batched``, it gives what
the loop it replaced gave, bit for bit; its control step equals the
benchmark's plain reference (``benchmark/ref/models/closed_loop.py``) on
seeded random weights; its policy step is traced."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.kinds.train import draw_weights
from geeco_tpu_torch.envs.base import GeecoEnv, make_env
from geeco_tpu_torch.models import closed_loop as TC
from geeco_tpu_torch.models import e2evmc as TE
from geeco_tpu_torch.models.params import create_e2evmc_config
from geeco_tpu_torch.utils import profiling

torch.set_num_threads(1)

B = 2
STEPS = 3
SEED = 2 ** 31 + 7


def _config(side):
  return create_e2evmc_config({
      'img_height': side, 'img_width': side, 'proc_obs': 'dynimg',
      'proc_tgt': 'dyndiff', 'dim_s_obs': 20, 'dim_s_dyn': 20,
      'dim_s_diff': 20, 'dim_h_lstm': 8, 'dim_h_fc': 8, 'window_size': 2,
      'compute_dtype': 'float32'})


def _model(make_model, cfg):
  """A model of ``cfg`` with every weight drawn from SEED (the heads are
  not zero, so the arm moves)."""
  model = make_model(cfg, True, device='cpu')
  draw_weights(model, SEED, 'cpu')
  return model


@pytest.fixture(scope='module')
def env():
  e = make_env('pad1-cube1', frame_res=(64, 64), settle_steps=1,
               n_substeps=4, solver_iterations=8, device='cpu')
  e.setup()
  return e


def _loop_it_replaced(env, config, model, generator, n_steps,
                      step_textures, collect_frames):
  """``evaluate_batched``'s loop as it stood before the rollout was split
  into steps (no mesh)."""
  env.setup()
  step_fn = TC.make_closed_loop(env, config, True, None)
  es = env.reset_random(B, generator)
  dev = env.device
  tgt_frames = TC.synth_target_frames(env, config, es)
  n_frames = max(0, min(collect_frames, B))
  ps = TC.init_policy_state(config, B, dev)
  z, full = torch.zeros(B, device=dev), lambda v: torch.full((B,), v,
                                                             device=dev)
  agg = {
      'obj_vicinity': z, 'grasp_success': z, 'min_goal_dist': full(1e3),
      'max_goal_dist': z, 'final_goal_dist': z, 'task_success': z,
      'steps_grasped': z, 'max_obj_z': z, 'drop_goal_dist': full(-1.0),
      'last_grasp': z,
  }
  frames = []
  for t in range(n_steps):
    tex = step_textures[t] if step_textures is not None else None
    es, ps, m, rgb = step_fn(model, es, ps, tgt_frames, tex)
    frames.append(rgb[:n_frames].cpu().numpy())
    agg['obj_vicinity'] = torch.maximum(agg['obj_vicinity'],
                                        m['obj_vicinity'])
    agg['grasp_success'] = torch.maximum(agg['grasp_success'],
                                         m['grasp_success'])
    agg['min_goal_dist'] = torch.minimum(agg['min_goal_dist'],
                                         m['goal_dist'])
    agg['max_goal_dist'] = torch.maximum(agg['max_goal_dist'],
                                         m['goal_dist'])
    agg['final_goal_dist'] = m['goal_dist']
    agg['task_success'] = m['task_success']
    agg['steps_grasped'] = agg['steps_grasped'] + m['grasp_success']
    agg['max_obj_z'] = torch.maximum(agg['max_obj_z'], m['obj_z'])
    dropped = (agg['last_grasp'] > 0) & (m['grasp_success'] == 0)
    agg['drop_goal_dist'] = torch.where(dropped, m['goal_dist'],
                                        agg['drop_goal_dist'])
    agg['last_grasp'] = m['grasp_success']
  return agg, np.stack(frames)


@pytest.mark.parametrize('textured', [False, True],
                         ids=['plain', 'step_textures'])
def test_stepping_the_rollout_gives_what_the_loop_it_replaced_gave(
    env, textured):
  cfg = _config(64)
  model = _model(TE.make_model, cfg)
  R = env.renderer.scene.tex_res
  tex = torch.rand((STEPS, R, R, 3),
                   generator=torch.Generator().manual_seed(3)) \
      if textured else None
  gen = lambda: torch.Generator().manual_seed(11)    # noqa: E731
  agg0, frames0 = _loop_it_replaced(env, cfg, model, gen(), STEPS, tex, 1)
  agg1, frames1 = TC.evaluate_batched(
      env, cfg, model, True, B, gen(), n_steps=STEPS, step_textures=tex,
      collect_frames=1)
  rollout = TC.Rollout(env, cfg, model, True, B, gen(), collect_frames=1)
  rgbs = [rollout.step(tex[t] if textured else None) for t in range(STEPS)]
  frames2 = np.stack(rollout.frames)
  assert frames0.shape == (STEPS, 1, 64, 64, 3)
  assert np.array_equal(frames1, frames0)
  assert np.array_equal(frames2, frames0)
  assert np.array_equal(torch.stack(rgbs)[:, :1].numpy(), frames0)
  assert set(agg1) == set(agg0) == set(rollout.agg)
  for k, v in agg0.items():
    assert torch.equal(agg1[k], v), k
    assert torch.equal(rollout.agg[k], v), k
  assert float(agg0['max_goal_dist'].max()) < 2.0


def test_the_control_step_equals_the_plain_reference():
  """Two closed-loop control steps of the port and of the benchmark's
  frozen reference from one state, on the same seeded weights: the same
  action, gripper logits, frame and next qpos, bit for bit (the same
  arithmetic on the CPU: the reference's tile rasterizer is the port's
  plain twin, which the port takes on the CPU too)."""
  from benchmark.kinds.common import convert
  from benchmark.ref.core.model import State as RefPhys
  from benchmark.ref.envs.base import EnvState as RefEnvState
  from benchmark.ref.envs.base import GeecoEnv as RefEnv
  from benchmark.ref.models import closed_loop as RC
  from benchmark.ref.models import e2evmc as RE
  kwargs = dict(shapes='pad2-cube2', frame_res=(32, 32), settle_steps=1,
                n_substeps=2, solver_iterations=4, device='cpu')
  env, ref = GeecoEnv(**kwargs), RefEnv(**kwargs)
  env.setup()
  cfg = _config(32)
  sides = []
  for e, make_model, make_closed_loop, init_policy_state in (
      (env, TE.make_model, TC.make_closed_loop, TC.init_policy_state),
      (ref, RE.make_model, RC.make_closed_loop, RC.init_policy_state)):
    model = _model(make_model, cfg)
    logits, actions = [], []
    model.register_forward_hook(
        lambda module, args, out: logits.append(out[0]['logits_cmd_grp']))
    step = e.step

    def keep_action(es, action, step=step, actions=actions):
      actions.append(action)
      return step(es, action)

    e.step = keep_action
    es = env.reset_random(B, torch.Generator().manual_seed(SEED))
    if e is ref:
      fields = {f.name: getattr(es, f.name) for f in dataclasses.fields(es)}
      es = RefEnvState(**dict(fields, phys=convert(es.phys, RefPhys)))
    tgt = TC.synth_target_frames(env, cfg, env.reset_random(
        B, torch.Generator().manual_seed(SEED + 1)))
    step_fn = make_closed_loop(e, cfg, True)
    ps = init_policy_state(cfg, B)
    rgbs, qpos = [], []
    for _ in range(2):
      es, ps, _, rgb = step_fn(model, es, ps, tgt)
      rgbs.append(rgb)
      qpos.append(es.phys.qpos)
    del e.step
    sides.append({'action': torch.stack(actions),
                  'logits': torch.stack(logits), 'rgb': torch.stack(rgbs),
                  'qpos': torch.stack(qpos)})
  prog, truth = sides
  assert float(truth['action'][:, :, :3].abs().max()) > 1e-2
  assert float((truth['qpos'][1] - truth['qpos'][0]).abs().max()) > 1e-4
  for k in truth:
    assert torch.equal(prog[k], truth[k]), k


def test_the_policy_step_is_traced_only_while_the_tracer_is_on():
  cfg = _config(32)
  model = _model(TE.make_model, cfg)
  policy = TC.make_closed_loop(None, cfg, True).policy_step
  gen = torch.Generator().manual_seed(1)
  obs = torch.rand((B, 32, 32, 3), generator=gen)
  jnt = torch.rand((B, 7), generator=gen)

  def two_steps():
    ps = TC.init_policy_state(cfg, B)
    for _ in range(2):
      action, ps = policy(model, ps, obs, jnt, obs)
    return action

  profiling.reset()
  off = two_steps()
  assert profiling.snapshot()['spans'] == {}
  assert 'policy.windows' not in profiling.snapshot()['counters']
  profiling.enable()
  try:
    on = two_steps()
    snap = profiling.snapshot()
  finally:
    profiling.disable()
    profiling.reset()
  assert torch.equal(on, off)
  span = snap['spans']['closed_loop.policy']
  assert span['calls'] == 2 and span['parents'] == {'': 2}
  assert span['counters'] == {'policy.windows': 2 * B}
  assert snap['counters']['policy.windows'] == 2 * B


def test_the_goal_frames_equal_the_plain_reference():
  """The goal frames of one seeded reset, port and reference, bit for
  bit."""
  from benchmark.kinds.common import convert
  from benchmark.ref.core.model import State as RefPhys
  from benchmark.ref.envs.base import EnvState as RefEnvState
  from benchmark.ref.envs.base import GeecoEnv as RefEnv
  from benchmark.ref.models import closed_loop as RC
  kwargs = dict(shapes='pad2-cube2', frame_res=(32, 32), settle_steps=1,
                n_substeps=2, solver_iterations=4, device='cpu')
  env, ref = GeecoEnv(**kwargs), RefEnv(**kwargs)
  env.setup()
  cfg = _config(32)
  es = env.reset_random(4, torch.Generator().manual_seed(SEED))
  fields = {f.name: getattr(es, f.name) for f in dataclasses.fields(es)}
  ref_es = RefEnvState(**dict(fields, phys=convert(es.phys, RefPhys)))
  prog = TC.synth_target_frames(env, cfg, es)
  truth = RC.synth_target_frames(ref, cfg, ref_es)
  assert prog.shape == (4, 32, 32, 3)
  assert float(prog.std()) > 0.05
  assert torch.equal(prog, truth)


@pytest.mark.parametrize('carry_mode', ['window', 'persistent'])
def test_the_policy_state_handed_on_equals_the_plain_reference(carry_mode):
  """Three policy steps of the port and of the reference from the initial
  state, on the same seeded weights and inputs: the same actions and the
  same state handed on (ring buffer, joint states, carry, ``started``),
  bit for bit."""
  from benchmark.ref.models import closed_loop as RC
  from benchmark.ref.models import e2evmc as RE
  cfg = _config(32)
  gen = torch.Generator().manual_seed(SEED)
  inputs = [(torch.rand((B, 32, 32, 3), generator=gen),
             torch.rand((B, 7), generator=gen)) for _ in range(3)]
  tgt = torch.rand((B, 32, 32, 3), generator=gen)
  sides = []
  for make_model, make_closed_loop, init_policy_state in (
      (TE.make_model, TC.make_closed_loop, TC.init_policy_state),
      (RE.make_model, RC.make_closed_loop, RC.init_policy_state)):
    model = _model(make_model, cfg)
    policy = make_closed_loop(None, cfg, True, carry_mode).policy_step
    ps, out = init_policy_state(cfg, B), []
    for obs, jnt in inputs:
      action, ps = policy(model, ps, obs, jnt, tgt)
      out.append((action, ps.frames, ps.jnt, ps.carry[0], ps.carry[1],
                  ps.started))
    sides.append(out)
  prog, truth = sides
  assert torch.equal(truth[-1][1][:, -1], inputs[-1][0])
  assert torch.equal(truth[-1][1][:, -2], inputs[-2][0])
  for p, t in zip(prog, truth):
    for a, b in zip(p, t):
      assert torch.equal(a, b)
