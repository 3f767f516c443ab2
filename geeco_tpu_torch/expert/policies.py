"""Scripted experts over B envs: per-env phase machines stepped in lockstep.

Counterpart of ``geeco_tpu/expert/policies.py``.  Each expert is a function
(EnvState, ExpertState) -> (action [B, 4], ExpertState') whose phase
transitions are evaluated per env with ``torch.where``; the action is
picked per env from the stacked phase actions with ``gather``.

Constants and exit conditions are the reference's (pick & place:
scripts/gym_pickplace.py:140-151, 369-563; pushing: scripts/gym_pushing.py:
127-133, 250-443), including its runtime behaviour: the pick & place DROP
phase never exits before the episode cap (the release test compares finger
positions in metres against the command value 1.0), so DROP is a terminal
"hold open, drift up" phase.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..envs.base import EnvState, GeecoEnv
from ..utils import profiling

# pick & place constants (gym_pickplace.py:140-151)
OFFSET_HEIGHT_PRE_GRASP = 0.05
DIST_PRE_GRASP = 0.005
DIST_GRASP = 0.002
DIST_ON_TOP = 0.175
DIST_GOAL = 0.01
MULT = 6.0
OPEN, CLOSE, NOOP = 1.0, -1.0, 0.0

# pushing constants (gym_pushing.py:127-133)
OFFSET_PRE_PUSH = 0.1
DIST_PRE_PUSH = 0.015


class ExpertState(NamedTuple):
  phase: torch.Tensor    # [B] int64
  target: torch.Tensor   # [B, 3] phase-entry captured target
  aux: torch.Tensor      # [B, 3] secondary capture (post-grasp pose/offsets)
  count: torch.Tensor    # [B] int64 sub-phase counter (pushing backoff)


def init_expert_state(batch: int, device=None) -> ExpertState:
  zi = torch.zeros((batch,), dtype=torch.int64, device=device)
  zf = torch.zeros((batch, 3), device=device)
  return ExpertState(phase=zi, target=zf, aux=zf.clone(), count=zi.clone())


def _norm(v: torch.Tensor) -> torch.Tensor:
  return torch.linalg.norm(v, dim=-1)


def _vec(like: torch.Tensor, x: float, y: float, z: float) -> torch.Tensor:
  return like.new_tensor([x, y, z])


def _with_grip(vec: torch.Tensor, cmd: float) -> torch.Tensor:
  """[B, 3] motion + gripper command -> [B, 4] action."""
  return torch.cat([vec, vec.new_full(vec.shape[:-1] + (1,), cmd)], -1)


def _pick(acts, phase: torch.Tensor) -> torch.Tensor:
  """Per-env row ``phase`` of the stacked phase actions [B, n, 4]."""
  acts = torch.stack(acts, 1)
  idx = torch.clamp(phase, 0, acts.shape[1] - 1)
  return torch.gather(acts, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]


# ---------------------------------------------------------------------------
# pick & place: PRE_GRASP(0) GRASP(1) POST_GRASP(2) MOVE(3) DROP(4)
# ---------------------------------------------------------------------------


def pickplace_expert(env: GeecoEnv):
  """Returns step_fn(es, xs) -> (action [B, 4], xs')."""

  def step_fn(es: EnvState, xs: ExpertState):
    kin = env.kin(es)
    grip = env.grip_pos(kin)
    obj = env.task_object_pos(es, kin)
    pad = env.task_goal_pos(es, kin)
    up = _vec(grip, 0.0, 0.0, OFFSET_HEIGHT_PRE_GRASP)

    pre_grasp_vec = obj - grip + up
    grasp_vec = obj - grip

    phase = xs.phase
    target = xs.target  # MOVE goal (captured at POST_GRASP exit)
    aux = xs.aux        # POST_GRASP grip target (captured at GRASP exit)

    # --- transitions (evaluated like the reference's while conditions)
    adv0 = (phase == 0) & (_norm(pre_grasp_vec) < DIST_PRE_GRASP)
    phase = torch.where(adv0, 1, phase)
    adv1 = (phase == 1) & (_norm(grasp_vec) < DIST_GRASP)
    aux = torch.where(adv1[:, None], grip + up, aux)
    phase = torch.where(adv1, 2, phase)
    adv2 = (phase == 2) & (_norm(aux - grip) < DIST_PRE_GRASP)
    target = torch.where(adv2[:, None],
                         pad + _vec(pad, 0.0, 0.0, DIST_ON_TOP), target)
    phase = torch.where(adv2, 3, phase)
    adv3 = (phase == 3) & (_norm(target - obj) < DIST_GOAL)
    phase = torch.where(adv3, 4, phase)

    # --- phase actions
    action = _pick([
        _with_grip(pre_grasp_vec * MULT, OPEN),
        _with_grip(grasp_vec * MULT, CLOSE),
        _with_grip((aux - grip) * MULT, CLOSE),
        _with_grip((target - obj) * MULT, CLOSE),
        _with_grip(_vec(grip, 0.0, 0.0, OFFSET_HEIGHT_PRE_GRASP / 2)
                   .expand_as(grip), OPEN),
    ], phase)
    return action, ExpertState(phase=phase, target=target, aux=aux,
                               count=xs.count)

  return step_fn


# ---------------------------------------------------------------------------
# pushing: PRE_PUSH_X(0) PUSH_X(1) BACKOFF(2) PRE_PUSH_Y(3) PUSH_Y(4) IDLE(5)
# ---------------------------------------------------------------------------


def pushing_expert(env: GeecoEnv):
  """Returns step_fn(es, xs) -> (action [B, 4], xs')."""

  def step_fn(es: EnvState, xs: ExpertState):
    kin = env.kin(es)
    grip = env.grip_pos(kin)
    obj = env.task_object_pos(es, kin)
    pad = env.task_goal_pos(es, kin)
    zero = torch.zeros_like(obj[:, 0])

    pre_x_vec = obj - grip - _vec(obj, OFFSET_PRE_PUSH, 0.0, 0.0)

    phase = xs.phase
    target = xs.target   # push goal (x-phase or y-phase)
    aux = xs.aux         # [offset_sign, goal_y, 0]
    count = xs.count

    # --- transitions
    adv0 = (phase == 0) & (_norm(pre_x_vec) < DIST_PRE_PUSH)
    # capture x-push goal: [pad.x, obj.y, obj.z] (gym_pushing.py:286-288)
    target = torch.where(adv0[:, None],
                         torch.stack([pad[:, 0], obj[:, 1], obj[:, 2]], -1),
                         target)
    phase = torch.where(adv0, 1, phase)

    adv1 = (phase == 1) & (_norm(target - obj) < DIST_GOAL)
    on_target_y = (pad[:, 1] - obj[:, 1]).abs() < DIST_GOAL
    # skip straight to IDLE when already aligned in y (gym_pushing.py:421)
    sign = torch.where(pad[:, 1] - obj[:, 1] > 0, -1.0, 1.0)
    aux = torch.where(adv1[:, None], torch.stack([sign, pad[:, 1], zero], -1),
                      aux)
    count = torch.where(adv1, 0, count)
    phase = torch.where(adv1, torch.where(on_target_y, 5, 2), phase)

    in_backoff = phase == 2
    count = torch.where(in_backoff, count + 1, count)
    phase = torch.where(in_backoff & (count >= 3), 3, phase)

    pre_y_vec = obj - grip + torch.stack(
        [zero, aux[:, 0] * OFFSET_PRE_PUSH, zero], -1)
    adv3 = (phase == 3) & (_norm(pre_y_vec) < DIST_PRE_PUSH)
    # capture y-push goal: [obj.x, pad.y, obj.z] (gym_pushing.py:361-363)
    target = torch.where(adv3[:, None],
                         torch.stack([obj[:, 0], aux[:, 1], obj[:, 2]], -1),
                         target)
    phase = torch.where(adv3, 4, phase)

    adv4 = (phase == 4) & (_norm(target - obj) < DIST_GOAL)
    phase = torch.where(adv4, 5, phase)

    # --- phase actions
    action = _pick([
        _with_grip(pre_x_vec * MULT, CLOSE),
        _with_grip((target - obj) * MULT, CLOSE),
        _with_grip(_vec(obj, -OFFSET_PRE_PUSH * MULT, 0.0, 0.0)
                   .expand_as(obj), CLOSE),
        _with_grip(pre_y_vec * MULT, CLOSE),
        _with_grip((target - obj) * MULT, CLOSE),
        _with_grip(torch.zeros_like(obj), NOOP),
    ], phase)
    return action, ExpertState(phase=phase, target=target, aux=aux,
                               count=count)

  return step_fn


def make_expert(env: GeecoEnv):
  step_fn = pushing_expert(env) if env.task == 'pushing' \
      else pickplace_expert(env)

  def expert(es: EnvState, xs: ExpertState):
    with profiling.span('expert'):
      return step_fn(es, xs)

  return expert


# ---------------------------------------------------------------------------
# the episode loop
# ---------------------------------------------------------------------------


def _stack_time(recs: list) -> Any:
  """Per-step records (tensors [B, ...], or dicts of them) stacked along a
  time axis after the env axis: [B, T, ...]."""
  first = recs[0]
  if isinstance(first, torch.Tensor):
    return torch.stack(recs, 1)
  if isinstance(first, dict):
    return {k: _stack_time([r[k] for r in recs]) for k in first}
  raise TypeError(f'record of type {type(first).__name__}: expected a '
                  'tensor or a dict of them')


def rollout(env: GeecoEnv, es: EnvState, expert_step: Callable,
            length: int = 100, record_fn: Optional[Callable] = None,
            step_textures=None, action_noise: Optional[torch.Tensor] = None):
  """Run an expert episode over B envs; (final EnvState, stacked records).

  A Python loop where the JAX package scans.  ``record_fn(env, es, action,
  xs, textures=None)`` returns the per-step record (a [B, ...] tensor, or
  a dict of them); it is called with the PRE-step state, as the
  reference records before it steps.  Without it the record is the
  expert's action.  Records are stacked along a time axis after the env
  axis, [B, T, ...] (the JAX rollout vmapped over envs).

  ``action_noise`` [B, length, 4]: DART-style noise added to the EXECUTED
  action only (then clipped at execution like any action); the recorded
  action stays the expert's clean one.  When given, its time axis sets the
  episode length, as in the JAX package.

  ``step_textures`` ([length, R, R, 3], or [length, B, R, R, 3] per env):
  the background texel frame of each step, handed to ``record_fn`` as
  ``textures`` (background-video randomisation of the recorded frames).
  """
  n = length if action_noise is None else action_noise.shape[1]
  xs = init_expert_state(es.phys.qpos.shape[0], es.phys.qpos.device)
  recs = []
  for t in range(n):
    action, xs = expert_step(es, xs)
    tex = None if step_textures is None else step_textures[t]
    recs.append(record_fn(env, es, action, xs, textures=tex)
                if record_fn is not None else action)
    exec_action = action if action_noise is None else \
        action + action_noise[:, t].to(action)
    es = env.step(es, exec_action)
  return es, _stack_time(recs)
