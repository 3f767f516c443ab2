"""The closed loop's policy step, control step and goal frames, plain: a
copy of ``geeco_tpu_torch/models/closed_loop.py``'s ``PolicyState``,
``init_policy_state``, ``make_closed_loop`` and ``synth_target_frames`` as
they stood when the closed-loop cell was added, on this package's env and
model (the render takes the tile rasterizer's plain twin, the solve the
plain iteration).  Left out: the step-wise rollout and
``evaluate_batched`` with its mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..envs.base import EnvState, GeecoEnv
from .e2evmc import E2EVMC, init_lstm_carry
from .params import E2EVMCConfig


class PolicyState(NamedTuple):
  frames: torch.Tensor   # [B, K, H, W, C] ring buffer
  jnt: torch.Tensor      # [B, K, 7]
  carry: Tuple[torch.Tensor, torch.Tensor]   # [B, dim_h_lstm] each
  started: torch.Tensor  # [B] bool: buffer initialized


def init_policy_state(config: E2EVMCConfig, batch: int,
                      device=None) -> PolicyState:
  K = config.window_size
  return PolicyState(
      frames=torch.zeros((batch, K, config.img_height, config.img_width,
                          config.img_channels), device=device),
      jnt=torch.zeros((batch, K, config.dim_jnt_state), device=device),
      carry=init_lstm_carry(config, batch, device),
      started=torch.zeros((batch,), dtype=torch.bool, device=device),
  )


def make_closed_loop(env: Optional[GeecoEnv], config: E2EVMCConfig,
                     goal_conditioned: bool,
                     carry_mode: Optional[str] = None):
  """Returns step_fn(model, es, ps, tgt_frames) -> (es, ps, metrics, rgb),
  one closed-loop control step of the batch; ``step_fn.policy_step(model,
  ps, obs, jnt, tgt_frames) -> (action, ps)`` is its policy half.

  carry_mode: serving must match the carry semantics the model was TRAINED
  with (config.train_carry).  None/'auto' derives it: 'window' (fresh carry
  per step) for stateless-trained models, 'persistent' (the reference
  predictor's carry across steps) for BPTT-trained ones.
  """
  if carry_mode in (None, 'auto'):
    carry_mode = ('window' if config.train_carry == 'stateless'
                  else 'persistent')
  if carry_mode not in ('window', 'persistent'):
    raise ValueError(f'unknown carry_mode {carry_mode!r}')

  @torch.no_grad()
  def policy_step(model: E2EVMC, ps: PolicyState, obs_frame: torch.Tensor,
                  jnt_state: torch.Tensor, tgt_frame: torch.Tensor):
    """obs_frame [B, H, W, C] in [0, 1], jnt_state [B, 7] -> action [B, 4]."""
    # ring buffer with first-frame padding (predictor.py:192-200)
    started = ps.started.view(-1, 1, 1, 1, 1)
    frames = torch.where(
        started, torch.cat([ps.frames[:, 1:], obs_frame[:, None]], 1),
        obs_frame[:, None].expand_as(ps.frames))
    jnt = torch.where(
        ps.started.view(-1, 1, 1),
        torch.cat([ps.jnt[:, 1:], jnt_state[:, None]], 1),
        jnt_state[:, None].expand_as(ps.jnt))
    if carry_mode == 'window':
      in_carry, reset = None, True
    else:
      in_carry, reset = ps.carry, ~ps.started
    if goal_conditioned:
      ep, carry = model(frames, jnt, tgt_frame, in_carry, reset)
    else:
      ep, carry = model(frames, jnt, in_carry, reset)
    cmd_grp = (ep['logits_cmd_grp'].argmax(-1) - 1).float()
    action = torch.cat([ep['pred_cmd_ee'], cmd_grp[:, None]], -1)
    return action, PolicyState(frames=frames, jnt=jnt, carry=carry,
                               started=torch.ones_like(ps.started))

  def step_fn(model: E2EVMC, es: EnvState, ps: PolicyState,
              tgt_frame: torch.Tensor, textures=None):
    """One closed-loop control step of the B envs; ``textures``: this
    step's background texel frame ([R, R, 3] or one per env) or None."""
    tex = env.background_textures(textures) if textures is not None \
        else None
    rgb, depth = env.render(es, textures=tex)
    obs = rgb.float() / 255.0
    if config.img_channels == 4:
      obs = torch.cat([obs, depth[..., None]], -1)
    action, ps = policy_step(model, ps, obs, env.proprioception(es),
                             tgt_frame)
    es = env.step(es, action)
    m = env.eval_metrics(es)
    # failure-triage extra (not part of the reference eval contract):
    # object height tells lift apart from floor-drag
    m['obj_z'] = env.task_object_pos(es, env.kin(es))[:, 2]
    return es, ps, m, rgb

  step_fn.policy_step = policy_step
  return step_fn


def synth_target_frames(env: GeecoEnv, config: E2EVMCConfig,
                        es: EnvState) -> torch.Tensor:
  """Goal frames [B, H, W, C] in [0, 1]: the task object teleported onto
  its task goal site, rendered (the kinematics of both states through
  ``env.kin``)."""
  kin = env.kin(es)
  B = es.task_goal.shape[0]
  rows = torch.arange(B, device=es.task_goal.device)
  goal_ids = env.model.const(f'env.sites{tuple(env.goal_site_ids)}',
                             env.goal_site_ids)
  goal = kin.site_xpos[:, goal_ids][rows, es.task_goal]          # [B, 3]
  qpos = es.phys.qpos.clone()
  m = env.model
  for i, site in enumerate(env.cube_sites):
    adr = m.jnt_qposadr[m.joint(f'{site}:joint')]
    cur = qpos[:, adr:adr + 7]
    new = torch.cat([goal[:, :2], cur[:, 2:]], -1)
    qpos[:, adr:adr + 7] = torch.where((es.task_object == i)[:, None], new,
                                       cur)
  kin_t = env.kin(es.replace(phys=es.phys.replace(qpos=qpos)))
  rgb, depth = env.renderer.render(kin_t, es.rgba)
  obs = rgb.float() / 255.0
  if config.img_channels == 4:
    obs = torch.cat([obs, depth[..., None]], -1)
  return obs
