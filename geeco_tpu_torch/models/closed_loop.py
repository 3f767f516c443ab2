"""Closed-loop policy evaluation on the device (PyTorch).

Counterpart of ``geeco_tpu/models/closed_loop.py``: render, frame ring
buffer, CNN+LSTM forward, action and the env's control step, for a batch of
envs whose state stays on the device; the host reads only the metrics.
Where the JAX package vmaps a per-env step over the batch, these functions
take the env axis B written out.

The policy state mirrors the predictor (src/models/e2evmc/predictor.py:
127-200): a window_size frame buffer padded with the first frame, the LSTM
carry persisted across steps, argmax -> {-1, 0, 1} gripper command.

``Rollout`` is a rollout of the batch one control step a call, with the
metrics aggregated over its steps; ``evaluate_batched`` drives one to its
end.  ``step_textures`` put a background frame a step on the
camera-facing wall.  ``evaluate_batched(mesh=...)`` runs this rank's shard
of the batch (one process per device, ``parallel/mesh.py``) and gathers
the metrics in global env order.

Traced (``utils/profiling.py``): the span ``closed_loop.policy`` around
the policy step (ring buffer, forward, action) and the counter
``policy.windows``, the windows it encodes (B a step).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..envs.base import EnvState, GeecoEnv
from ..parallel import mesh as PM
from ..utils import profiling
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
    with profiling.span('closed_loop.policy'):
      profiling.count('policy.windows', obs_frame.shape[0])
      return _policy_step(model, ps, obs_frame, jnt_state, tgt_frame)

  def _policy_step(model, ps, obs_frame, jnt_state, tgt_frame):
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


@torch.no_grad()
def synth_target_frames(env: GeecoEnv, config: E2EVMCConfig,
                        es: EnvState) -> torch.Tensor:
  """Goal frames [B, H, W, C] in [0, 1] for a batch of envs: the task
  object teleported onto its task goal site, rendered (one render of the
  batch).  The reference conditions on an image of the accomplished task
  (predictor.py:206-208); after a random reset no recording exists."""
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
  kin_t = env.stepper.fk(es.phys.replace(qpos=qpos))
  rgb, depth = env.renderer.render(kin_t, es.rgba)
  obs = rgb.float() / 255.0
  if config.img_channels == 4:
    obs = torch.cat([obs, depth[..., None]], -1)
  return obs


class Rollout:
  """A closed-loop rollout of a batch of envs, one control step a call.

  Built, it resets (``env.reset_random(batch, generator, rows=rows)``, or
  takes ``es0``), makes the goal frames (``synth_target_frames``, unless
  ``tgt_frames`` are given; zeros for an unconditional model) and the
  policy state; each ``step`` runs one closed-loop control step of the
  batch (render, policy, ``env.step``, the eval metrics) and folds its
  metrics into ``agg`` (per-env [B] each).  ``collect_frames``=V > 0 also
  copies, each step, the frames of the first V envs of the whole batch
  that are this rank's (``rows``) to the host, into ``frames``.
  """

  def __init__(self, env: GeecoEnv, config: E2EVMCConfig, model: E2EVMC,
               goal_conditioned: bool, batch: int,
               generator: Optional[torch.Generator] = None,
               tgt_frames: Optional[torch.Tensor] = None,
               es0: Optional[EnvState] = None,
               carry_mode: Optional[str] = None, rows=None,
               collect_frames: int = 0):
    env.setup()
    self.model = model
    self.step_fn = make_closed_loop(env, config, goal_conditioned,
                                    carry_mode)
    es = es0 if es0 is not None else env.reset_random(batch, generator,
                                                      rows=rows)
    B = es.task_goal.shape[0]
    dev = env.device
    if tgt_frames is None:
      if goal_conditioned:
        tgt_frames = synth_target_frames(env, config, es)
      else:
        tgt_frames = torch.zeros((B, config.img_height, config.img_width,
                                  config.img_channels), device=dev)
    self.es, self.tgt_frames = es, tgt_frames
    first = 0 if rows is None else rows.start
    self.n_frames = max(0, min(collect_frames - first, B))
    self.ps = init_policy_state(config, B, dev)
    z, full = torch.zeros(B, device=dev), lambda v: torch.full((B,), v,
                                                               device=dev)
    self.agg: Dict[str, torch.Tensor] = {
        'obj_vicinity': z, 'grasp_success': z, 'min_goal_dist': full(1e3),
        'max_goal_dist': z, 'final_goal_dist': z, 'task_success': z,
        # triage extras: where in grasp->transport->place does it fail?
        'steps_grasped': z, 'max_obj_z': z, 'drop_goal_dist': full(-1.0),
        'last_grasp': z,
    }
    self.frames: Optional[list] = [] if collect_frames > 0 else None

  def step(self, textures=None) -> torch.Tensor:
    """One control step; ``textures``: its background frame ([R, R, 3] or
    one per env) or None.  Returns the frame it rendered, RGB uint8
    [B, H, W, 3]."""
    self.es, self.ps, m, rgb = self.step_fn(self.model, self.es, self.ps,
                                            self.tgt_frames, textures)
    if self.frames is not None:
      self.frames.append(rgb[:self.n_frames].cpu().numpy())
    agg = self.agg
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
    # goal_dist at the (last) moment the grasp was lost: -1 = never lost
    dropped = (agg['last_grasp'] > 0) & (m['grasp_success'] == 0)
    agg['drop_goal_dist'] = torch.where(dropped, m['goal_dist'],
                                        agg['drop_goal_dist'])
    agg['last_grasp'] = m['grasp_success']
    return rgb


def evaluate_batched(env: GeecoEnv, config: E2EVMCConfig, model: E2EVMC,
                     goal_conditioned: bool, batch: int,
                     generator: Optional[torch.Generator] = None,
                     tgt_frames: Optional[torch.Tensor] = None,
                     n_steps: int = 200, es0: Optional[EnvState] = None,
                     step_textures=None, carry_mode: Optional[str] = None,
                     mesh=None, collect_frames: int = 0):
  """Reset (``env.reset_random(batch, generator)``, or ``es0``) and a
  closed-loop rollout of ``n_steps`` control steps (``Rollout``); returns
  the per-env metrics [B] each.

  ``step_textures`` ([n_steps, R, R, 3] or None): the background frame
  of each step.  collect_frames=V > 0 additionally copies the first V
  envs' frames to the host every step and returns (metrics, frames
  [n_steps, V, H, W, 3] uint8), for eval videos.

  ``mesh`` (``parallel.mesh.Mesh``): this rank runs its rows of the
  ``batch`` envs (``reset_random(..., rows=)``; ``es0`` and ``tgt_frames``,
  when given, are already this rank's shard, as ``shard_env_batch`` cuts
  them) and every rank returns the metrics, and frames, of all ``batch``
  envs in global order.
  """
  rollout = Rollout(env, config, model, goal_conditioned, batch, generator,
                    tgt_frames, es0, carry_mode,
                    None if mesh is None else mesh.rows(batch),
                    collect_frames)
  for t in range(n_steps):
    rollout.step(step_textures[t] if step_textures is not None else None)
  agg, frames = rollout.agg, rollout.frames
  if frames is not None:
    frames = np.stack(frames)                   # [n_steps, n_frames, ...]
  if mesh is not None:
    agg = {k: PM.all_gather_rows(v, mesh) for k, v in agg.items()}
    if frames is not None:
      frames = np.concatenate(PM.all_gather_objects(frames, mesh), axis=1)
  if frames is not None:
    return agg, frames
  return agg
