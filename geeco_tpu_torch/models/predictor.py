"""Closed-loop predictors: frame ring buffer + forward pass (PyTorch).

Counterpart of ``geeco_tpu/models/predictor.py``, with its serving parity
with the reference Predictor API (src/models/e2evmc/predictor.py): batch
size 1, a ring buffer of ``window_size`` frames padded with the first frame
(:192-200, 367-375), input shape + [0,1] range validation with 1e-6
tolerance (:127-138), argmax -> {-1, 0, +1} gripper remap (:183-189),
``set_goal`` target frame for the goal-conditioned variant (:206-208), and
the LSTM state persisted across ``predict`` calls, zeroed by ``reset``.

The model lives on ``device`` (default: the card); ``predict`` takes and
returns numpy, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .e2evmc import make_model
from .params import E2EVMCConfig, load_model_config
from .snapshots import latest_checkpoint, restore_params

VALUE_TOL = 1e-6  # predictor.py:17


class _BasePredictor:
  goal_conditioned = False

  def __init__(self, model_dir: str, checkpoint_name: Optional[str] = None,
               config: Optional[E2EVMCConfig] = None,
               carry_mode: Optional[str] = None, device=None):
    """carry_mode: serving must match the carry semantics the model was
    TRAINED with (config.train_carry — see models/params.py).  None/'auto'
    derives it from the config: 'window' (fresh carry per predict) for
    stateless-trained models, 'persistent' (reference predictor behavior,
    predictor.py:127-200) for BPTT-trained ones.

    The weights are ``checkpoint_name`` in ``model_dir``, or its latest
    ``ckpt-*.pt``; the config its ``e2evmc_config.json`` unless given.
    """
    if config is None:
      config = load_model_config(os.path.join(model_dir,
                                              'e2evmc_config.json'))
    self.cfg = config
    if carry_mode in (None, 'auto'):
      carry_mode = ('window' if config.train_carry == 'stateless'
                    else 'persistent')
    if carry_mode not in ('window', 'persistent'):
      raise ValueError(f'unknown carry_mode {carry_mode!r}')
    self.carry_mode = carry_mode
    self.device = resolve_device(device)
    if checkpoint_name:
      ckpt = os.path.join(model_dir, checkpoint_name)
    else:
      ckpt = latest_checkpoint(model_dir)
      if ckpt is None:
        raise FileNotFoundError(f'no checkpoint in {model_dir}')
    self.model = restore_params(ckpt, make_model(
        config, self.goal_conditioned, self.device)).eval()
    self.reset()

  # ---- serving API

  def reset(self):
    self._buffer_frames = None  # [K, H, W, C]
    self._buffer_jnt = None     # [K, 7]
    self._carry = None          # zero carry
    self._needs_reset = True
    self._tgt = np.zeros((self.cfg.img_height, self.cfg.img_width,
                          self.cfg.img_channels), np.float32)

  def set_goal(self, target_frame: np.ndarray):
    cfg = self.cfg
    expect = (cfg.img_height, cfg.img_width, cfg.img_channels)
    if target_frame.shape != expect:
      raise ValueError(f'target frame shape {target_frame.shape} != '
                       f'{expect}')
    self._tgt = np.asarray(target_frame, np.float32)

  def _feed_frame(self, obs_frame: np.ndarray, jnt_state: np.ndarray):
    cfg = self.cfg
    expect = (cfg.img_height, cfg.img_width, cfg.img_channels)
    if obs_frame.shape != expect:
      raise ValueError(f'obs frame shape {obs_frame.shape} != {expect}')
    if not (obs_frame.min() >= 0.0 - VALUE_TOL and
            obs_frame.max() <= 1.0 + VALUE_TOL):
      raise ValueError('obs frame values must be normalized to [0, 1]')
    obs_frame = np.asarray(obs_frame, np.float32)
    jnt_state = np.asarray(jnt_state, np.float32)
    if self._buffer_frames is None:  # pad with first frame
      self._buffer_frames = np.stack([obs_frame] * cfg.window_size)
      self._buffer_jnt = np.stack([jnt_state] * cfg.window_size)
    else:
      self._buffer_frames = np.concatenate(
          [self._buffer_frames[1:], obs_frame[None]], axis=0)
      self._buffer_jnt = np.concatenate(
          [self._buffer_jnt[1:], jnt_state[None]], axis=0)

  @torch.no_grad()
  def predict(self, obs_frame: np.ndarray, jnt_state: np.ndarray
              ) -> Dict[str, np.ndarray]:
    self._feed_frame(obs_frame, jnt_state)
    dev = self.device
    frames = torch.as_tensor(self._buffer_frames, device=dev)[None]
    jnt = torch.as_tensor(self._buffer_jnt, device=dev)[None]
    if self.carry_mode == 'window':
      in_carry, reset = None, True
    else:
      in_carry, reset = self._carry, self._needs_reset
    if self.goal_conditioned:
      tgt = torch.as_tensor(self._tgt, device=dev)[None]
      ep, carry = self.model(frames, jnt, tgt, in_carry, reset)
    else:
      ep, carry = self.model(frames, jnt, in_carry, reset)
    self._carry = carry
    self._needs_reset = False
    ep = {k: v[0].float().cpu().numpy() for k, v in ep.items()}
    out: Dict[str, np.ndarray] = {}
    if self.cfg.control_mode == 'cartesian':
      out['cmd_ee'] = ep['pred_cmd_ee']
      grp = int(np.argmax(ep['logits_cmd_grp'])) - 1
      out['cmd_grp'] = np.asarray([float(grp)], np.float32)
    else:
      out['cmd_vel'] = ep['pred_cmd_vel']
      out['cmd_ee'] = ep['pred_cmd_ee']
      out['cmd_grp'] = ep['pred_cmd_grp']
    out['pos_ee'] = ep['pred_aux_ee']
    out['pos_obj'] = ep['pred_aux_obj']
    for k in ('dynbuff', 'dyndiff'):
      if k in ep:
        out[k] = ep[k]
    return out


class E2EVMCPredictor(_BasePredictor):
  """Unconditional reflex predictor (reference E2EVMCPredictor, :212)."""
  goal_conditioned = False


class GoalE2EVMCPredictor(_BasePredictor):
  """Goal-conditioned predictor (reference GoalE2EVMCPredictor, :43)."""
  goal_conditioned = True
