"""E2E-VMC hyper-parameter config (pure Python).

The port's own copy of ``geeco_tpu/models/params.py``, kept equal to it so a
config file written by either package loads in the other.  Field/default
parity with the reference config (src/models/e2evmc/params.py: 7-28) plus
the accelerator knobs (compute dtype).  JSON persistence matches
save_model_config/load_model_config (src/models/e2evmc/utils.py:16-27) so a
resumed run cannot silently change architecture
(scripts/train_e2evmc.py:229-252).
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict

E2E_VMC_DEFAULT_PARAM_DICT: Dict[str, Any] = {
    'img_height': 256,
    'img_width': 256,
    'img_channels': 3,
    'dim_jnt_state': 7,
    'dim_grp_command': 2,
    'control_mode': 'cartesian',   # cartesian | velocity
    'num_grp_states': 3,           # close / no-op / open
    'dim_action': 4,
    'proc_obs': 'sequence',        # sequence | dynimg
    'proc_tgt': 'constant',        # constant | residual | dyndiff
    'dim_s_obs': 256,
    'dim_s_dyn': 256,
    'dim_s_diff': 256,
    'dim_h_lstm': 128,
    'dim_h_fc': 128,
    'window_size': 4,
    'l2_regularizer': 0.0,
    'lambda_aux': 1.0,
    'batch_size': 32,
    'lr': 1e-4,
    # accelerator additions
    'compute_dtype': 'bfloat16',   # conv compute precision
    # LSTM carry semantics the model was TRAINED with; serving must match.
    #   'stateless': fresh (zero) carry per window.  This is what the
    #     reference's training dynamics effectively produce: its carry
    #     tensor crosses unrelated windows (row i of consecutive batches is
    #     32 windows apart, geeco_gym.py:465-472), so the trained policy is
    #     reactive.  Full-episode BPTT instead lets the LSTM learn an
    #     episode-indexed action playback that memorizes the train split
    #     (round-2 measured: train cmd MSE 0.09, eval 0.55 = two random
    #     scripts' disagreement) — stateless is the generalizing choice.
    #   'bptt': carry propagates through the episode window sequence
    #     (persistent-carry serving), for experiments.
    'train_carry': 'stateless',
    # 'group' = GroupNorm before each encoder ReLU (see e2evmc.ConvEncoder:
    # the reference's raw stack degenerates when rebuilt); 'none' = raw
    # reference architecture.
    'encoder_norm': 'group',
    # episode-mode command-loss weighting across an episode's windows:
    #   'none'     uniform (reference semantics: every window equal)
    #   'cmd_mag'  weight each window by its command magnitude (clipped,
    #     renormalized to mean 1) — a 100-step expert episode is ~70%
    #     near-idle tail, so the balanced episode gradient dilutes the ~30
    #     large-action approach windows; this re-focuses the command losses
    #     on them without changing the loss scale.
    'loss_weighting': 'none',
    # start-window boost: multiply the command-loss weight of the first
    # `start_boost_windows` windows of every episode (the K-1 first-frame-
    # padded windows + the early near-static ones) by `start_boost`, then
    # renormalize to masked mean 1.  Round-3 post-mortem: the policy was
    # near-perfect on moving windows (open-loop cosine ~0.99) but predicted
    # the WRONG DIRECTION on the fully-padded first window — closed-loop it
    # never escaped the static start basin (obj_vicinity 8.97%, success 0%).
    # Start windows are <12% of an episode but 100% of the escape problem;
    # uniform (or cmd_mag) weighting cannot make them dominate.
    'start_boost': 1.0,
    'start_boost_windows': 13,     # K-1 padded + first ~10 real windows
}


@dataclasses.dataclass(frozen=True)
class E2EVMCConfig:
  img_height: int = 256
  img_width: int = 256
  img_channels: int = 3
  dim_jnt_state: int = 7
  dim_grp_command: int = 2
  control_mode: str = 'cartesian'
  num_grp_states: int = 3
  dim_action: int = 4
  proc_obs: str = 'sequence'
  proc_tgt: str = 'constant'
  dim_s_obs: int = 256
  dim_s_dyn: int = 256
  dim_s_diff: int = 256
  dim_h_lstm: int = 128
  dim_h_fc: int = 128
  window_size: int = 4
  l2_regularizer: float = 0.0
  lambda_aux: float = 1.0
  batch_size: int = 32
  lr: float = 1e-4
  compute_dtype: str = 'bfloat16'
  train_carry: str = 'stateless'
  encoder_norm: str = 'group'
  loss_weighting: str = 'none'
  start_boost: float = 1.0
  start_boost_windows: int = 13

  def asdict(self) -> Dict[str, Any]:
    return dataclasses.asdict(self)


E2E_VMC_DEFAULT_CONFIG = E2EVMCConfig()


def create_e2evmc_config(custom_params: Dict[str, Any]) -> E2EVMCConfig:
  """Merge custom params over defaults (reference create_e2evmc_config)."""
  params = copy.deepcopy(E2E_VMC_DEFAULT_PARAM_DICT)
  for k in set(custom_params) & set(params):
    params[k] = custom_params[k]
  return E2EVMCConfig(**params)


def save_model_config(config: E2EVMCConfig, path: str):
  with open(path, 'w') as fp:
    json.dump(config.asdict(), fp, indent=2, sort_keys=True)


def load_model_config(path: str) -> E2EVMCConfig:
  with open(path) as fp:
    return create_e2evmc_config(json.load(fp))
