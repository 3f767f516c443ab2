"""Operations of one E2E-VMC train step, from the configuration's widths.

Counted per window (operations = 2 x multiply-adds):
  * ``convs``: each encoder's eight 3x3 convolutions (the widths of
    ``ENCODER``, then ``dim_out``), 'SAME' padding, on the image's side;
    three encoders a window with ``proc_obs='dynimg'`` (the last frame, the
    dynamic image of the window, the dynamic difference with the goal);
    run in the configuration's ``compute_dtype``;
  * ``dynamic_images``: the window's dynamic image (K frames) and the goal
    difference (2 frames), a multiply-add a pixel and channel of each frame;
  * ``lstm``: one LSTM step on the tiled features (input kernel 4h x in,
    hidden kernel 4h x h);
  * ``heads``: FC-h and the prediction heads.
A train step is forward + backward: 3 x the forward's operations (the
backward takes two products a forward one).  The windows counted are the
episode's real ones (B episodes x T windows, the first K - 1 padded at the
start as the trainer's windows are); padding windows added to fill the
last chunk, recomputation in the backward pass, GroupNorm and the other
elementwise work are not counted.
"""

from __future__ import annotations

from typing import Dict

ENCODER = ((32, 1), (48, 2), (64, 2), (128, 2), (192, 2), (256, 2),
           (256, 2))
KERNEL = 3
TRAIN_FACTOR = 3


def _side_out(n: int, stride: int) -> int:
  return -(-n // stride)


def encoder_flops(side: int, in_channels: int, dim_out: int) -> float:
  """One encoder's convolutions on one side x side image."""
  total, c_in, n = 0.0, in_channels, side
  for c_out, s in ENCODER + ((dim_out, 2),):
    n = _side_out(n, s)
    total += 2.0 * KERNEL * KERNEL * c_in * c_out * n * n
    c_in = c_out
  return total


def encoded_side(side: int) -> int:
  for _, s in ENCODER + ((None, 2),):
    side = _side_out(side, s)
  return side


def window_terms(cfg: Dict) -> Dict[str, float]:
  """Forward operations of one window, by term, and the dtype of each."""
  side = cfg['img_height']
  if cfg['img_width'] != side:
    raise ValueError('the count takes square frames')
  ch, K = cfg['img_channels'], cfg['window_size']
  dims = (cfg['dim_s_obs'], cfg['dim_s_dyn'], cfg['dim_s_diff'])
  convs = sum(encoder_flops(side, ch, d) for d in dims)
  pixels = side * side * ch
  dyn = 2.0 * pixels * (K + 2)
  h = cfg['dim_h_lstm']
  in_features = encoded_side(side) ** 2 * (sum(dims) + cfg['dim_jnt_state'])
  lstm = 2.0 * 4 * h * (in_features + h)
  n_heads = 3 + cfg['num_grp_states'] + 3 + 3
  heads = 2.0 * (h * cfg['dim_h_fc'] + cfg['dim_h_fc'] * n_heads)
  return {'convs': convs, 'dynamic_images': dyn, 'lstm': lstm,
          'heads': heads}


def train_step_flops(cfg: Dict, episodes: int, steps: int) -> Dict[str, float]:
  """Operations of one train step by precision: {dtype: operations}."""
  if cfg['proc_obs'] != 'dynimg' or cfg['control_mode'] != 'cartesian':
    raise ValueError('the count covers the dynimg/dyndiff cartesian model')
  terms = window_terms(cfg)
  windows = episodes * steps
  conv_dtype = cfg['compute_dtype']
  rest = sum(v for k, v in terms.items() if k != 'convs')
  out = {conv_dtype: TRAIN_FACTOR * windows * terms['convs']}
  out['float32'] = out.get('float32', 0.0) + TRAIN_FACTOR * windows * rest
  return out

