"""E2E-VMC visuomotor controller in PyTorch (CNN encoders + LSTM decoder).

Counterpart of ``geeco_tpu/models/e2evmc.py``: an 8-layer conv encoder per
image stream (256^2 -> 2x2xC, GroupNorm before each ReLU), the dynamic-image
preprocessing, state concatenation, a 128-unit LSTM decoder with explicit
carry, FC-128 and the prediction heads; the unconditional ``E2EVMC`` and the
goal-conditioned ``GoalE2EVMC`` with proc_obs in {sequence, dynimg} and
proc_tgt in {constant, residual, dyndiff}.  Both expose the
``window_features`` (conv work, no recurrence) / ``decode`` (LSTM + heads)
split the trainer batches on.

Layout: frames cross the module boundary as the JAX package lays them out
(``[N, K, H, W, C]``, ``[N, H, W, C]``); inside an encoder they are NCHW
views in ``channels_last`` memory.  Convolutions pad as flax's ``'SAME'``
does, which is asymmetric on even inputs with stride 2 (0 before, 1 after).
Features are flattened in (h, w, c) order, the order of the LSTM's input
rows in a flax checkpoint.

Precision, written out (no autocast): with ``compute_dtype='bfloat16'`` the
conv inputs and kernels are bf16, GroupNorm takes its statistics in float32
and returns bf16, and the encoder output is float32; the LSTM, heads and
losses are float32.  A float32 model's convolutions run with cuDNN's TF32
off (``conv_precision``: around the encoder's forward, and around the
backward pass in the trainer), and the process-wide setting is restored
after.

Initialisation follows flax's distributions from an explicit
``torch.Generator``: lecun-normal kernels (truncated at two standard
deviations), zero biases, unit GroupNorm scales, orthogonal recurrent
kernels, and zero head kernels (every prediction is exactly 0 at init).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..utils.device import resolve_device
from .params import E2EVMCConfig

# 8-layer encoder: (filters, stride); 256x256 -> 2x2 (graph.py:76-116)
_ENC_SPEC = ((32, 1), (48, 2), (64, 2), (128, 2), (192, 2), (256, 2),
             (256, 2))  # + final (dim_out, 2)
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
_GN_EPS = 1e-6          # flax nn.GroupNorm's default epsilon
# flax's lecun_normal: truncated normal at +-2 sigma, rescaled to variance
# 1/fan_in (the stddev of a unit normal truncated there)
_TRUNC_STD = 0.87962566103423978

Carry = Tuple[torch.Tensor, torch.Tensor]


def _harmonic(t: int) -> float:
  return float(sum(1.0 / k for k in range(1, t + 1)))


def dynimg_coefficients(K: int, device=None) -> torch.Tensor:
  """alpha_t = 2(T - t + 1) - (T + 1)(H(T) - H(t-1)), t in 1..K
  (reference graph.py:17-28)."""
  return torch.tensor([
      2.0 * (K - t + 1) - (K + 1) * (_harmonic(K) - _harmonic(t - 1))
      for t in range(1, K + 1)], dtype=torch.float32, device=device)


def dynimg(frames: torch.Tensor) -> torch.Tensor:
  """Normalized dynamic image of a frame sequence.

  frames: [N, K, H, W, C] in [0, 1] -> [N, H, W, C] in [0, 1]
  (reference graph.py:30-55).
  """
  K = frames.shape[1]
  w = dynimg_coefficients(K, frames.device).view(1, K, 1, 1, 1)
  dyn = (w * frames).sum(1)
  mn = dyn.amin((1, 2, 3), keepdim=True)
  mx = dyn.amax((1, 2, 3), keepdim=True)
  return (dyn - mn) / (mx - mn + 1e-6)


def _same_pads(n: int, stride: int, k: int = 3) -> Tuple[int, int]:
  """flax/XLA 'SAME' padding of one spatial axis: (before, after)."""
  total = max((-(-n // stride) - 1) * stride + k - n, 0)
  return total // 2, total - total // 2


def _encoded_size(n: int) -> int:
  """Spatial side of an encoder's output for an input side n."""
  for _, s in _ENC_SPEC + ((None, 2),):
    n = -(-n // s)
  return n


@contextlib.contextmanager
def conv_precision(dtype: torch.dtype):
  """Within: cuDNN's TF32 off if ``dtype`` is float32 (a float32 model
  means float32 convolutions), the caller's setting restored after.  The
  flag is read when a convolution runs, so a backward pass needs its own
  scope."""
  if dtype != torch.float32:
    yield
    return
  before = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32 = before


def _group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
  """flax's GroupNorm of an NCHW (channels_last) map, in float32: mean and
  variance as E[x^2] - E[x]^2 clipped at 0 (flax's fast variance, which
  loses digits where a group's spread is small against its mean: a
  two-pass variance differs there by more than rounding), then
  (x - mean) * (rsqrt(var + eps) * scale) + bias."""
  n, c, h, w = x.shape
  g = gn.num_groups
  v = x.float().permute(0, 2, 3, 1).reshape(n, h * w, g, c // g)
  mean = v.mean((1, 3), keepdim=True)
  var = ((v * v).mean((1, 3), keepdim=True) - mean * mean).clamp(min=0.0)
  mul = torch.rsqrt(var + gn.eps) * gn.weight.view(g, c // g)
  y = (v - mean) * mul + gn.bias.view(g, c // g)
  return y.reshape(n, h, w, c).permute(0, 3, 1, 2)


class ConvEncoder(nn.Module):
  """8 conv layers 256x256xC -> [N, 2, 2, dim_out] (float32).

  norm='group' inserts GroupNorm before each ReLU: the reference's raw
  conv+ReLU stack degenerates when rebuilt (see the JAX package's
  ConvEncoder); norm='none' is that raw stack.
  """

  def __init__(self, in_channels: int, dim_out: int = 256,
               dtype: torch.dtype = torch.bfloat16, norm: str = 'group',
               device=None):
    super().__init__()
    if norm not in ('group', 'none'):
      raise ValueError(f'unknown encoder norm {norm!r}')
    self.dtype = dtype
    self.norm = norm
    spec = _ENC_SPEC + ((dim_out, 2),)
    self.strides = tuple(s for _, s in spec)
    c_in = in_channels
    for i, (c, s) in enumerate(spec, 1):
      self.add_module(f'conv{i}', skip_init(nn.Conv2d, c_in, c, 3, stride=s,
                                            device=device))
      if norm == 'group':
        self.add_module(f'gn{i}', skip_init(nn.GroupNorm,
                                            8 if c % 8 == 0 else 1, c,
                                            eps=_GN_EPS, device=device))
      c_in = c

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, h, w, dim_out]."""
    x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
    with conv_precision(self.dtype):
      for i, s in enumerate(self.strides, 1):
        conv = getattr(self, f'conv{i}')
        (top, bottom), (left, right) = (_same_pads(n, s)
                                        for n in x.shape[2:])
        w = conv.weight.to(self.dtype, memory_format=torch.channels_last)
        x = F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                     conv.bias.to(self.dtype), stride=s)
        if self.norm == 'group':
          x = _group_norm(x, getattr(self, f'gn{i}'))
        x = F.relu(x).to(self.dtype, memory_format=torch.channels_last)
    return x.permute(0, 2, 3, 1).float()


def _tile_state(feat: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
  """Tile a state vector over the spatial grid of an NHWC feature map,
  concat channels and flatten in (h, w, c) order (state_concatenation,
  graph.py:123-144)."""
  n, h, w, _ = feat.shape
  st = state[:, None, None, :].expand(n, h, w, state.shape[-1])
  return torch.cat([feat, st], -1).reshape(n, -1)


class LSTMCell(nn.Module):
  """flax.linen.LSTMCell: gates i, f, g, o (sigmoid, sigmoid, tanh,
  sigmoid); the input kernels have no bias, the hidden ones do; the carry is
  (c, h).  The four gates' kernels are stacked in that order."""

  def __init__(self, in_features: int, features: int, device=None):
    super().__init__()
    self.features = features
    self.ih = skip_init(nn.Linear, in_features, 4 * features, bias=False,
                        device=device)
    self.hh = skip_init(nn.Linear, features, 4 * features, device=device)

  def forward(self, carry: Carry, x: torch.Tensor
              ) -> Tuple[Carry, torch.Tensor]:
    c, h = carry
    i, f, g, o = (self.ih(x) + self.hh(h)).chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (c, h), h


def _head_dims(config: E2EVMCConfig) -> Dict[str, int]:
  if config.control_mode == 'cartesian':
    heads = {'pred_cmd_ee': 3, 'logits_cmd_grp': config.num_grp_states}
  elif config.control_mode == 'velocity':
    heads = {'pred_cmd_vel': config.dim_jnt_state, 'pred_cmd_ee': 3,
             'pred_cmd_grp': config.dim_grp_command}
  else:
    raise ValueError(f'unknown control mode {config.control_mode}')
  return dict(heads, pred_aux_ee=3, pred_aux_obj=3)


class LSTMDecoder(nn.Module):
  """LSTM over the per-step feature list + FC + prediction heads."""

  def __init__(self, config: E2EVMCConfig, in_features: int, device=None):
    super().__init__()
    self.config = config
    self.lstm = LSTMCell(in_features, config.dim_h_lstm, device)
    self.fc1 = skip_init(nn.Linear, config.dim_h_lstm, config.dim_h_fc,
                         device=device)
    self.heads = tuple(_head_dims(config).items())
    for name, d in self.heads:
      self.add_module(name, skip_init(nn.Linear, config.dim_h_fc, d,
                                      device=device))

  def forward(self, feat_list: List[torch.Tensor], carry: Optional[Carry],
              reset) -> Tuple[Dict[str, torch.Tensor], Carry]:
    """``reset``: a bool, or a bool tensor of shape [] or [n]; where it is
    true the carry starts from zero."""
    n = feat_list[0].shape[0]
    zero = feat_list[0].new_zeros((n, self.config.dim_h_lstm))
    if carry is None or reset is True:
      carry = (zero, zero)
    elif reset is not False:
      r = torch.as_tensor(reset, device=zero.device).reshape(-1, 1)
      carry = tuple(torch.where(r, zero, c) for c in carry)
    out = None
    for feat in feat_list:
      carry, out = self.lstm(carry, feat)
    net = F.relu(self.fc1(out))
    return {name: getattr(self, name)(net) for name, _ in self.heads}, carry


class E2EVMC(nn.Module):
  """Unconditional reflex (reference e2e_vmc, graph.py:268-319)."""

  def __init__(self, config: E2EVMCConfig, device=None):
    super().__init__()
    self.config = config
    self.enc_obs = self._encoder(config.dim_s_obs, device)
    side = _encoded_size(config.img_height) * _encoded_size(config.img_width)
    self.decoder = LSTMDecoder(
        config, side * (self._feature_channels() + config.dim_jnt_state),
        device)

  def _encoder(self, dim_out: int, device) -> ConvEncoder:
    cfg = self.config
    return ConvEncoder(cfg.img_channels, dim_out, _DTYPES[cfg.compute_dtype],
                       cfg.encoder_norm, device)

  def _feature_channels(self) -> int:
    return self.config.dim_s_obs

  def window_features(self, rgb_frames: torch.Tensor,
                      jnt_states: torch.Tensor):
    """[N, K, H, W, C] frames -> (list of per-step features, extras)."""
    feats = [_tile_state(self.enc_obs(rgb_frames[:, k]), jnt_states[:, k])
             for k in range(self.config.window_size)]
    return feats, {}

  def decode(self, feats, carry, reset):
    return self.decoder(feats, carry, reset)

  def forward(self, rgb_frames, jnt_states, carry=None, reset=True):
    feats, extras = self.window_features(rgb_frames, jnt_states)
    ep, carry = self.decode(feats, carry, reset)
    return dict(extras, **ep), carry


class GoalE2EVMC(E2EVMC):
  """Goal-conditioned reflex (reference goal_e2evmc, graph.py:321-416)."""

  def __init__(self, config: E2EVMCConfig, device=None):
    if config.proc_obs not in ('sequence', 'dynimg'):
      raise ValueError(f'unknown proc_obs {config.proc_obs}')
    if config.proc_tgt not in ('constant', 'residual', 'dyndiff'):
      raise ValueError(f'unknown proc_tgt {config.proc_tgt}')
    if config.proc_obs == 'dynimg' and config.proc_tgt != 'dyndiff':
      # the reference pairs the dynamic image with the dyndiff target only
      raise ValueError("proc_obs='dynimg' needs proc_tgt='dyndiff'")
    super().__init__(config, device)
    if config.proc_obs == 'dynimg':
      self.enc_dyn = self._encoder(config.dim_s_dyn, device)
    if config.proc_tgt == 'dyndiff':
      self.enc_diff = self._encoder(config.dim_s_diff, device)

  def _feature_channels(self) -> int:
    cfg = self.config
    if cfg.proc_obs == 'dynimg':
      return cfg.dim_s_obs + cfg.dim_s_dyn + cfg.dim_s_diff
    return {'constant': 2 * cfg.dim_s_obs, 'residual': cfg.dim_s_obs,
            'dyndiff': cfg.dim_s_obs + cfg.dim_s_diff}[cfg.proc_tgt]

  def window_features(self, rgb_frames, jnt_states, tgt_frame):
    cfg = self.config
    extras: Dict[str, torch.Tensor] = {}
    if cfg.proc_tgt in ('constant', 'residual'):
      tgt_feat = self.enc_obs(tgt_frame)
    feats = []
    if cfg.proc_obs == 'sequence':
      for k in range(cfg.window_size):
        frame = rgb_frames[:, k]
        feat = self.enc_obs(frame)
        if cfg.proc_tgt == 'constant':
          state = torch.cat([feat, tgt_feat], -1)
        elif cfg.proc_tgt == 'residual':
          state = tgt_feat - feat
        else:
          dd = dynimg(torch.stack([frame, tgt_frame], 1))
          extras['dyndiff'] = dd
          state = torch.cat([feat, self.enc_diff(dd)], -1)
        feats.append(_tile_state(state, jnt_states[:, k]))
    else:
      frame = rgb_frames[:, -1]
      feat = self.enc_obs(frame)
      dyn_buff = dynimg(rgb_frames)
      extras['dynbuff'] = dyn_buff
      dyn_diff = dynimg(torch.stack([frame, tgt_frame], 1))
      extras['dyndiff'] = dyn_diff
      # representation_concatenation_v2 (graph.py:169-192)
      feats.append(_tile_state(
          torch.cat([feat, self.enc_dyn(dyn_buff), self.enc_diff(dyn_diff)],
                    -1), jnt_states[:, -1]))
    return feats, extras

  def forward(self, rgb_frames, jnt_states, tgt_frame, carry=None,
              reset=True):
    feats, extras = self.window_features(rgb_frames, jnt_states, tgt_frame)
    heads, carry = self.decode(feats, carry, reset)
    return dict(extras, **heads), carry


@torch.no_grad()
def _init_flax_like(model: E2EVMC, generator: torch.Generator):
  """flax's default initialisers, drawn from ``generator`` (see module
  docstring)."""
  def lecun_normal_(w: torch.Tensor, fan_in: int):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)

  head_names = {name for name, _ in model.decoder.heads}
  for name, mod in model.named_modules():
    leaf = name.rsplit('.', 1)[-1]
    if isinstance(mod, nn.Conv2d):
      lecun_normal_(mod.weight, mod.weight[0].numel())
      nn.init.zeros_(mod.bias)
    elif isinstance(mod, nn.GroupNorm):
      nn.init.ones_(mod.weight)
      nn.init.zeros_(mod.bias)
    elif isinstance(mod, LSTMCell):
      lecun_normal_(mod.ih.weight, mod.ih.in_features)
      for block in mod.hh.weight.split(mod.features):   # hi, hf, hg, ho
        nn.init.orthogonal_(block, generator=generator)
      nn.init.zeros_(mod.hh.bias)
    elif isinstance(mod, nn.Linear) and leaf != 'ih' and leaf != 'hh':
      if leaf in head_names:
        nn.init.zeros_(mod.weight)
      else:
        lecun_normal_(mod.weight, mod.in_features)
      nn.init.zeros_(mod.bias)


def make_model(config: E2EVMCConfig, goal_conditioned: bool, device=None,
               generator: Optional[torch.Generator] = None) -> E2EVMC:
  """A freshly initialised model on ``device`` (default: the card).

  The weights are drawn on the CPU from ``generator`` (a CPU generator; seed
  0 if None), so one seed gives the same model on every device.
  """
  device = resolve_device(device)
  if config.compute_dtype not in _DTYPES:
    raise ValueError(f'unknown compute_dtype {config.compute_dtype!r}')
  model = (GoalE2EVMC if goal_conditioned else E2EVMC)(config, device='cpu')
  _init_flax_like(model, generator if generator is not None
                  else torch.Generator().manual_seed(0))
  return model.to(device)


def init_lstm_carry(config: E2EVMCConfig, batch_size: int,
                    device=None) -> Carry:
  z = torch.zeros((batch_size, config.dim_h_lstm), device=device)
  return z, z.clone()


def count_parameters(model: nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())
