"""Training: losses, Adam train/eval steps (PyTorch).

Counterpart of ``geeco_tpu/models/train.py``, with the loss/metric parity it
keeps with the reference estimator model_fns
(src/models/e2evmc/estimator.py:14-141, 144-279):
  cartesian: loss = mse(cmd_ee) + softmax_ce(cmd_grp in {0,1,2})
             + lambda_aux * (mse(pos_ee) + mse(pos_obj))  (+ L2 reg)
  velocity:  sum of MSEs over cmd_vel/cmd_ee/cmd_grp/pos_ee/pos_obj
  reset flag: any(features['step'] == 0)  (estimator.py:41-42)
  eval: per-head MSE + gripper-command accuracy (estimator.py:108-120)

The optimizer is the JAX package's ``optax.chain(clip_by_global_norm(1.0),
adam(lr))``: gradients scaled by 1/||g|| where the global norm ||g|| is at
least 1, then ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected: optax's update).

Where the JAX package threads parameters through pure functions, a
``TrainState`` here holds the model and its optimizer: ``train_step``
updates them in place and returns the state with its carry and step count
advanced.  Batches are dicts of tensors on the model's device.

Data parallelism (``mesh=``, one process per device, ``parallel/mesh.py``):
the parameters are replicated (``shard_train_state``), each rank takes its
part of the batch (``shard_batch``: the JAX package's rules), and the
gradients are all-reduced to their mean over the ranks before clipping and
Adam, so every rank takes the step the global batch gives: every loss is a
mean over the batch axis with equal parts per rank.  Statistics over the
whole batch are taken over it: the window-mode reset flag, the
``cmd_mag`` weights' normalisation and the collapse canary; the metrics
are averaged over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import mesh as PM
from ..utils import profiling
from ..utils.device import resolve_device
from .e2evmc import conv_precision, init_lstm_carry, make_model
from .params import E2EVMCConfig

_CLIP_NORM = 1.0


@dataclasses.dataclass
class TrainState:
  model: nn.Module
  optimizer: torch.optim.Optimizer
  lstm_carry: Tuple[torch.Tensor, torch.Tensor]
  step: int

  def replace(self, **changes) -> 'TrainState':
    return dataclasses.replace(self, **changes)


def _dummy_batch(config: E2EVMCConfig, goal_conditioned: bool, n: int,
                 device=None):
  H, W = config.img_height, config.img_width
  K = config.window_size
  z = lambda *s: torch.zeros(s, device=device)
  feature = {
      'step': torch.ones((n, K), dtype=torch.int64, device=device),
      'rgb': z(n, K, H, W, 3), 'depth': z(n, K, H, W, 1),
      'jnt_state': z(n, K, config.dim_jnt_state),
      'ee_state': z(n, K, 7), 'obj_state': z(n, K, 7),
  }
  if goal_conditioned:
    feature['target_rgb'] = z(n, H, W, 3)
    feature['target_depth'] = z(n, H, W, 1)
  label = {'cmd': z(n, 4), 'vel_target': z(n, config.dim_jnt_state),
           'ee_target': z(n, 7), 'grp_target': z(n, 2)}
  return feature, label


def _norm_rgb(x: torch.Tensor) -> torch.Tensor:
  """uint8 frames -> [0,1] float (the pipeline ships uint8)."""
  if not x.is_floating_point():
    return x.float() / 255.0
  return x


def obs_frames(config: E2EVMCConfig, feature: Dict) -> torch.Tensor:
  """RGB or RGB-D observation stack (estimator.py:30-39), from dense frames
  ('rgb' [B, K, H, W, 3]) or the deduplicated form ('rgb_frames'
  [F, H, W, 3] uint8 + 'rgb_idx' [B, K])."""
  if 'rgb_idx' in feature:
    rgb = _norm_rgb(feature['rgb_frames'])[feature['rgb_idx']]
  else:
    rgb = _norm_rgb(feature['rgb'])
  if config.img_channels == 3:
    return rgb
  return torch.cat([rgb, feature['depth']], -1)


def tgt_frame(config: E2EVMCConfig, feature: Dict) -> torch.Tensor:
  rgb = _norm_rgb(feature['target_rgb'])
  if 'rgb_idx' in feature and rgb.shape[0] == 1:
    # one shared target frame per (single-episode) batch
    rgb = rgb.expand((feature['rgb_idx'].shape[0],) + rgb.shape[1:])
  if config.img_channels == 3:
    return rgb
  return torch.cat([rgb, feature['target_depth']], -1)


def _softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           n: int) -> torch.Tensor:
  """optax.softmax_cross_entropy against jax.nn.one_hot(labels, n): a label
  outside [0, n) has an all-zero one-hot and costs 0."""
  onehot = (labels[..., None] == torch.arange(n, device=labels.device))
  return -(onehot * torch.log_softmax(logits, -1)).sum(-1)


def _optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
  return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                          eps=1e-8)


def _clip_by_global_norm(model: nn.Module, max_norm: float = _CLIP_NORM):
  """optax.clip_by_global_norm on the gradients, in place: g / ||g|| * max
  where the global norm reaches max_norm (no epsilon)."""
  grads = [p.grad for p in model.parameters() if p.grad is not None]
  norm = torch.linalg.vector_norm(
      torch.stack([torch.linalg.vector_norm(g) for g in grads]))
  scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
  for g in grads:
    g.mul_(scale)


def _l2(model: nn.Module) -> torch.Tensor:
  return sum(p.square().sum() for p in model.parameters())


def _apply_update(ts: TrainState, loss: torch.Tensor, config: E2EVMCConfig,
                  mesh: Optional[PM.Mesh] = None) -> torch.Tensor:
  """Backward, (all-reduce), clip, Adam step; returns the loss with the L2
  term."""
  with profiling.span('train.backward'):
    if config.l2_regularizer > 0:
      loss = loss + config.l2_regularizer * _l2(ts.model)
    ts.optimizer.zero_grad(set_to_none=True)
    with conv_precision(ts.model.enc_obs.dtype):
      loss.backward()
    if mesh is not None and mesh.size > 1:
      _all_reduce_mean_grads(ts.model, mesh)
  with profiling.span('train.update'):
    _clip_by_global_norm(ts.model)
    ts.optimizer.step()
  return loss


def _all_reduce_mean_grads(model: nn.Module, mesh: PM.Mesh):
  """Every gradient replaced by its mean over the ranks, in one flat
  all-reduce."""
  grads = [p.grad for p in model.parameters() if p.grad is not None]
  flat = torch.cat([g.reshape(-1) for g in grads])
  dist.all_reduce(flat)
  flat /= mesh.size
  at = 0
  for g in grads:
    g.copy_(flat[at:at + g.numel()].view_as(g))
    at += g.numel()


def _mean_over_ranks(metrics: Dict[str, torch.Tensor],
                     mesh: Optional[PM.Mesh]) -> Dict[str, torch.Tensor]:
  """Scalar metrics averaged over the ranks (each a mean over an equal
  part of the batch); the canary is already taken over the whole batch."""
  if mesh is None or mesh.size == 1:
    return metrics
  keys = [k for k in metrics if k != 'canary_std']
  vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
  dist.all_reduce(vals)
  out = dict(metrics)
  out.update(zip(keys, vals / mesh.size))
  return out


def _init_fn(config: E2EVMCConfig, goal_conditioned: bool, device):
  def init_fn(generator: Optional[torch.Generator] = None,
              batch_size: Optional[int] = None) -> TrainState:
    """A fresh model (weights from the CPU ``generator``), its optimizer and
    a zero carry for ``batch_size`` rows."""
    model = make_model(config, goal_conditioned, device, generator)
    return TrainState(
        model=model, optimizer=_optimizer(model, config.lr),
        lstm_carry=init_lstm_carry(config, batch_size or config.batch_size,
                                   device),
        step=0)
  return init_fn


def make_train_fns(config: E2EVMCConfig, goal_conditioned: bool,
                   device=None, mesh: Optional[PM.Mesh] = None):
  """Returns (init_fn, train_step, eval_step, apply) on ``device`` (default:
  the card); with ``mesh``, the steps of one rank of a data-parallel run
  (its shard of the batch and of the carry)."""
  device = resolve_device(device)

  def apply(model, feature, carry, reset):
    frames = obs_frames(config, feature)
    jnt = feature['jnt_state']
    if goal_conditioned:
      return model(frames, jnt, tgt_frame(config, feature), carry, reset)
    return model(frames, jnt, carry, reset)

  def targets_of(feature, label):
    if config.control_mode == 'cartesian':
      return {
          'cmd_ee': label['cmd'][:, :3],
          'cmd_grp': torch.round(label['cmd'][:, 3]).long() + 1,
          'pos_ee': feature['ee_state'][:, -1, :3],
          'pos_obj': feature['obj_state'][:, -1, :3],
      }
    return {
        'cmd_vel': label['vel_target'],
        'cmd_ee': label['ee_target'][:, :3],
        'cmd_grp': label['grp_target'],
        'pos_ee': feature['ee_state'][:, -1, :3],
        'pos_obj': feature['obj_state'][:, -1, :3],
    }

  def loss_of(ep, tgt):
    mse = lambda a, b: (a - b).square().mean()
    parts = {}
    if config.control_mode == 'cartesian':
      parts['loss_cmd_ee'] = mse(ep['pred_cmd_ee'], tgt['cmd_ee'])
      parts['loss_cmd_grp'] = _softmax_cross_entropy(
          ep['logits_cmd_grp'], tgt['cmd_grp'], config.num_grp_states).mean()
      parts['loss_pos_ee'] = mse(ep['pred_aux_ee'], tgt['pos_ee'])
      parts['loss_pos_obj'] = mse(ep['pred_aux_obj'], tgt['pos_obj'])
      loss = (parts['loss_cmd_ee'] + parts['loss_cmd_grp'] +
              config.lambda_aux * (parts['loss_pos_ee'] +
                                   parts['loss_pos_obj']))
    else:
      parts['loss_cmd_vel'] = mse(ep['pred_cmd_vel'], tgt['cmd_vel'])
      parts['loss_cmd_ee'] = mse(ep['pred_cmd_ee'], tgt['cmd_ee'])
      parts['loss_cmd_grp'] = mse(ep['pred_cmd_grp'], tgt['cmd_grp'])
      parts['loss_pos_ee'] = mse(ep['pred_aux_ee'], tgt['pos_ee'])
      parts['loss_pos_obj'] = mse(ep['pred_aux_obj'], tgt['pos_obj'])
      loss = sum(parts.values())
    return loss, parts

  def _reset_flag(step):
    # the window contains the episode start (estimator.py:41-42 uses
    # prod(step)==0; any(step==0) is the same predicate without overflow),
    # anywhere in the global batch
    flag = (step == 0).any()
    if mesh is None or mesh.size == 1:
      return flag
    return torch.tensor(PM.any_rank(bool(flag), mesh), device=step.device)

  def train_step(ts: TrainState, feature: Dict, label: Dict
                 ) -> Tuple[TrainState, Dict]:
    reset = _reset_flag(feature['step'])
    ep, carry = apply(ts.model, feature, ts.lstm_carry, reset)
    loss, parts = loss_of(ep, targets_of(feature, label))
    loss = _apply_update(ts, loss, config, mesh)
    metrics = {k: v.detach() for k, v in dict(parts, loss=loss).items()}
    return ts.replace(lstm_carry=tuple(c.detach() for c in carry),
                      step=ts.step + 1), _mean_over_ranks(metrics, mesh)

  @torch.no_grad()
  def eval_step(ts: TrainState, feature: Dict, label: Dict) -> Dict:
    reset = _reset_flag(feature['step'])
    ep, _ = apply(ts.model, feature, ts.lstm_carry, reset)
    tgt = targets_of(feature, label)
    loss, parts = loss_of(ep, tgt)
    metrics = dict(parts, loss=loss)
    mse = lambda a, b: (a - b).square().mean()
    metrics['mse_cmd_ee'] = mse(ep['pred_cmd_ee'], tgt['cmd_ee'])
    metrics['mse_pos_ee'] = mse(ep['pred_aux_ee'], tgt['pos_ee'])
    metrics['mse_pos_obj'] = mse(ep['pred_aux_obj'], tgt['pos_obj'])
    if config.control_mode == 'cartesian':
      pred = ep['logits_cmd_grp'].argmax(-1)
      metrics['acc_cmd_grp'] = (pred == tgt['cmd_grp']).float().mean()
    return _mean_over_ranks(metrics, mesh)

  return (_init_fn(config, goal_conditioned, device), train_step, eval_step,
          apply)


# ------------------------------------------------------- episode-scan path


def _shift_frames(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                  s: int) -> torch.Tensor:
  """Edge-padded translation of img [B, ..., H, W, C] by (dy, dx) [B] each:
  the JAX package's pad-by-s (mode 'edge') then ``lax.dynamic_slice`` at
  (s + dy, s + dx).  That slice counts a negative start from the end of the
  padded axis, then clamps the start to [0, 2s]; the edge-padded frame read
  from row start + i is the frame's row clamp(start - s + i, 0, H - 1), so
  this gathers that row and column."""
  B, H, W, C = img.shape[0], img.shape[-3], img.shape[-2], img.shape[-1]
  x = img.reshape(B, -1, H, W, C)
  L = x.shape[1]

  def idx(d, n):
    start = s + d.to(img.device)
    start = torch.where(start < 0, start + n + 2 * s, start).clamp(0, 2 * s)
    return (torch.arange(n, device=img.device) + (start - s)[:, None]
            ).clamp(0, n - 1)

  x = torch.gather(x, 2, idx(dy, H)[:, None, :, None, None].expand(
      B, L, H, W, C))
  x = torch.gather(x, 3, idx(dx, W)[:, None, None, :, None].expand(
      B, L, H, W, C))
  return x.reshape(img.shape)


def make_episode_train_fns(config: E2EVMCConfig, goal_conditioned: bool,
                           chunk_windows: int = 8,
                           render_fn: Optional[Callable] = None,
                           aug_pad: int = 0, render_chunk: int = 100,
                           device=None, mesh: Optional[PM.Mesh] = None):
  """Train/eval steps over whole-episode batches (see the JAX package's
  ``make_episode_train_fns`` for why a batch is B whole episodes).

  Every window's conv encoding is independent of the LSTM carry, so the
  encoders run in chunks of ``chunk_windows`` windows x B episodes, each
  chunk recomputed in the backward pass (activation checkpointing) instead
  of stored; only the LSTM runs over the window sequence.

  Batch layout (dict of tensors on ``device``):
    frames       [B, F, H, W, 3] uint8   (or the state-only keys below)
    depth        [B, F, H, W, 1] f32     (img_channels == 4 only)
    target_rgb   [B, H, W, 3]   uint8    (goal-conditioned only)
    target_depth [B, H, W, 1]   f32      (goal + rgbd only)
    jnt_state    [B, F, J]      f32
    widx         [N, K] int64            (shared window index matrix)
    valid        [N] bool                (False on chunk padding rows)
    labels: cmd [B,N,4] vel_target [B,N,J] ee_target [B,N,7]
            grp_target [B,N,2] pos_ee [B,N,3] pos_obj [B,N,3]
  State-only batches carry qpos [B, T, nq], mocap [B, T, 7], rgba
  [B, ngeom, 4], tgt_qpos/tgt_mocap [B, ...] (goal-conditioned) and
  optionally aug_shift [B, 2] instead of the frames; ``render_fn`` (e.g.
  ``env.render_from_qpos``, batched: [n, ...] -> (rgb [n, H, W, 3], depth))
  re-renders them, ``render_chunk`` frames a call.

  With ``mesh``, the steps of one rank of a data-parallel run: its shard of
  the episodes (``shard_batch``), ``widx``/``valid`` whole.

  Returns (init_fn, train_step, eval_step, make_optimizer).
  """
  device = resolve_device(device)
  C = chunk_windows

  @torch.no_grad()
  def _materialize_frames(batch: Dict) -> Dict:
    """State-only batches -> frame batches, on the device: the recorded
    trajectory re-rendered by the renderer that made (or would make) the
    frame-mode dataset."""
    if 'qpos' not in batch:
      return batch
    if render_fn is None:
      raise ValueError('state-only dataset batches need make_episode_train_'
                       'fns(render_fn=env.render_from_qpos)')
    b = dict(batch)
    qpos, mocap, rgba = b.pop('qpos'), b.pop('mocap'), b.pop('rgba')
    B, T = qpos.shape[:2]
    n = B * T
    flat_q = qpos.reshape(n, -1)
    flat_m = mocap.reshape(n, -1)
    flat_r = rgba.repeat_interleave(T, 0)
    CH = min(render_chunk, n)
    n_pad = (-n) % CH
    if n_pad:
      # clamped index pad (works even when n_pad > n, e.g. tiny tests)
      idx = torch.arange(n + n_pad, device=qpos.device).clamp(max=n - 1)
      flat_q, flat_m, flat_r = flat_q[idx], flat_m[idx], flat_r[idx]
    frames = torch.cat([render_fn(flat_q[i:i + CH], flat_m[i:i + CH],
                                  flat_r[i:i + CH])[0]
                        for i in range(0, n + n_pad, CH)])
    frames = frames[:n].reshape((B, T) + frames.shape[1:])
    tgt = None
    if 'tgt_qpos' in b:
      tgt, _ = render_fn(b.pop('tgt_qpos'), b.pop('tgt_mocap'), rgba)
    if 'aug_shift' in b:
      sh = b.pop('aug_shift')
      if aug_pad <= 0:
        # the JAX slice clamps out-of-range starts, so an aug_shift batch fed
        # to fns built with aug_pad=0 would silently truncate the shifts
        raise ValueError(
            'batch carries aug_shift offsets but make_episode_train_fns '
            'was built with aug_pad=0; pass aug_pad >= the pipeline\'s '
            'aug_shift so _shift_frames has real padding to slide over')
      s = max(aug_pad, 1)
      frames = _shift_frames(frames, sh[:, 0], sh[:, 1], s)
      if tgt is not None:
        tgt = _shift_frames(tgt, sh[:, 0], sh[:, 1], s)
    b['frames'] = frames
    if tgt is not None:
      b['target_rgb'] = tgt
    return b

  def _frames_of(batch, idx):
    """Window frames [B, n, K, H, W, C] in [0,1] float."""
    rgb = _norm_rgb(batch['frames'][:, idx])
    if config.img_channels == 4:
      return torch.cat([rgb, batch['depth'][:, idx]], -1)
    return rgb

  def _tgt_of(batch):
    rgb = _norm_rgb(batch['target_rgb'])
    if config.img_channels == 4:
      return torch.cat([rgb, batch['target_depth']], -1)
    return rgb

  def _window_feats(model, batch):
    """All window features, chunked: -> [N_pad, L, B, D] f32."""
    B = batch['frames'].shape[0]
    widx = batch['widx']
    N, K = widx.shape
    n_pad = (-N) % C
    if n_pad:
      widx = torch.cat([widx, widx[-1:].expand(n_pad, K)])
    tgt = _tgt_of(batch) if goal_conditioned else None

    def chunk_fn(idxc):  # [C, K] -> [C, L, B, D]
      win = _frames_of(batch, idxc)          # [B, C, K, H, W, ch]
      jnt = batch['jnt_state'][:, idxc]      # [B, C, K, J]
      win = win.transpose(0, 1).reshape((C * B,) + win.shape[2:])
      jnt = jnt.transpose(0, 1).reshape(C * B, K, -1)
      if goal_conditioned:
        tgt_b = tgt[None].expand((C,) + tgt.shape).reshape(
            (C * B,) + tgt.shape[1:])
        feats, _ = model.window_features(win, jnt, tgt_b)
      else:
        feats, _ = model.window_features(win, jnt)
      out = torch.stack(feats)               # [L, C*B, D]
      return out.reshape(out.shape[0], C, B, -1).transpose(0, 1)

    chunks = widx.reshape(-1, C, K)
    if torch.is_grad_enabled():   # recompute each chunk in the backward pass
      feats = [checkpoint(chunk_fn, c, use_reentrant=False,
                          preserve_rng_state=False) for c in chunks]
    else:
      feats = [chunk_fn(c) for c in chunks]
    return torch.cat(feats)                  # [N_pad, L, B, D]

  def _decode_all(model, feats_n):
    """Decode all windows. feats_n [N, L, B, D] -> dict of [N, B, ...].

    train_carry='stateless': a fresh zero carry per window, so all N*B
    windows decode in one batched pass.  'bptt': the LSTM runs over the
    window sequence with its carry (serving must use persistent carry).
    """
    N, L, B, D = feats_n.shape
    if config.train_carry == 'stateless':
      flat = feats_n.transpose(0, 1).reshape(L, N * B, D)
      ep, _ = model.decode(list(flat), None, True)
      return {k: v.reshape((N, B) + v.shape[1:]) for k, v in ep.items()}
    carry = init_lstm_carry(config, B, feats_n.device)
    eps = []
    for t in range(N):
      ep, carry = model.decode(list(feats_n[t]), carry, False)
      eps.append(ep)
    return {k: torch.stack([ep[k] for ep in eps]) for k in eps[0]}

  def _masked_mean(x, mask, w=None):
    # x [N, B, ...], mask [N], w optional per-sample weights [N, B] or
    # [N, 1]; the denominator counts every element of the masked rows
    m = mask.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    if w is not None:  # w is renormalized to masked mean 1
      m = m * w.reshape(w.shape + (1,) * (x.ndim - 2))
    return (x * m).sum() / (mask.sum() * float(np.prod(x.shape[1:])))

  def _window_weights(batch, mask, pad):
    """Per-window command-loss weights [N_pad, B] or [N_pad, 1]
    (config.loss_weighting, config.start_boost), renormalized to masked
    per-element mean 1."""
    boost = config.start_boost
    if config.loss_weighting == 'none' and boost == 1.0:
      return None
    if config.loss_weighting not in ('none', 'cmd_mag'):
      raise ValueError(f'unknown loss_weighting {config.loss_weighting!r}')

    def wmean(a, m):
      # masked PER-ELEMENT mean: the mask broadcast to a's shape is counted
      # (counting only the masked rows would inflate the mean by B), over
      # the global batch
      a_b, m_b = torch.broadcast_tensors(a, m)
      sums = torch.stack([(a_b * m_b).sum(), m_b.sum()])
      if mesh is not None and mesh.size > 1:
        dist.all_reduce(sums)       # labels only: no gradient flows here
      return sums[0] / sums[1].clamp(min=1.0)

    m = mask.float()[:, None]
    if config.loss_weighting == 'cmd_mag':
      cmd = pad(batch['cmd'].transpose(0, 1))              # [N_pad, B, 4]
      mag = (torch.linalg.vector_norm(cmd[..., :3], dim=-1) +
             cmd[..., 3].abs())                            # [N_pad, B]
      w = torch.clamp(mag / wmean(mag, m).clamp(min=1e-8), 0.25, 4.0)
    else:
      w = torch.ones(mask.shape + (1,), device=mask.device)
    if boost != 1.0:
      # the first start_boost_windows windows of the episode: the K-1
      # padded starts and the early near-static ones (params.py)
      idx = torch.arange(mask.shape[0], device=mask.device)[:, None]
      w = w * torch.where(idx < config.start_boost_windows, boost, 1.0)
    return w / wmean(w, m).clamp(min=1e-8)

  def _loss_all(ep, batch):
    """Per-part masked losses over [N_pad, B, ...] predictions."""
    N = batch['widx'].shape[0]
    n_pad = (-N) % C
    mask = batch['valid']
    if n_pad:
      mask = torch.cat([mask, mask.new_zeros((n_pad,))])
      pad = lambda x: torch.cat([x, x.new_zeros((n_pad,) + x.shape[1:])])
    else:
      pad = lambda x: x
    lbl = lambda k: batch[k].transpose(0, 1)   # [B,N,...] -> [N,B,...]
    mse = lambda a, b: _masked_mean((a - pad(b)).square(), mask)
    # command losses optionally re-weighted toward large-action windows
    w = _window_weights(batch, mask, pad)
    msew = lambda a, b: _masked_mean((a - pad(b)).square(), mask, w)
    parts = {}
    if config.control_mode == 'cartesian':
      cmd = lbl('cmd')
      parts['loss_cmd_ee'] = msew(ep['pred_cmd_ee'], cmd[..., :3])
      grp = torch.round(pad(cmd)[..., 3]).long() + 1
      ce = _softmax_cross_entropy(ep['logits_cmd_grp'], grp,
                                  config.num_grp_states)        # [N, B]
      parts['loss_cmd_grp'] = _masked_mean(ce, mask, w)
      parts['loss_pos_ee'] = mse(ep['pred_aux_ee'], lbl('pos_ee'))
      parts['loss_pos_obj'] = mse(ep['pred_aux_obj'], lbl('pos_obj'))
      loss = (parts['loss_cmd_ee'] + parts['loss_cmd_grp'] +
              config.lambda_aux * (parts['loss_pos_ee'] +
                                   parts['loss_pos_obj']))
      acc = (ep['logits_cmd_grp'].argmax(-1) == grp).float()
      parts['acc_cmd_grp'] = _masked_mean(acc, mask)
    else:
      parts['loss_cmd_vel'] = msew(ep['pred_cmd_vel'], lbl('vel_target'))
      parts['loss_cmd_ee'] = msew(ep['pred_cmd_ee'],
                                  lbl('ee_target')[..., :3])
      parts['loss_cmd_grp'] = msew(ep['pred_cmd_grp'], lbl('grp_target'))
      parts['loss_pos_ee'] = mse(ep['pred_aux_ee'], lbl('pos_ee'))
      parts['loss_pos_obj'] = mse(ep['pred_aux_obj'], lbl('pos_obj'))
      loss = sum(v for k, v in parts.items() if k.startswith('loss_'))
    # collapse canary: a healthy policy's commands vary across windows;
    # batch-std ~0 on every head = dead constant predictor
    pred = ep['pred_cmd_ee']
    if mesh is not None and mesh.size > 1:    # [N, B, 3]: gather along B
      pred = PM.all_gather_rows(pred.detach().transpose(0, 1).contiguous(),
                                mesh).transpose(0, 1)
    parts['canary_std'] = pred.std(correction=0)
    # start-basin diagnostics: cmd_ee quality on the first
    # start_boost_windows windows (padded starts + early near-static)
    cmd_ee = (pad(lbl('cmd'))[..., :3] if config.control_mode == 'cartesian'
              else pad(lbl('ee_target'))[..., :3])
    start = (torch.arange(mask.shape[0], device=mask.device) <
             config.start_boost_windows) & mask            # [N_pad]
    parts['mse_cmd_ee_start'] = _masked_mean(
        (ep['pred_cmd_ee'] - cmd_ee).square(), start)
    dot = (ep['pred_cmd_ee'] * cmd_ee).sum(-1)
    denom = (torch.linalg.vector_norm(ep['pred_cmd_ee'], dim=-1) *
             torch.linalg.vector_norm(cmd_ee, dim=-1) + 1e-8)
    parts['cos_cmd_ee_start'] = _masked_mean(dot / denom, start)
    return loss, parts

  def _forward_loss(model, batch):
    feats = _window_feats(model, batch)
    ep = _decode_all(model, feats)
    return _loss_all(ep, batch)

  def train_step(ts: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
    with profiling.span('train.rerender'):
      batch = _materialize_frames(batch)
    with profiling.span('train.forward'):
      loss, parts = _forward_loss(ts.model, batch)
    loss = _apply_update(ts, loss, config, mesh)
    metrics = {k: v.detach() for k, v in dict(parts, loss=loss).items()}
    return ts.replace(step=ts.step + 1), _mean_over_ranks(metrics, mesh)

  @torch.no_grad()
  def eval_step(ts: TrainState, batch: Dict) -> Dict:
    loss, parts = _forward_loss(ts.model, _materialize_frames(batch))
    if config.l2_regularizer > 0:
      loss = loss + config.l2_regularizer * _l2(ts.model)
    return _mean_over_ranks(dict(parts, loss=loss), mesh)

  return (_init_fn(config, goal_conditioned, device), train_step, eval_step,
          lambda model: _optimizer(model, config.lr))


# ---------------------------------------------------------------- sharding


def shard_train_state(ts: TrainState, mesh: PM.Mesh) -> TrainState:
  """Parameters replicated (rank 0's broadcast to every rank, so that all
  ranks start equal), the LSTM carry, which is batch-indexed, cut to the
  rank's rows."""
  if mesh.size > 1:
    with torch.no_grad():
      for t in list(ts.model.parameters()) + list(ts.model.buffers()):
        dist.broadcast(t, src=0)
  return ts.replace(lstm_carry=PM.shard_env_batch(ts.lstm_carry, mesh))


# Features that are shared across the batch rather than batch-indexed:
# 'rgb_frames' is the deduplicated frame slab ([F, H, W, 3], F = B+K-1),
# 'target_rgb'/'target_depth' may be a single shared goal frame ([1, ...]),
# 'widx'/'valid' are the shared window-index matrix of the episode-scan
# batch layout (make_episode_train_fns).
_REPLICATED_FEATURES = frozenset({'rgb_frames', 'widx', 'valid'})


def shard_batch(batch: Dict, mesh: PM.Mesh) -> Dict:
  """The rank's part of a batch dict (numpy arrays or tensors, as given):
  shared features and scalars whole, every other leaf its rows.  (The JAX
  package's ``shard_batch`` also places the parts on the devices; here the
  caller moves them, as ``utils/device.to_device`` does.)"""
  out = {}
  for key, x in batch.items():
    if isinstance(x, dict):
      out[key] = shard_batch(x, mesh)
      continue
    shared = (key in _REPLICATED_FEATURES or
              (key in ('target_rgb', 'target_depth') and x.shape[0] == 1))
    if shared or x.ndim == 0:
      out[key] = x
      continue
    if x.shape[0] % mesh.size != 0:
      raise ValueError(
          f'batch leaf {key!r} has leading dim {x.shape[0]} not divisible '
          f'by the {mesh.size}-device data axis')
    out[key] = x[mesh.rows(x.shape[0])]
  return out
