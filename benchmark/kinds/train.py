"""The episode trainer with on-device re-render: each step re-renders B
state-only episodes of T steps through the env's renderer (the tile
rasterizer, ``render_chunk`` frames a launch), runs E2E-VMC's encoders in
chunks of windows, the LSTM and the heads, the backward pass and Adam.

Traffic keys: ``episodes`` (B), ``steps`` (T), ``chunk_windows``,
``render_chunk``, ``aug_pad``, ``batches`` (distinct batches the window
cycles through), ``checked_steps`` (the first steps the reference
follows), ``limits``.

Set-up builds one trainer: the program's model, loaded with weights drawn
from the seed on the device, and its optimizer.  It drives the trainer
through its first ``checked_steps`` steps with the window's own call on
distinct batches, then hands the same trainer to the window.  The
reference (a frozen copy of the port's plain path, with the plain twin of
the tile rasterizer) starts from the same weights and batches once the
window has closed and follows those steps.  Numbers:
  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: the worst leaf's gap between the norms of the first
    gradient as Adam got it (its first moment after one step, over
    1 - beta1), against the larger of the reference leaf's norm and the
    median leaf's;
  * ``update_gap``: the same for each leaf's change over the checked
    steps, leaving out leaves whose reference gradient is under
    ``QUIET_LEAF`` of the median leaf's (moved by round-off alone).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..trace import Spans
from . import common
from .common import Cell, free_device_memory, log, set_tf32

FAULTS = ('frozen', 'half')
QUIET_LEAF = 1e-3
BETA1 = 0.9


# ------------------------------------------------------------ inputs


def window_indices(T: int, K: int) -> np.ndarray:
  """[N, K] windows into a T-step episode, the K - 1 first ones padded at
  the start with frame 0 (the trainer's layout)."""
  idx = np.arange(T - K + 1)[:, None] + np.arange(K)[None, :]
  pad = np.maximum(np.arange(-(K - 1), 0)[:, None] +
                   np.arange(K)[None, :], 0)
  return np.concatenate([pad, idx], axis=0)


def scene_start(config: Dict):
  """(qpos [nq], mocap [7], rgba [ngeom, 4]) of the scene as the XML
  states it, with the robot's slides set as the env's set-up sets them:
  read by the benchmark's own copy of the loader."""
  from ..ref.core import mjcf
  from ..ref.core.model import make_state, set_joint_qpos
  from ..ref.envs.base import ASSET_ROOT, MODEL_XML
  xml = os.path.join(ASSET_ROOT, 'envs', MODEL_XML[config['env']['shapes']])
  m, _ = mjcf.load_model(xml)
  st = make_state(m, 1)
  qpos = st.qpos
  for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                    ('robot0:slide2', 0.0)):
    qpos = set_joint_qpos(m, qpos, name, val)
  mocap = torch.cat([st.mocap_pos[0, 0], st.mocap_quat[0, 0]])
  rgba = m.geom_rgba.numpy().copy()
  for g in range(m.ngeom):
    if 'crosshair' in m.geom_name[g]:
      rgba[g, 3] = 0.0
  return (qpos[0].numpy().astype(np.float32),
          mocap.numpy().astype(np.float32), rgba.astype(np.float32))


def make_batches(config: Dict, traffic: Dict, seed: int, device
                 ) -> List[Dict[str, torch.Tensor]]:
  """``batches`` distinct state-only batches of B episodes of T steps,
  drawn from ``seed``: each step's qpos around the scene's start, the
  labels and the augmentation shifts as the trainer's pipeline ships
  them."""
  q0, mocap0, rgba0 = scene_start(config)
  cfg = config['model']
  B, T = int(traffic['episodes']), int(traffic['steps'])
  K, J = cfg['window_size'], cfg['dim_jnt_state']
  widx = window_indices(T, K)
  N = widx.shape[0]
  pad = int(traffic['aug_pad'])
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(int(traffic['batches'])):
    qpos = (q0 + 0.01 * rng.standard_normal((B, T, q0.shape[0]))).astype(
        np.float32)
    mocap = np.broadcast_to(mocap0, (B, T, 7)).copy()
    batch = {
        'widx': widx.astype(np.int64), 'valid': np.ones((N,), bool),
        'jnt_state': rng.standard_normal((B, T, J)),
        'cmd': rng.uniform(-1, 1, (B, N, 4)),
        'vel_target': rng.standard_normal((B, N, J)),
        'ee_target': rng.standard_normal((B, N, 7)),
        'grp_target': rng.random((B, N, 2)),
        'pos_ee': rng.standard_normal((B, N, 3)),
        'pos_obj': rng.standard_normal((B, N, 3)),
        'step': np.broadcast_to(np.arange(N), (B, N)).copy(),
        'qpos': qpos, 'mocap': mocap,
        'rgba': np.broadcast_to(rgba0, (B,) + rgba0.shape).copy(),
        'tgt_qpos': qpos[:, -1], 'tgt_mocap': mocap[:, -1],
        'aug_shift': rng.integers(-pad, pad + 1, (B, 2)),
    }
    out.append({k: torch.as_tensor(
        v.astype(np.float32) if v.dtype == np.float64 else v).to(device)
        for k, v in batch.items()})
  return out


def draw_weights(model: torch.nn.Module, seed: int, device) -> None:
  """Every parameter set from ``seed`` on the device, in one draw: a leaf
  of two or more dimensions normal over sqrt(fan in), a one-dimensional
  ``weight`` (a GroupNorm scale) 1, every other leaf (a bias) 0."""
  named = sorted(model.named_parameters())
  total = sum(p.numel() for _, p in named)
  gen = torch.Generator(device=device).manual_seed(seed)
  flat = torch.randn(total, generator=gen, device=device)
  at = 0
  with torch.no_grad():
    for name, p in named:
      n = p.numel()
      if p.dim() >= 2:
        p.copy_(flat[at:at + n].view_as(p) / math.sqrt(p[0].numel()))
      else:
        p.fill_(1.0 if name.endswith('weight') else 0.0)
      at += n


def _half(batch: Dict[str, torch.Tensor], B: int) -> Dict[str, torch.Tensor]:
  return {k: v[:B // 2] if v.dim() and v.shape[0] == B and
          k not in ('widx', 'valid') else v for k, v in batch.items()}


# ------------------------------------------------------------ the steps


def follow(train_step, ts, batches, n: int, params) -> Dict:
  """``n`` steps of ``train_step`` from ``ts`` on ``batches[:n]``: each
  step's loss, the first gradient's leaf norms as Adam got it, the leaf
  norms of the change over the n steps, and the state."""
  names = [name for name, _ in params()]
  start = [p.detach().clone() for _, p in params()]
  losses, grad = [], None
  for i in range(n):
    ts, m = train_step(ts, batches[i])
    losses.append(float(m['loss']))
    if i == 0:
      state = ts.optimizer.state
      grad = torch.stack([
          torch.linalg.vector_norm(state[p]['exp_avg']) / (1 - BETA1)
          if p in state else torch.zeros((), device=p.device)
          for _, p in params()]).double().cpu()
  change = torch.stack([torch.linalg.vector_norm(p.detach() - p0)
                        for (_, p), p0 in zip(params(), start)]
                       ).double().cpu()
  return {'names': names, 'loss': losses, 'grad': grad, 'change': change,
          'ts': ts}


def compare(side: Dict, truth: Dict) -> Dict[str, float]:
  """The three numbers of ``side`` against ``truth``."""
  if side['names'] != truth['names']:
    raise ValueError('the two models have different parameters')
  loss = max(abs(a - b) / abs(b) for a, b in zip(side['loss'], truth['loss']))
  g, g_ref = side['grad'], truth['grad']
  g_med = float(g_ref.median())
  grad = float(((g - g_ref).abs() / g_ref.clamp(min=g_med)).max())
  moved = g_ref >= QUIET_LEAF * g_med
  d, d_ref = side['change'][moved], truth['change'][moved]
  d_med = float(d_ref.median())
  update = float(((d - d_ref).abs() / d_ref.clamp(min=d_med)).max())
  worst = truth['names'][int(((g - g_ref).abs() /
                              g_ref.clamp(min=g_med)).argmax())]
  log(f'losses {side["loss"]} against {truth["loss"]}; worst gradient leaf '
      f'{worst}; {int((~moved).sum())} leaves left out of the change '
      f'(reference gradient under {QUIET_LEAF:g} of the median leaf)')
  return {'loss_gap': loss, 'grad_gap': grad, 'update_gap': update}


class TrainCell(Cell):
  rate_metric = 'train_steps_per_s'
  span_names = ('train_step', 're-render')

  def __init__(self, config: Dict, traffic: Dict, seed: int,
               device: torch.device, trace: bool,
               fault: Optional[str] = None,
               cache: Optional[dict] = None):
    if fault is not None and fault not in FAULTS:
      raise ValueError(f'unknown fault {fault!r}')
    self.config, self.traffic, self.seed = config, traffic, seed
    self.device, self.trace, self.fault = device, trace, fault
    self.cache = cache
    self.B, self.T = int(traffic['episodes']), int(traffic['steps'])
    self.spans = Spans()

  def _fns(self, train_fns, render_fn, model_config):
    t = self.traffic
    return train_fns(model_config, True,
                     chunk_windows=int(t['chunk_windows']),
                     render_fn=render_fn, aug_pad=int(t['aug_pad']),
                     render_chunk=int(t['render_chunk']), device=self.device)

  def setup(self):
    from geeco_tpu_torch.envs.base import GeecoEnv
    from geeco_tpu_torch.models.params import create_e2evmc_config
    from geeco_tpu_torch.models.train import make_episode_train_fns
    env = common.shared(
        self.cache, ('program', repr(self.config['env'])),
        lambda: GeecoEnv(**self.config['env'], device=self.device))
    render_fn = env.render_from_qpos
    if self.trace:
      render = render_fn

      def render_fn(*args):
        with self.spans('re-render'):
          return render(*args)
    init_fn, train_step, eval_step, _ = self._fns(
        make_episode_train_fns, render_fn,
        create_e2evmc_config(self.config['model']))
    ts = init_fn(torch.Generator().manual_seed(0))
    draw_weights(ts.model, self.seed, self.device)
    self.batches = make_batches(self.config, self.traffic, self.seed,
                                self.device)
    self.train_step = self._faulty(train_step, eval_step)
    self.first = follow(self.train_step, ts, self.batches,
                        int(self.traffic['checked_steps']),
                        ts.model.named_parameters)
    self.ts = self.first.pop('ts')
    self.env = env
    self.i = int(self.traffic['checked_steps'])

  def _faulty(self, train_step, eval_step):
    if self.fault == 'frozen':
      return lambda ts, batch: (ts, eval_step(ts, batch))
    if self.fault == 'half':
      return lambda ts, batch: train_step(ts, _half(batch, self.B))
    return train_step

  def step(self, spans: Spans) -> int:
    self.spans = spans
    batch = self.batches[self.i % len(self.batches)]
    self.i += 1
    with spans('train_step'):
      self.ts, _ = self.train_step(self.ts, batch)
    return 1

  def flops_by_dtype(self) -> Dict[str, float]:
    from ..counts import e2evmc
    return e2evmc.train_step_flops(self.config['model'], self.B, self.T)

  def release(self):
    self.ts = self.train_step = self.env = None
    free_device_memory()

  def _reference(self, tf32: bool) -> Dict:
    from ..ref.core.model import make_state
    from ..ref.envs.base import GeecoEnv as RefEnv
    from ..ref.models.params import create_e2evmc_config
    from ..ref.models.train import make_episode_train_fns
    ref = common.shared(
        self.cache, ('reference', repr(self.config['env'])),
        lambda: RefEnv(**self.config['env'], device=self.device))
    # the frames read qpos and the mocap pose alone: the template's other
    # fields need no settling
    ref._initial_phys = ref.stepper.init_state(make_state(ref.model, 1))
    set_tf32(tf32)
    init_fn, train_step, _, _ = self._fns(
        make_episode_train_fns, ref.render_from_qpos,
        create_e2evmc_config(self.config['model']))
    ts = init_fn(torch.Generator().manual_seed(0))
    draw_weights(ts.model, self.seed, self.device)
    out = follow(train_step, ts, self.batches,
                 int(self.traffic['checked_steps']),
                 ts.model.named_parameters)
    set_tf32(False)
    del out['ts']
    free_device_memory()
    return out

  def readings(self, control: bool = False) -> Dict[str, float]:
    truth = self._reference(tf32=False)
    side = self._reference(tf32=True) if control else self.first
    return compare(side, truth)


def build(config, traffic, seed, device, trace, fault=None, cache=None
          ) -> TrainCell:
  return TrainCell(config, traffic, seed, device, trace, fault, cache)
