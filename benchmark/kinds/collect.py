"""Expert collection: each step the scripted expert picks the action, the
record function renders the frame (one launch of the tile rasterizer) and
``env.step`` runs the control step's physics, over B envs on the device.

Traffic keys: ``batch`` (envs), ``warmup_steps``, ``with_frames``,
``with_depth``, ``with_state``, ``check_steps`` (window steps compared with
the reference, drawn from the seed), ``limits``.

The comparison follows the program step by step: the physics is chaotic
(a rounding in one substep grows to millimetres within a few control steps
in some envs), so the reference takes the program's state before each
sampled step and computes, from it, the expert's action, the frame and the
state after the step; each is compared with what the program produced in
the window.  Numbers:
  * ``action_gap``: the largest gap of an action component (any env);
  * ``frame_mismatch``: the share of pixels whose colour or depth differs
    from the reference's;
  * ``state_gap``: the 75th percentile over envs of an env's largest gap
    in qpos after the step (a few envs amplify rounding; half of the envs
    left unstepped reads as a full step).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from ..trace import Spans
from . import common
from .common import (Cell, Reservoir, convert, free_device_memory, log,
                     set_tf32)

FAULTS = ('frozen', 'half', 'altered')


@contextlib.contextmanager
def lower_precision(ref, on: bool):
  """Within, with ``on``: the reference in the precision below the
  configuration's float32 with TF32 off: its matmuls (the physics') in
  TF32, and the kinematics that the expert and the renderer read rounded
  to bfloat16 (they take no matmul).  Without: float32, TF32 off."""
  set_tf32(on)
  if on:
    kin = ref.kin

    def kin_bf16(es):
      k = kin(es)
      return dataclasses.replace(k, **{
          f.name: getattr(k, f.name).to(torch.bfloat16).float()
          for f in dataclasses.fields(k)})
    ref.kin = kin_bf16
  try:
    yield
  finally:
    if on:
      del ref.kin
    set_tf32(False)


class CollectCell(Cell):
  rate_metric = 'env_steps_per_s'
  span_names = ('expert', 'render', 'physics')

  def __init__(self, config: Dict, traffic: Dict, seed: int,
               device: torch.device, trace: bool,
               fault: Optional[str] = None,
               cache: Optional[dict] = None):
    if fault is not None and fault not in FAULTS:
      raise ValueError(f'unknown fault {fault!r}')
    self.config, self.traffic, self.seed = config, traffic, seed
    self.device, self.trace, self.fault = device, trace, fault
    self.cache = cache
    self.batch = int(traffic['batch'])
    self.spans = Spans()

  # ------------------------------------------------------------ program

  def setup(self):
    from geeco_tpu_torch.data.episode import make_record_fn
    from geeco_tpu_torch.envs.base import GeecoEnv
    from geeco_tpu_torch.expert.policies import init_expert_state, make_expert
    env = common.shared(
        self.cache, ('program', repr(self.config['env'])),
        lambda: GeecoEnv(**self.config['env'], device=self.device))
    if self.trace:
      render = env.render
      env.render = lambda *a, **k: self._spanned('render', render, a, k)
    env.setup()
    self.es = env.reset_random(self.batch,
                               torch.Generator().manual_seed(self.seed))
    self.xs = init_expert_state(self.batch, self.device)
    self.env, self.expert = env, make_expert(env)
    t = self.traffic
    self.record = make_record_fn(env, with_frames=t['with_frames'],
                                 with_depth=t['with_depth'],
                                 with_state=t['with_state'])
    self.env_step = self._faulty_step if self.fault else env.step
    for _ in range(int(t['warmup_steps'])):
      self._advance(Spans())
    self.samples = Reservoir(int(t['check_steps']), self.seed)

  def _spanned(self, name, fn, args, kwargs):
    with self.spans(name):
      return fn(*args, **kwargs)

  def _faulty_step(self, es, action):
    """env.step with the fault this cell was built with."""
    if self.fault == 'frozen':
      return es
    out = self.env.step(es, action)
    if self.fault == 'half':           # the second half of the envs stays
      h = self.batch // 2
      phys = dataclasses.replace(out.phys, **{
          f.name: torch.cat([getattr(out.phys, f.name)[:h],
                             getattr(es.phys, f.name)[h:]])
          for f in dataclasses.fields(out.phys)
          if getattr(out.phys, f.name) is not None
          and getattr(out.phys, f.name).dim() > 0
          and getattr(out.phys, f.name).shape[0] == self.batch})
      out = out.replace(phys=phys)
    return out

  def _advance(self, spans: Spans):
    self.spans = spans
    es, xs = self.es, self.xs
    with spans('expert'):
      action, xs_next = self.expert(es, xs)
    rec = self.record(self.env, es, action, xs_next)
    if self.fault == 'altered' and 'rgb' in rec:
      rec['rgb'] = rec['rgb'].clone()
      rec['rgb'][0] += 1               # one env's frame, where it is made
    with spans('physics'):
      es_next = self.env_step(es, action)
    self.es, self.xs = es_next, xs_next
    return es, xs, action, rec, es_next

  def step(self, spans: Spans) -> int:
    slot = self.samples.wants()
    pre, xs, action, rec, post = self._advance(spans)
    if slot is not None:
      self.samples.put(slot, dict(pre=pre, xs=xs, action=action,
                                  rgb=rec.get('rgb'), depth=rec.get('depth'),
                                  post=post))
    return self.batch

  def flops_by_dtype(self) -> Dict[str, float]:
    from ..counts import physics
    return {'float32': physics.control_step_flops(self.config['shapes'],
                                                  self.batch)}

  def release(self):
    self.es = self.xs = self.env = self.expert = self.record = None
    self.env_step = None
    free_device_memory()

  # ------------------------------------------------------------ reference

  def _reference(self):
    from ..ref.envs.base import GeecoEnv as RefEnv
    from ..ref.expert.policies import make_expert as ref_make_expert
    ref = common.shared(
        self.cache, ('reference', repr(self.config['env'])),
        lambda: RefEnv(**self.config['env'], device=self.device))
    return ref, ref_make_expert(ref)

  def _answers(self, ref, ref_expert, sample, control: bool):
    """The reference's action, frame and next state from the sample's
    state before the step; ``control``: computed in the precision below
    the configuration's (``lower_precision``)."""
    from ..ref.core.model import State
    from ..ref.envs.base import EnvState
    from ..ref.expert.policies import ExpertState
    pre = sample['pre']
    fields = {f.name: getattr(pre, f.name) for f in dataclasses.fields(pre)}
    es = EnvState(**dict(fields, phys=convert(pre.phys, State)))
    with lower_precision(ref, control):
      action, _ = ref_expert(es, convert(sample['xs'], ExpertState))
      out = {'action': action}
      if sample['rgb'] is not None:
        out['rgb'], depth = ref.render(es)
        out['depth'] = depth.to(torch.float32)
      out['post'] = ref.step(es, sample['action'])
    return out

  @staticmethod
  def _gaps(side: Dict, truth: Dict) -> Dict[str, torch.Tensor]:
    """Per-sample pieces of the numbers: action gaps, mismatching pixels,
    per-env qpos gaps."""
    out = {'action': (side['action'] - truth['action']).abs().max(),
           'env_gap': (side['post'].phys.qpos -
                       truth['post'].phys.qpos).abs().amax(-1)}
    if 'rgb' in truth:
      differ = (side['rgb'] != truth['rgb']).any(-1)
      if side.get('depth') is not None:
        differ |= side['depth'] != truth['depth']
      out['mismatch'] = differ.sum()
      out['pixels'] = torch.tensor(differ.numel())
    return out

  @staticmethod
  def _numbers(gaps: list) -> Dict[str, float]:
    env_gap = torch.cat([g['env_gap'] for g in gaps]).double()
    out = {'action_gap': float(max(float(g['action']) for g in gaps)),
           'state_gap': float(torch.quantile(env_gap, 0.75))}
    if 'mismatch' in gaps[0]:
      out['frame_mismatch'] = (sum(float(g['mismatch']) for g in gaps) /
                               sum(float(g['pixels']) for g in gaps))
    q = torch.quantile(env_gap, torch.tensor(
        [0.5, 0.75, 0.9, 0.99, 1.0], dtype=torch.float64,
        device=env_gap.device))
    log('qpos gap over envs: p50 %.3g p75 %.3g p90 %.3g p99 %.3g max %.3g'
        % tuple(float(v) for v in q))
    return out

  def readings(self, control: bool = False) -> Dict[str, float]:
    """The numbers compared: of the program's answers, or (``control``)
    of the reference run with TF32 on, each against the reference."""
    samples = self.samples.items
    ref, ref_expert = self._reference()
    gaps = []
    for s in samples:
      truth = self._answers(ref, ref_expert, s, control=False)
      if control:
        side = self._answers(ref, ref_expert, s, control=True)
      else:
        side = {'action': s['action'], 'rgb': s['rgb'], 'post': s['post'],
                'depth': s['depth']}
      gaps.append(self._gaps(side, truth))
    return self._numbers(gaps)


def build(config, traffic, seed, device, trace, fault=None, cache=None
          ) -> CollectCell:
  return CollectCell(config, traffic, seed, device, trace, fault, cache)
