"""The closed loop: goal-conditioned E2E-VMC driving B envs.  Each step is
one step of the program's step-wise rollout (``models/closed_loop.py``
``Rollout``, the one ``evaluate_batched`` drives): the env renders the B
frames (one launch of the tile rasterizer), the policy puts them into its
ring buffer and runs the model on the B windows (the dynamic images, three
encoders, the LSTM and the heads), and ``env.step`` runs the control
step's physics with the action.

Traffic keys: ``batch`` (envs), ``warmup_steps``, ``carry_mode``,
``check_steps`` (window steps compared with the reference, drawn from the
seed), ``limits``.

Set-up builds the env and the model, its weights drawn from the seed
(``train.draw_weights``: the heads are not zero, so the arm moves and
makes contacts), and starts the rollout from the seeded reset with goal
frames from ``synth_target_frames`` and no background textures; then it
runs ``warmup_steps`` steps.

The comparison follows the program from its own state before each sampled
step, as the collect cell's does (the physics is chaotic).  The reference
(``ref/models/closed_loop.py`` on the reference's env and model, the same
weights drawn from the seed) is given the program's policy state, frame
(its observation), goal frame and action, and computes the frame of the
state before the step, the model's heads, the policy state it hands on and
the state after the step; once, from the reset, it renders the goal
frames.  Numbers:
  * ``cmd_gap``: the largest gap of a component of ``pred_cmd_ee``;
  * ``logit_gap``: the largest gap of a gripper logit (logits, not their
    argmax, which flips on rounding);
  * ``frame_mismatch``: the share of pixels whose colour differs from the
    reference's;
  * ``state_gap``: the 75th percentile over envs of an env's largest gap
    in qpos after the step;
  * ``buffer_gap``: the largest gap of the policy state handed on to the
    next step: its frames and joint states, ``started`` (0 or 1), and the
    LSTM carry where it persists;
  * ``goal_mismatch``: the share of goal-frame pixels whose colour differs
    from the reference's goal frames.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..trace import Spans
from . import common
from .collect import lower_precision
from .common import Cell, Reservoir, convert, free_device_memory, log
from .train import draw_weights

# planted in the timed path for the tests: the env not stepped; the ring
# buffer handed on unshifted; half the envs left at their state; the model
# fed the window before this step's frame; the goal frames left unscaled
# (0-255)
FAULTS = ('frozen', 'stale', 'half', 'lagged', 'goal')


def control_step_shapes(config: Dict) -> Dict:
  """The shapes ``counts/physics.py`` counts a control step by: the scene's,
  as the configuration states them (``shapes``), with its env's substeps
  and solver iterations.  The contact rows are the selection's, so they
  have to be its ``contact_select_k``."""
  env = config['env']
  if config['shapes']['contact_rows'] != env['contact_select_k']:
    raise ValueError('shapes.contact_rows differs from env.contact_select_k')
  return dict(config['shapes'], iterations=env['solver_iterations'],
              substeps=env['n_substeps'])


def keep_half(es, out, batch: int):
  """``out`` with the second half of the envs left at their state in
  ``es``."""
  h = batch // 2
  phys = dataclasses.replace(out.phys, **{
      f.name: torch.cat([getattr(out.phys, f.name)[:h],
                         getattr(es.phys, f.name)[h:]])
      for f in dataclasses.fields(out.phys)
      if getattr(out.phys, f.name) is not None
      and getattr(out.phys, f.name).dim() > 0
      and getattr(out.phys, f.name).shape[0] == batch})
  return out.replace(phys=phys)


class ClosedLoopCell(Cell):
  rate_metric = 'env_steps_per_s'
  span_names = ('render', 'physics')

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
    # the step-wise rollout first: a program without it stops here, at once
    from geeco_tpu_torch.models.closed_loop import Rollout
    from geeco_tpu_torch.envs.base import GeecoEnv
    from geeco_tpu_torch.models.e2evmc import make_model
    from geeco_tpu_torch.models.params import create_e2evmc_config
    env = common.shared(
        self.cache, ('program', repr(self.config['env'])),
        lambda: GeecoEnv(**self.config['env'], device=self.device))
    for name in ('render', 'step'):   # wrappers an earlier cell put on
      vars(env).pop(name, None)       # the shared env
    if self.trace:
      render = env.render
      env.render = lambda *a, **k: self._spanned('render', render, a, k)
    self.env_step = env.step
    env.step = self._step_env
    self.model_config = create_e2evmc_config(self.config['model'])
    model = make_model(self.model_config, True, device=self.device)
    draw_weights(model, self.seed, self.device)
    model.register_forward_hook(self._keep_heads)
    if self.fault == 'lagged':
      model.register_forward_pre_hook(self._lagged_window)
    self.rollout = Rollout(env, self.model_config, model, True, self.batch,
                           torch.Generator().manual_seed(self.seed),
                           carry_mode=self.traffic['carry_mode'])
    self.es0 = self.rollout.es
    if self.fault == 'goal':
      self.rollout.tgt_frames = self.rollout.tgt_frames * 255.0
    self.tgt_frames = self.rollout.tgt_frames
    for _ in range(int(self.traffic['warmup_steps'])):
      self._advance(Spans())
    self.samples = Reservoir(int(self.traffic['check_steps']), self.seed)

  def _spanned(self, name, fn, args, kwargs):
    with self.spans(name):
      return fn(*args, **kwargs)

  def _step_env(self, es, action):
    """``env.step`` as the rollout calls it: in the span ``physics``, with
    the action kept for the comparison and the fault this cell was built
    with."""
    self.action = action
    with self.spans('physics'):
      if self.fault == 'frozen':
        return es
      out = self.env_step(es, action)
      if self.fault == 'half':
        out = keep_half(es, out, self.batch)
      return out

  def _keep_heads(self, module, args, output):
    heads = output[0]
    self.heads = {'cmd': heads['pred_cmd_ee'],
                  'logits': heads['logits_cmd_grp']}

  def _lagged_window(self, module, args):
    """The fault ``lagged``: the model sees the ring buffer as it was
    before this step's frame went in."""
    ps = self.rollout.ps
    return (ps.frames, ps.jnt) + tuple(args[2:])

  def _advance(self, spans: Spans) -> Dict:
    self.spans = spans
    r = self.rollout
    es, ps = r.es, r.ps
    rgb = r.step()
    if self.fault == 'stale':      # the ring buffer handed on unshifted
      r.ps = r.ps._replace(frames=ps.frames, jnt=ps.jnt)
    return dict(es=es, ps=ps, rgb=rgb, action=self.action, post=r.es,
                ps_next=r.ps, **self.heads)

  def step(self, spans: Spans) -> int:
    slot = self.samples.wants()
    sample = self._advance(spans)
    if slot is not None:
      self.samples.put(slot, sample)
    return self.batch

  def flops_by_dtype(self) -> Dict[str, float]:
    """The control step's physics (float32) and the forward of the B
    windows: the convolutions in the model's compute dtype, the rest in
    float32 (K1 is counted by the reader, from its launches)."""
    from ..counts import e2evmc, physics
    cfg = self.config['model']
    terms = e2evmc.window_terms(cfg)
    out = {cfg['compute_dtype']: self.batch * terms['convs']}
    out['float32'] = out.get('float32', 0.0) + physics.control_step_flops(
        control_step_shapes(self.config), self.batch) + \
        self.batch * sum(v for k, v in terms.items() if k != 'convs')
    return out

  def release(self):
    self.rollout = self.env_step = self.heads = self.action = None
    free_device_memory()

  def _persistent(self) -> bool:
    """Whether the LSTM carry persists across steps (the rollout's
    ``carry_mode``, 'auto' resolved as ``make_closed_loop`` does)."""
    mode = self.traffic['carry_mode']
    if mode in (None, 'auto'):
      return self.model_config.train_carry != 'stateless'
    return mode == 'persistent'

  # ------------------------------------------------------------ reference

  def _reference(self):
    """The reference's env, its model (the weights drawn from the seed),
    its policy step, and the dict its model's heads land in."""
    from ..ref.envs.base import GeecoEnv as RefEnv
    from ..ref.models.closed_loop import make_closed_loop
    from ..ref.models.e2evmc import make_model
    from ..ref.models.params import create_e2evmc_config
    ref = common.shared(
        self.cache, ('reference', repr(self.config['env'])),
        lambda: RefEnv(**self.config['env'], device=self.device))
    cfg = create_e2evmc_config(self.config['model'])
    model = make_model(cfg, True, device=self.device)
    draw_weights(model, self.seed, self.device)
    heads = {}
    model.register_forward_hook(
        lambda module, args, output: heads.update(output[0]))
    policy = make_closed_loop(ref, cfg, True,
                              self.traffic['carry_mode']).policy_step
    return ref, model, policy, heads

  @staticmethod
  def _ref_state(es):
    """The program's env state as the reference's."""
    from ..ref.core.model import State
    from ..ref.envs.base import EnvState
    fields = {f.name: getattr(es, f.name) for f in dataclasses.fields(es)}
    return EnvState(**dict(fields, phys=convert(es.phys, State)))

  def _answers(self, reference, sample, control: bool) -> Dict:
    """The reference's frame, heads, policy state handed on and next state
    from the sample's state before the step; ``control``: computed in the
    precision below the configuration's (``collect.lower_precision``)."""
    from ..ref.models.closed_loop import PolicyState
    ref, model, policy, heads = reference
    es = self._ref_state(sample['es'])
    ps = convert(sample['ps'], PolicyState)
    obs = sample['rgb'].float() / 255.0
    with lower_precision(ref, control):
      rgb, _ = ref.render(es)
      jnt = ref.proprioception(es)
      if control:
        # the control's buffer takes the frame it rendered: a buffer only
        # copies, so handed the program's frame it would read 0
        _, ps_next = policy(model, ps, rgb.float() / 255.0, jnt,
                            self.tgt_frames)
      _, ps_given = policy(model, ps, obs, jnt, self.tgt_frames)
      return {'rgb': rgb, 'cmd': heads['pred_cmd_ee'],
              'logits': heads['logits_cmd_grp'],
              'ps_next': ps_next if control else ps_given,
              'post': ref.step(es, sample['action'])}

  def _goal_frames(self, reference, control: bool) -> torch.Tensor:
    """The reference's goal frames from the rollout's reset."""
    from ..ref.models.closed_loop import synth_target_frames
    ref = reference[0]
    with lower_precision(ref, control):
      return synth_target_frames(ref, self.model_config,
                                 self._ref_state(self.es0))

  @staticmethod
  def _policy_gap(side, truth, persistent: bool) -> float:
    """The largest gap of a policy state handed on (``started`` as 0 or 1;
    the carry only where it persists)."""
    gaps = [(side.frames - truth.frames).abs().max(),
            (side.jnt - truth.jnt).abs().max(),
            (side.started != truth.started).any().float()]
    if persistent:
      gaps += [(a - b).abs().max() for a, b in zip(side.carry, truth.carry)]
    return max(float(g) for g in gaps)

  def _numbers(self, pairs: list, goal: tuple) -> Dict[str, float]:
    """The numbers over the (side, truth) pairs of the samples and the
    (side, truth) goal frames."""
    env_gap = torch.cat([(side['post'].phys.qpos - truth['post'].phys.qpos)
                         .abs().amax(-1) for side, truth in pairs]).double()
    differ = [(side['rgb'] != truth['rgb']).any(-1) for side, truth in pairs]
    q = torch.quantile(env_gap, torch.tensor(
        [0.5, 0.75, 0.9, 0.99, 1.0], dtype=torch.float64,
        device=env_gap.device))
    log('qpos gap over envs: p50 %.3g p75 %.3g p90 %.3g p99 %.3g max %.3g'
        % tuple(float(v) for v in q))
    return {
        'cmd_gap': max(float((side['cmd'] - truth['cmd']).abs().max())
                       for side, truth in pairs),
        'logit_gap': max(float((side['logits'] - truth['logits']).abs()
                               .max()) for side, truth in pairs),
        'frame_mismatch': (sum(float(d.sum()) for d in differ) /
                           sum(d.numel() for d in differ)),
        'state_gap': float(q[1]),
        'buffer_gap': max(
            self._policy_gap(side['ps_next'], truth['ps_next'],
                             self._persistent()) for side, truth in pairs),
        'goal_mismatch': float((goal[0] != goal[1]).any(-1).double().mean()),
    }

  def readings(self, control: bool = False) -> Dict[str, float]:
    """The numbers compared: of the program's answers, or (``control``)
    of the reference one precision down, each against the reference."""
    reference = self._reference()
    pairs = []
    for s in self.samples.items:
      truth = self._answers(reference, s, control=False)
      side = self._answers(reference, s, control=True) if control else s
      pairs.append((side, truth))
    goal = self._goal_frames(reference, control=False)
    side = self._goal_frames(reference, control=True) if control \
        else self.tgt_frames
    return self._numbers(pairs, (side, goal))


def build(config, traffic, seed, device, trace, fault=None, cache=None
          ) -> ClosedLoopCell:
  return ClosedLoopCell(config, traffic, seed, device, trace, fault, cache)
