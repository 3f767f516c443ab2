"""The port's tracer (``geeco_tpu_torch/utils/profiling.py``) and the spans
and counters the hot paths open with it: off it records nothing and costs a
flag check; on it gets nesting, self time and counters right, lies on a
``torch.profiler`` trace, and leaves every output bit-equal."""

import json
import os
import time
import warnings

import pytest
import torch

from geeco_tpu_torch.envs.base import make_env
from geeco_tpu_torch.expert.policies import init_expert_state, make_expert
from geeco_tpu_torch.models import train as TT
from geeco_tpu_torch.models.params import create_e2evmc_config
from geeco_tpu_torch.utils import profiling

B = 2
ENV = dict(frame_res=(32, 32), n_substeps=2, settle_steps=1,
           solver_iterations=4)
T, K = 3, 2
ENV_SPANS = {'expert', 'render', 'env.step', 'physics.smooth',
             'physics.collide', 'physics.constraints', 'physics.solve'}
TRAIN_SPANS = {'train.rerender', 'render', 'train.forward', 'train.backward',
               'train.update'}
EMPTY = {'spans': {}, 'counters': {'syncs': 0}}


@pytest.fixture
def tracer():
  profiling.disable()
  profiling.reset()
  yield profiling
  profiling.disable()
  profiling.reset()


@pytest.fixture(scope='module')
def env():
  """The env and a seeded reset of B envs (its settle steps run before
  any test turns the tracer on)."""
  e = make_env('pad2-cube2', device='cpu', **ENV)
  e.setup()
  return e, e.reset_random(B, torch.Generator().manual_seed(0))


# ------------------------------------------------------------- the tracer


def test_off_a_span_is_the_shared_noop_and_nothing_is_recorded(tracer):
  assert not profiling.on()
  a, b = profiling.span('a'), profiling.span('b')
  assert a is b
  with a:
    profiling.count('n', 3)
    profiling.count_device('d', torch.ones(()))
  assert profiling.snapshot() == EMPTY


def test_nesting_parents_and_self_time(tracer):
  profiling.enable()
  for _ in range(2):
    with profiling.span('outer'):
      time.sleep(0.01)
      with profiling.span('inner'):
        time.sleep(0.02)
  with profiling.span('inner'):
    pass
  snap = profiling.snapshot()['spans']
  outer, inner = snap['outer'], snap['inner']
  assert outer['calls'] == 2 and inner['calls'] == 3
  assert outer['parents'] == {'': 2}
  assert inner['parents'] == {'outer': 2, '': 1}
  assert inner['host_s'] >= 0.04 and outer['host_s'] >= 0.06
  # self time: the duration less what the child spans cover
  nested = outer['host_s'] - outer['self_s']
  assert 0.04 <= nested <= inner['host_s']
  assert outer['self_s'] >= 0.02
  assert inner['self_s'] == inner['host_s']
  # without a card the stream time is the host time
  assert outer['stream_s'] == outer['host_s']


def test_counters_are_charged_to_the_innermost_span(tracer):
  profiling.enable()
  profiling.count('rows', 1)
  with profiling.span('a'):
    profiling.count('rows', 2)
    with profiling.span('b'):
      profiling.count('rows', 5)
      profiling.count('other')
  snap = profiling.snapshot()
  assert snap['spans']['a']['counters'] == {'rows': 2}
  assert snap['spans']['b']['counters'] == {'rows': 5, 'other': 1}
  assert snap['counters'] == {'rows': 8, 'other': 1, 'syncs': 0}


def test_device_tallies_are_read_at_snapshot_and_reset_empties(tracer):
  profiling.enable()
  with profiling.span('solve'):
    for i in range(3):
      profiling.count_device('active', torch.tensor([True, i > 0]).sum())
  profiling.count_device('active', torch.tensor(10))
  snap = profiling.snapshot()
  assert snap['spans']['solve']['counters'] == {'active': 5}
  assert snap['counters']['active'] == 15
  assert profiling.snapshot() == snap           # read once, kept
  profiling.reset()
  assert profiling.snapshot() == EMPTY


@pytest.mark.parametrize('on', [False, True])
def test_recording_collects_counts_and_tallies_for_each_replay(on, tracer):
  if on:
    profiling.enable()
  with profiling.span('solve'), profiling.recording() as made:
    assert profiling.on()          # a capture holds every tally's work
    profiling.count('rows', 4)
    profiling.count_device('active', torch.tensor([True, False]).sum())
  assert [(name, int(v)) for _, name, v in made] == [('rows', 4),
                                                      ('active', 1)]
  assert profiling.snapshot()['counters'] == {'syncs': 0}   # uncharged
  assert profiling.on() == on
  profiling.enable()
  profiling.reset()
  for _ in range(2):                # two replays
    with profiling.span('solve'):
      for fn, name, v in made:
        fn(name, v)
  snap = profiling.snapshot()
  assert snap['spans']['solve']['counters'] == {'rows': 8, 'active': 2}


def test_spans_are_record_function_ranges_of_a_profiler_session(tracer):
  from torch.profiler import ProfilerActivity, profile

  def work():
    with profiling.span('outer'):
      with profiling.span('inner'):
        torch.ones(8).sum()

  with profile(activities=[ProfilerActivity.CPU]) as off:
    work()
  profiling.enable()
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    work()
  names = {e.name for e in prof.events()}
  assert {'outer', 'inner'} <= names
  assert not {'outer', 'inner'} & {e.name for e in off.events()}
  by_name = {e.name: e for e in prof.events()}
  outer, inner = by_name['outer'], by_name['inner']
  assert outer.time_range.start <= inner.time_range.start
  assert inner.time_range.end <= outer.time_range.end


def test_syncs_are_counted_against_the_innermost_span(tracer, recwarn):
  profiling.enable(syncs=True)
  with profiling.span('solve'):
    for _ in range(2):
      warnings.warn(profiling.SYNC_MESSAGE + ' (Triggered internally)')
  warnings.warn(profiling.SYNC_MESSAGE)
  warnings.warn('another warning')
  snap = profiling.snapshot()
  assert snap['spans']['solve']['counters'] == {'syncs': 2}
  assert snap['counters']['syncs'] == 3
  profiling.disable()
  # off, the reports of syncs are warnings again
  warnings.warn(profiling.SYNC_MESSAGE)
  said = [str(w.message) for w in recwarn]
  assert said == ['another warning', profiling.SYNC_MESSAGE]


def test_a_sync_reported_on_another_thread_is_charged_to_the_open_span(
    tracer):
  """Autograd runs a backward pass on threads of its own: what they
  report goes to the span that called it."""
  import threading
  profiling.enable(syncs=True)
  with profiling.span('train.backward'):
    worker = threading.Thread(
        target=lambda: warnings.warn(profiling.SYNC_MESSAGE))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
  snap = profiling.snapshot()
  assert snap['spans']['train.backward']['counters'] == {'syncs': 1}


def test_trace_writes_the_programs_spans_and_turns_the_tracer_off(
    tracer, tmp_path):
  with profiling.trace(str(tmp_path / 'prof')):
    assert profiling.on()
    with profiling.span('physics.solve'):
      x = torch.randn(64, 64)
      (x @ x).sum()
  assert not profiling.on()
  assert profiling.snapshot()['spans']['physics.solve']['calls'] == 1
  files = os.listdir(tmp_path / 'prof')
  events = json.load(open(tmp_path / 'prof' / files[0]))['traceEvents']
  assert any(e.get('name') == 'physics.solve' for e in events)


# ------------------------------------------------------------- the hot paths


def _env_step(env, es):
  """One collection step from ``es``: expert, frame, control step."""
  action, _ = make_expert(env)(es, init_expert_state(B, 'cpu'))
  rgb, depth = env.render(es)
  out = env.step(es, action)
  return [action, rgb, depth, out.phys.qpos, out.phys.qvel,
          out.phys.efc_force]


def _train_config():
  return create_e2evmc_config(dict(
      img_height=32, img_width=32, window_size=K, proc_obs='dynimg',
      proc_tgt='dyndiff', dim_s_obs=20, dim_s_dyn=20, dim_s_diff=20,
      dim_h_lstm=8, dim_h_fc=8, compute_dtype='float32'))


def _train_batch(env, cfg):
  g = torch.Generator().manual_seed(0)
  q0 = env._phys_template(1).qpos[0]
  mocap = torch.tensor([0.4, 0.48, 0.6, 1.0, 0.0, 1.0, 0.0])
  N = T - K + 1
  J = cfg.dim_jnt_state
  return {
      'widx': torch.arange(N)[:, None] + torch.arange(K)[None, :],
      'valid': torch.ones(N, dtype=torch.bool),
      'jnt_state': torch.randn(B, T, J, generator=g),
      'cmd': torch.rand(B, N, 4, generator=g) * 2 - 1,
      'vel_target': torch.randn(B, N, J, generator=g),
      'ee_target': torch.randn(B, N, 7, generator=g),
      'grp_target': torch.rand(B, N, 2, generator=g),
      'pos_ee': torch.randn(B, N, 3, generator=g),
      'pos_obj': torch.randn(B, N, 3, generator=g),
      'step': torch.arange(N).expand(B, N),
      'qpos': q0 + 0.01 * torch.randn(B, T, q0.shape[0], generator=g),
      'mocap': mocap.expand(B, T, 7),
      'rgba': torch.as_tensor(env.rgba0, dtype=torch.float32).expand(
          (B,) + tuple(env.rgba0.shape)),
      'tgt_qpos': q0 + 0.01 * torch.randn(B, q0.shape[0], generator=g),
      'tgt_mocap': mocap.expand(B, 7),
  }


def _train_step(env, _):
  """One episode train step from fixed weights: the loss and every
  parameter after it."""
  cfg = _train_config()
  init_fn, train_step, _, _ = TT.make_episode_train_fns(
      cfg, True, chunk_windows=2, render_fn=env.render_from_qpos,
      render_chunk=4, device='cpu')
  ts = init_fn(torch.Generator().manual_seed(0))
  ts, metrics = train_step(ts, _train_batch(env, cfg))
  return [metrics['loss']] + [p.detach() for p in ts.model.parameters()]


STEPS = {'env': (_env_step, ENV_SPANS), 'train': (_train_step, TRAIN_SPANS)}


@pytest.mark.parametrize('path', sorted(STEPS))
def test_a_step_opens_exactly_the_documented_spans(path, env, tracer):
  run, spans = STEPS[path]
  profiling.enable()
  run(*env)
  snap = profiling.snapshot()
  assert set(snap['spans']) == spans
  parents = {name: set(s['parents']) for name, s in snap['spans'].items()}
  if path == 'env':
    for name in ('smooth', 'collide', 'constraints', 'solve'):
      assert parents[f'physics.{name}'] == {'env.step'}
      assert snap['spans'][f'physics.{name}']['calls'] == ENV['n_substeps']
    cs = env[0].stepper.cs
    nI = cs.ngrp * cs.ncon_sel + 2 * cs.nlim
    solve = snap['spans']['physics.solve']['counters']
    assert solve['contact_rows.iterated'] == ENV['n_substeps'] * B * nI
    assert 0 < solve['contact_rows.active'] < solve['contact_rows.iterated']
  else:
    assert parents['render'] == {'train.rerender'}
    for name in ('rerender', 'forward', 'backward', 'update'):
      assert parents[f'train.{name}'] == {''}
      assert snap['spans'][f'train.{name}']['calls'] == 1


@pytest.mark.parametrize('path', sorted(STEPS))
def test_a_step_is_bit_equal_with_the_tracer_on(path, env, tracer):
  run, _ = STEPS[path]
  off = run(*env)
  profiling.enable()
  on = run(*env)
  assert len(on) == len(off)
  for a, b in zip(off, on):
    assert torch.equal(a, b)


@pytest.mark.parametrize('path', sorted(STEPS))
def test_off_a_step_makes_no_range_event_or_tally(path, env, tracer,
                                                 monkeypatch):
  """With the tracer off a step opens no record_function range of its
  own, creates no CUDA event and computes no device tally."""
  made = {'range': 0, 'event': 0, 'tally': 0}

  def counting(key, fn):
    def wrapped(*a, **k):
      made[key] += 1
      return fn(*a, **k)
    return wrapped

  monkeypatch.setattr(torch.profiler, 'record_function',
                      counting('range', torch.profiler.record_function))
  monkeypatch.setattr(torch.cuda, 'Event', counting('event', object))
  monkeypatch.setattr(profiling, 'count_device',
                      counting('tally', profiling.count_device))
  run, _ = STEPS[path]
  run(*env)
  assert made == {'range': 0, 'event': 0, 'tally': 0}
  profiling.enable()
  run(*env)
  assert made['range'] > 0
  assert made['tally'] == (ENV['n_substeps'] if path == 'env' else 0)
