"""The physics substep replayed as a chain of CUDA graphs
(``geeco_tpu_torch/physics/substep_graph.py``).

On the CPU: the key changes with each thing that fixes a capture, the
cache keeps the most recently used chains, the CPU and inputs that
autograd tracks take the eager substep with ``physics.graphed_substeps``
at 0, and the chain's plumbing (static buffers, the eager results written
into the buffers their successors read, the state copied out, the counts
made again at each replay, a failed factorization raised at the step's
end) gives the eager substep bit for bit, with a stand-in for the CUDA
graph that reruns what it captured.

On the card (skipped without one): over 3 control steps the replays give
the eager substep's states and forces bit for bit on pad2-cube2 at B=1
and B=4, nut-cone (quota selection, ``psd_block``), clutter4 (the hull
narrowphase), ``collide_every=2``, ``mass_inverse='blockgj'`` and
``solver_method='pallas'`` at ``rolling=False`` (one launch of the fused
kernel a substep, read in a device trace); each solve's forces and
accelerations at B=8 equal the eager solve's for every method; the
counters read the same on both paths; torch reports no synchronize in a
graphed substep; a factorization that fails raises as in the eager
substep; and the cache stays bounded under resets of 1..B rows.  tests/conftest.py imports JAX, which the card
lacks, so there the file runs without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_substep_graph.py

This file imports no JAX.
"""

import contextlib
import dataclasses

import pytest
import torch

from geeco_tpu_torch.core.model import make_state
from geeco_tpu_torch.envs.base import make_env
from geeco_tpu_torch.physics import linalg as L
from geeco_tpu_torch.physics import solver as S
from geeco_tpu_torch.physics import substep_graph as SG
from geeco_tpu_torch.physics.step import Substep, build_stepper
from geeco_tpu_torch.utils import profiling
from test_torch_solver_graph import _model, _start

torch.set_num_threads(1)


@pytest.fixture
def tracer():
  profiling.disable()
  profiling.reset()
  yield profiling
  profiling.disable()
  profiling.reset()


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the graph path runs only there')
  return torch.device('cuda')


def _counters(fn):
  """fn() under the tracer: (its result, the counters)."""
  profiling.reset()
  profiling.enable()
  try:
    out = fn()
    snap = profiling.snapshot()
  finally:
    profiling.disable()
    profiling.reset()
  return out, snap['counters']


def _equal_states(a, b) -> bool:
  return all(torch.equal(getattr(a, f), getattr(b, f)) for f in SG._STATE)


# ------------------------------------------------------------------ the CPU

_ARGS = dict(iterations=60, method='psd', hysteresis=0.0,
             mass_inverse='chol')


def _changed(what, st, state):
  """(stepper, state, contacts, key arguments) with ``what`` changed."""
  args = dict(_ARGS)
  contacts = None
  if what == 'batch':
    state = state.replace(**{f: getattr(state, f)[:1] for f in SG._STATE})
  elif what == 'dtype':
    state = state.replace(qvel=state.qvel.double())
  elif what == 'strides':
    q = state.qpos
    state = state.replace(qpos=q.t().contiguous().t())
  elif what == 'offset':
    q = state.qpos
    state = state.replace(qpos=torch.cat([q, q], 1)[:, q.shape[1]:])
  elif what == 'device':
    state = state.replace(time=state.time.to('meta'))
  elif what == 'no warm start':
    state = state.replace(efc_force=None)
  elif what == 'contacts reused':
    from geeco_tpu_torch.physics import collision as C
    contacts = C.collide(st.model, st.fk(state))
  elif what == 'model':
    st = st._replace(model=st.model.to('cpu'))
  elif what == 'layout':
    st = build_stepper(st.model, rolling=False)
  elif what in ('iterations', 'method', 'hysteresis', 'mass_inverse'):
    args[what] = {'iterations': 30, 'method': 'cg', 'hysteresis': 0.01,
                  'mass_inverse': 'blockgj'}[what]
  return st, state, contacts, args


@pytest.mark.parametrize('what', [
    'batch', 'dtype', 'strides', 'offset', 'device', 'no warm start',
    'contacts reused', 'model', 'layout', 'iterations', 'method',
    'hysteresis', 'mass_inverse', 'tf32'])
def test_the_key_changes_with_each_thing_that_fixes_a_capture(what):
  m = _model('pad2-cube2')
  st = build_stepper(m)
  state = st.init_state(make_state(m, 2))
  base = SG.key(Substep(st, **_ARGS), state, None)
  assert SG.key(Substep(st, **_ARGS), state, None) == base
  if what == 'tf32':
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not was
    try:
      assert SG.key(Substep(st, **_ARGS), state, None) != base
    finally:
      torch.backends.cuda.matmul.allow_tf32 = was
    return
  st2, state2, contacts, args = _changed(what, st, state)
  assert SG.key(Substep(st2, **args), state2, contacts) != base


def test_the_cache_keeps_the_most_recently_used_chains(monkeypatch):
  monkeypatch.setattr(SG, '_chains', type(SG._chains)())
  made = []

  def make(k):
    made.append(k)
    return f'chain {k}'
  for k in range(SG.MAX_CHAINS):
    assert SG._cached(k, lambda k=k: make(k)) == f'chain {k}'
  assert SG._cached(0, lambda: make('again')) == 'chain 0'   # a hit
  SG._cached('new', lambda: make('new'))
  # key 1 was the least recently used: it went; key 0, used again, stayed
  assert list(SG._chains) == list(range(2, SG.MAX_CHAINS)) + [0, 'new']
  assert made == list(range(SG.MAX_CHAINS)) + ['new']


def test_on_the_cpu_the_substep_runs_eagerly(tracer):
  st, state = _start('pad2-cube2', 2)
  chains = len(SG._chains)
  _, counts = _counters(lambda: st.step(state, n_substeps=3,
                                        solver_iterations=8))
  assert counts['physics.substeps'] == 3
  assert counts['physics.graphed_substeps'] == 0
  assert len(SG._chains) == chains


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_an_input_that_requires_grad_takes_the_eager_substep(device,
                                                              tracer):
  if device == 'cuda' and not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the graph path runs only there')
  st, state = _start('pad2-cube2', 2, device)
  qvel = state.qvel.clone().requires_grad_(True)
  state = state.replace(qvel=qvel)
  assert not SG.engages(st, state, None)
  chains = len(SG._chains)
  end, counts = _counters(lambda: st.step(state, n_substeps=2,
                                          solver_iterations=8))
  assert counts['physics.graphed_substeps'] == 0
  assert counts['physics.substeps'] == 2
  assert len(SG._chains) == chains
  end.qpos.sum().backward()
  assert torch.isfinite(qvel.grad).all() and qvel.grad.abs().max() > 0


def _copy_tree(dst, src):
  if isinstance(dst, torch.Tensor):
    dst.copy_(src)
  elif dataclasses.is_dataclass(dst):
    for f in dataclasses.fields(dst):
      _copy_tree(getattr(dst, f.name), getattr(src, f.name))
  elif isinstance(dst, tuple):
    for a, b in zip(dst, src):
      _copy_tree(a, b)


class _StandIn:
  """A CUDA graph's stand-in: its replay reruns what was captured, with
  no counts charged and failures or-ed into the flag of its capture, and
  writes the results over the captured outputs and tallies."""

  def __init__(self, fn, args, out):
    self.fn, self.args, self.out = fn, args, out
    self.counts, self.faults = profiling._recorded, L._faults

  def replay(self):
    with profiling.recording() as again, L.faults_into(self.faults):
      _copy_tree(self.out, self.fn(*self.args))
    for (fn, _, t), (_, _, t_again) in zip(self.counts, again):
      if fn is profiling.count_device:
        t.copy_(t_again)


class _Stream:
  def wait_stream(self, other):
    pass


@contextlib.contextmanager
def _stand_in_graphs(monkeypatch):
  """The chain on the CPU: graphs, streams and card contexts stood in for,
  and the substep engaged wherever autograd tracks none of its inputs."""
  with monkeypatch.context() as mp:
    mp.setattr(SG, '_capture', lambda fn, args, pool, stream: (
        lambda out: (_StandIn(fn, args, out), out, 'pool'))(fn(*args)))
    mp.setattr(SG, 'engages', lambda st, state, contacts: not any(
        t is not None and t.requires_grad
        for t in SG._inputs(state, contacts)))
    mp.setattr(torch.cuda, 'Stream', _Stream)
    mp.setattr(torch.cuda, 'current_stream', lambda *a: _Stream())
    mp.setattr(torch.cuda, 'stream', lambda s: contextlib.nullcontext())
    mp.setattr(torch.cuda, 'device', lambda d: contextlib.nullcontext())
    yield


_CASES = {
    'plain': ({}, {}),
    'collide_every=2': ({}, dict(collide_every=2)),
    'blockgj': ({}, dict(mass_inverse='blockgj')),
    'pallas': (dict(rolling=False), dict(solver_method='pallas')),
    'psd_block, quota, hysteresis': (dict(select_mode='quota'), dict(
        solver_method='psd_block', hysteresis=0.01)),
}


@pytest.mark.parametrize('case', list(_CASES))
def test_the_chains_plumbing_gives_the_eager_substep(case, monkeypatch,
                                                     tracer):
  if torch.cuda.is_available():
    # the stand-ins replace torch.cuda's streams, which the tracer's events
    # use on a machine with a card; there the card tests run the real chain
    pytest.skip('a CPU rehearsal: on the card the real graphs are tested')
  stepper_kw, step_kw = _CASES[case]
  st, state = _start('pad2-cube2', 2, **stepper_kw)
  monkeypatch.setattr(SG, '_chains', type(SG._chains)())
  eager = st.step(state, 4, 8, **step_kw)
  eager2, want = _counters(lambda: st.step(eager, 4, 8, **step_kw))
  with _stand_in_graphs(monkeypatch):
    graphed = st.step(state, 4, 8, **step_kw)      # captures, replays
    graphed2, got = _counters(lambda: st.step(graphed, 4, 8, **step_kw))
  assert _equal_states(graphed, eager) and _equal_states(graphed2, eager2)
  assert len(SG._chains) == (2 if 'collide_every' in step_kw else 1)
  assert got.pop('physics.graphed_substeps') == 4
  assert want.pop('physics.graphed_substeps') == 0
  assert got == want
  assert not SG._faults[torch.device('cpu')]


def test_a_failed_factor_in_a_replay_raises_at_the_end_of_the_step(
    monkeypatch):
  st, state = _start('pad2-cube2', 2)
  m = st.model
  # negative masses: M_impl is not positive-definite
  bad = st._replace(model=m.replace(body_mass=-m.body_mass,
                                    body_inertia=-m.body_inertia))
  monkeypatch.setattr(SG, '_chains', type(SG._chains)())
  with pytest.raises(torch.linalg.LinAlgError):
    bad.step(state, 2, 8)                           # the eager substep
  with _stand_in_graphs(monkeypatch):
    with pytest.raises(torch.linalg.LinAlgError, match='CUDA graphs'):
      bad.step(state, 2, 8)
    assert not SG._faults[torch.device('cpu')]     # read, and cleared
    graphed = st.step(state, 2, 8)
  assert _equal_states(graphed, st.step(state, 2, 8))


# ----------------------------------------------------------------- the card

_CARD_CASES = {
    'pad2-cube2 B=1': ('pad2-cube2', 1, {}),
    'pad2-cube2 B=4': ('pad2-cube2', 4, {}),
    'nut-cone': ('nut-cone', 4, {}),
    'clutter4': ('pad2-cube2-clutter4', 4, {}),
    'collide_every=2': ('pad2-cube2', 4, dict(collide_every=2)),
    'blockgj': ('pad2-cube2', 4, dict(mass_inverse='blockgj')),
    'pallas': ('pad2-cube2', 4, dict(rolling=False, solver_method='pallas')),
    # every other iterated method, each recorded into G4
    'cg': ('pad2-cube2', 4, dict(solver_method='cg')),
    'bb': ('pad2-cube2', 4, dict(solver_method='bb')),
    'apgd': ('pad2-cube2', 4, dict(solver_method='apgd')),
    'bb_block': ('pad2-cube2', 4, dict(solver_method='bb_block',
                                       contact_select='quota')),
}


def _env_start(shapes, B, card, **env_kw):
  env = make_env(shapes, frame_res=(64, 64), settle_steps=2, device=card,
                 **env_kw)
  gen = torch.Generator().manual_seed(7)
  return env, env.reset_random(B, gen).phys


def _control_steps(monkeypatch, env, phys, graphed, n=3):
  """n control steps from phys, each end state kept; ``graphed`` False
  holds every substep to the eager path."""
  out = []
  with monkeypatch.context() as mp:
    if not graphed:
      mp.setattr(SG, 'engages', lambda st, state, contacts: False)
    for _ in range(n):
      phys = env._step_phys(phys)
      out.append(phys)
    torch.cuda.synchronize()
  return out


@pytest.mark.parametrize('case', list(_CARD_CASES))
def test_replays_are_bit_equal_to_the_eager_substep(case, card,
                                                    monkeypatch, tracer):
  shapes, B, env_kw = _CARD_CASES[case]
  env, phys = _env_start(shapes, B, card, **env_kw)
  if case in ('nut-cone', 'bb_block'):
    assert env.stepper.cs.quota_sel
  if case == 'nut-cone':
    assert env.solver_method == 'psd_block'
  if case == 'pallas':
    assert env.stepper.cs.ngrp == 4
  eager = _control_steps(monkeypatch, env, phys, False)
  graphed = _control_steps(monkeypatch, env, phys, True)
  for i, (g, e) in enumerate(zip(graphed, eager)):
    for f in SG._STATE:
      assert torch.equal(getattr(g, f), getattr(e, f)), (i, f)
  assert graphed[-1].efc_force.abs().max() > 0
  assert SG._chains and not SG._faults[phys.qpos.device]
  if case == 'pallas':
    # a replayed control step: one launch of the fused kernel a substep
    assert _kernel_events(lambda: _control_steps(monkeypatch, env, phys,
                                                 True, 1),
                          'psd_solve_kernel',
                          env.n_substeps) == env.n_substeps


def _kernel_events(fn, name, want):
  """How many kernels whose name holds ``name`` fn() runs on the card,
  read from a device trace (which holds each kernel of a graph's replay).
  A trace now and then loses records, which lowers a count and never
  raises it: the largest count of up to three traces, stopping at
  ``want``."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  best = -1
  for _ in range(3):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    best = max(best, sum(e.device_type() == DeviceType.CUDA and
                         name in e.name()
                         for e in prof.profiler.kineto_results.events()))
    if best == want:
      break
  return best


@pytest.mark.parametrize('method', S.METHODS)
def test_each_replayed_solve_is_bit_equal_to_the_eager_solve(method, card,
                                                             monkeypatch):
  mode = 'quota' if method in S.BLOCK_METHODS else 'topk'
  st, state = _start('pad2-cube2', 8, card, select_mode=mode)
  last, solve = {}, S.solve

  def keeping(*a, **k):
    # the eager solve's outputs; on the chain its capture's, which each
    # replay writes anew
    last['f'], last['qacc'] = out = solve(*a, **k)
    return out
  monkeypatch.setattr(S, 'solve', keeping)
  runs = {}
  for graphed in (False, True):
    with monkeypatch.context() as mp:
      if not graphed:
        mp.setattr(SG, 'engages', lambda st, state, contacts: False)
      s, solves = state, []
      for _ in range(20):                         # one control step
        s, _ = st._substep_c(s, 60, method, 0.0, None)
        solves.append((last['f'].clone(), last['qacc'].clone()))
      torch.cuda.synchronize()
    runs[graphed] = solves, s
  (eager, eager_end), (graphed, graphed_end) = runs[False], runs[True]
  for i, ((f, qacc), (f_e, qacc_e)) in enumerate(zip(graphed, eager)):
    assert torch.equal(f, f_e) and torch.equal(qacc, qacc_e), i
  assert _equal_states(graphed_end, eager_end)
  assert graphed_end.efc_force[:, :st.cs.ncon].abs().max() > 0


def test_the_counters_read_the_same_on_both_paths(card, monkeypatch,
                                                  tracer):
  env, phys = _env_start('pad2-cube2', 4, card)
  _control_steps(monkeypatch, env, phys, True, 1)          # the capture
  _, eager = _counters(lambda: _control_steps(monkeypatch, env, phys,
                                              False, 1))
  _, graphed = _counters(lambda: _control_steps(monkeypatch, env, phys,
                                                True, 1))
  # what differs: the graphed substeps and iterations (the eager
  # substep runs the solver's loop), and the syncs: the eager factor's
  # checks, against one read of the fault flag at the step's end
  assert graphed.pop('physics.graphed_substeps') == env.n_substeps
  assert eager.pop('physics.graphed_substeps') == 0
  assert graphed.pop('solver.graphed_iterations') == \
      env.n_substeps * env.solver_iterations
  assert eager.pop('solver.graphed_iterations') == 0
  assert eager.pop('syncs') > 1 and graphed.pop('syncs') == 1
  assert graphed == eager


def test_a_failed_factor_raises_as_in_the_eager_substep(card, monkeypatch):
  st, state = _start('pad2-cube2', 2, card)
  m = st.model
  bad = st._replace(model=m.replace(body_mass=-m.body_mass,
                                    body_inertia=-m.body_inertia))
  with monkeypatch.context() as mp:
    mp.setattr(SG, 'engages', lambda st, state, contacts: False)
    with pytest.raises(torch.linalg.LinAlgError):
      bad.step(state, 2, 8)
  with pytest.raises(torch.linalg.LinAlgError, match='CUDA graphs'):
    bad.step(state, 2, 8)
  assert not SG._faults[state.qpos.device]        # read, and cleared
  with monkeypatch.context() as mp:
    mp.setattr(SG, 'engages', lambda st, state, contacts: False)
    eager = st.step(state, 2, 8)
  assert _equal_states(st.step(state, 2, 8), eager)


def test_a_graphed_substep_makes_no_sync_torch_reports(card, monkeypatch):
  env, phys = _env_start('pad2-cube2', 4, card)
  _control_steps(monkeypatch, env, phys, True, 1)          # the capture
  mode = torch.cuda.get_sync_debug_mode()
  torch.cuda.set_sync_debug_mode('error')
  try:
    env.stepper._substep_c(phys, env.solver_iterations, env.solver_method,
                           env.hysteresis, None)
  finally:
    torch.cuda.set_sync_debug_mode(mode)
  torch.cuda.synchronize()


def test_the_cache_stays_bounded_under_resets_of_1_to_B_rows(card):
  B = SG.MAX_CHAINS + 2
  env = make_env('pad2-cube2', frame_res=(64, 64), settle_steps=1,
                 device=card)
  gen = torch.Generator()
  seen = set()
  for rows in range(1, B + 1):
    gen.manual_seed(rows)
    es = env.reset_random(B, gen, rows=slice(0, rows))
    assert es.phys.qpos.shape[0] == rows
    seen |= {k[-1][0][2][0] for k in SG._chains}
    assert len(SG._chains) <= SG.MAX_CHAINS
  assert rows in {k[-1][0][2][0] for k in SG._chains}
  assert len(seen) >= SG.MAX_CHAINS


def test_inputs_on_another_card_replay_there(card, monkeypatch):
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two CUDA cards: inputs off the current one')
  other = torch.device('cuda', (torch.cuda.current_device() + 1) %
                       torch.cuda.device_count())
  # a capture on the current card first, as a process that moved on to
  # another card would have made
  env, phys = _env_start('pad2-cube2', 1, card)
  _control_steps(monkeypatch, env, phys, True, 1)
  env, phys = _env_start('pad2-cube2', 4, other)
  current = torch.cuda.current_device()
  eager = _control_steps(monkeypatch, env, phys, False, 2)
  graphed = _control_steps(monkeypatch, env, phys, True, 2)
  torch.cuda.synchronize(other)
  assert torch.cuda.current_device() == current
  assert any(k[-1][0][0] == other for k in SG._chains)
  for g, e in zip(graphed, eager):
    assert g.qpos.device == other and _equal_states(g, e)
