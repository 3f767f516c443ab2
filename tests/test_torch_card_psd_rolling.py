"""K2 (``csrc/psd_solve.cu``) in ``solver.solve``'s own 'psd' form with the
rolling rows, the production pad2-cube2 solve, on the card (every test
skips without one).

The production scene has 6 row groups (rolling rows) and takes the 'psd'
method; on the card ``solver._solve_rows`` runs its 60 iterations as one
launch of the kernel in its form 1, which sums in the eager loop's own
orders (``solver_pallas.library_orders``), once the first solve of the
operands' layout gave the eager loop's forces bit for bit (else it
raises).  Held here at B=64 and B=256: that check passed at the
production layout; an eager substep with the kernel gives the forces and
velocities of one with the eager loop (``solver._iterate``) bit for bit;
one control step through the chain of graphs with and without the
kernel, from the same state, ends in the same state bit for bit; one K2
launch a substep in the device trace of a replayed control step, and none
of the eager loop's matrix-vector products; the counters.  At every other
batch a CLI steps (1, 8, 16, 40) the check passes and the kernel then
gives the eager loop's substep.  And the TPU kernel's form
(``method='pallas'``, 4 row groups) bit for bit against the outputs the
kernel's source gave on the same operands before the 'psd' form was
added.

tests/conftest.py imports JAX, which the card lacks, so there the file
runs without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_psd_rolling.py

This file imports no JAX.
"""

import hashlib

import pytest
import torch

from geeco_tpu_torch.envs.base import make_env
from geeco_tpu_torch.expert import policies as EP
from geeco_tpu_torch.physics import solver as S
from geeco_tpu_torch.physics import solver_pallas as SP
from geeco_tpu_torch.physics import substep_graph as SG
from geeco_tpu_torch.utils import build, profiling
from test_torch_card_kernels import eager_substeps, random_psd_operands
from test_torch_substep_graph import _kernel_events

# the production shapes: 128 contacts in 6 groups, 9 joint limits, 39
# dofs, one weld (6 rows)
K, NLIM, NV, NE = 128, 9, 39, 6
NI = 6 * K + 2 * NLIM
# sha256 (first 16 hex digits) of the TPU kernel's form's forces on
# ``random_psd_operands(64, ...)`` drawn on the CPU, as the kernel's source
# gave them on the H100 before the 'psd' form was added: (nI, nv, nE, K, nlim), cluster, digest
PALLAS_DIGESTS = {
    'pad2-cube2': ((530, 39, 6, 128, 9), None, 'c69e1a4a383b7858'),
    'pad2-cube2, one block': ((530, 39, 6, 128, 9), 1, '99af5feddee60f5c'),
    'pad2-cube2, four blocks': ((530, 39, 6, 128, 9), 4,
                                '296f2f6061394d91'),
    'no weld rows': ((530, 39, 0, 128, 9), None, 'e0fb861a8b096550'),
    'K=64 nv=45': ((274, 45, 6, 64, 9), 1, 'ef9576d4fac7a239'),
    'clutter4': ((786, 63, 6, 192, 9), None, 'a024880e1035039f'),
    'not resident': ((1298, 87, 6, 320, 9), None, '8299c10a707e23cf'),
    'nut-cone': ((914, 39, 6, 224, 9), None, '37e122e7853c7ccf'),
}


@pytest.fixture(scope='module')
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the card tests run only there')
  build.build_all([build.psd_library(SP.build_spec(64, *shape, cluster=C))
                   for shape, C, _ in PALLAS_DIGESTS.values()])
  return torch.device('cuda')


@pytest.fixture(scope='module', params=[64, 256], ids=['B=64', 'B=256'])
def production(card, request):
  """pad2-cube2 at production, B envs 4 expert steps after a seeded
  reset."""
  B = request.param
  env = make_env('pad2-cube2', device=card)
  env.setup()
  assert env.stepper.cs.ngrp == 6 and env.solver_method == 'psd'
  es = env.reset_random(B, torch.Generator(device=card).manual_seed(B))
  es, _ = EP.rollout(env, es, EP.make_expert(env), length=4)
  yield env, es
  SG._chains.clear()


def _eager_loop(monkeypatch):
  """The rule made false: ``_solve_rows`` runs the eager loop."""
  monkeypatch.setattr(S, 'fuses', lambda *args: False)


def production_operands(env, phys):
  """The fused solve's operands of one eager substep of env from phys."""
  with eager_substeps(), SP.capture() as calls:
    env.stepper.substep(phys, env.solver_iterations, env.solver_method)
  assert len(calls) == 1, f'{len(calls)} fused solves in one substep'
  return calls[0]


def test_a_production_substep_with_and_without_the_kernel(production,
                                                        monkeypatch):
  """One eager substep from the same state with the kernel (its one
  launch) and with the eager loop in its place: the same forces and
  velocities bit for bit."""
  env, es = production
  production_operands(env, es.phys)     # the layout checked
  out = []
  for launches in (1, 0):
    if not launches:
      _eager_loop(monkeypatch)
    with eager_substeps(), SP.capture() as calls:
      out.append(env.stepper.substep(es.phys, env.solver_iterations,
                                     env.solver_method))
    assert len(calls) == launches
    assert all(c['orders'] is not None for c in calls)
  (fused, eager) = out
  assert bool(torch.isfinite(fused.efc_force).all())
  assert torch.equal(fused.efc_force, eager.efc_force)
  assert torch.equal(fused.qvel, eager.qvel)


def test_the_production_layout_passed_its_first_solve_check(production):
  """The first solve of the production operands' layout read the eager
  loop's summation orders and the kernel summed in them gave the loop's
  forces bit for bit: the layout runs the kernel."""
  env, es = production
  ops = production_operands(env, es.phys)
  assert ops['orders'] is not None
  assert all(ops['orders'][k] >= 1 for k in SP.ORDER_KEYS), ops['orders']
  assert any(v == ops['orders'] for v in S._orders.values())


@pytest.fixture(scope='module')
def pad2(card):
  """pad2-cube2 at production, set up once."""
  env = make_env('pad2-cube2', device=card)
  env.setup()
  yield env
  SG._chains.clear()


@pytest.mark.parametrize('B', [1, 8, 16, 40])
def test_the_check_passes_at_every_batch_a_cli_runs(B, pad2, monkeypatch):
  """At the batches the CLIs step (a partial reset's one env; the frame
  collection's 8, the controller's 16, the state-only collection's 40) the
  first solve of the layout holds the kernel to the eager loop (it would
  raise), and an eager substep with the kernel then gives the forces and
  velocities of one with the eager loop bit for bit."""
  env = pad2
  es = env.reset_random(B, torch.Generator(device='cuda').manual_seed(B))
  ops = production_operands(env, es.phys)       # checked, then the kernel
  assert ops['orders'] is not None and tuple(ops['b'].shape) == (B, NI)
  out = []
  for launches in (1, 0):
    if not launches:
      _eager_loop(monkeypatch)
    with eager_substeps(), SP.capture() as calls:
      out.append(env.stepper.substep(es.phys, env.solver_iterations,
                                     env.solver_method))
    assert len(calls) == launches
  SG._chains.clear()
  assert torch.equal(out[0].efc_force, out[1].efc_force)
  assert torch.equal(out[0].qvel, out[1].qvel)


def _step_both_ways(env, es, monkeypatch):
  """One control step from es through the chain with the kernel, then
  without it (the eager loop recorded in G4): the two states."""
  act = torch.zeros(es.phys.qpos.shape[0], 4, device=es.phys.qpos.device)
  out = []
  for fused in (True, False):
    if not fused:
      _eager_loop(monkeypatch)
    SG._chains.clear()
    env.step(es, act)                           # the chains captured
    out.append(env.step(es, act))
  SG._chains.clear()
  return out


def test_a_control_step_with_and_without_the_kernel(production,
                                                    monkeypatch):
  """The chain's replay with the kernel against the same without it, from
  the same state: the same state bit for bit."""
  env, es = production
  fused, eager = _step_both_ways(env, es, monkeypatch)
  for name in ('qpos', 'qvel', 'efc_force'):
    assert torch.equal(getattr(fused.phys, name), getattr(eager.phys, name))


def test_a_replayed_step_runs_k2_once_a_substep_and_none_of_the_loop(
    production, monkeypatch):
  """One K2 launch a substep in the device trace of a replayed control
  step, and at least the eager loop's 10 matrix-vector products an
  iteration fewer gemv kernels than the same step without the kernel."""
  env, es = production
  act = torch.zeros(es.phys.qpos.shape[0], 4, device=es.phys.qpos.device)
  counts = {}
  for fused in (True, False):
    if not fused:
      _eager_loop(monkeypatch)
    SG._chains.clear()
    env.step(es, act)
    counts[fused] = (
        _kernel_events(lambda: env.step(es, act), 'psd_solve_kernel',
                       env.n_substeps),
        _kernel_events(lambda: env.step(es, act), 'gemv', -1))
  SG._chains.clear()
  (k2, gemv), (k2_eager, gemv_eager) = counts[True], counts[False]
  assert k2 == env.n_substeps and k2_eager == 0
  assert gemv <= gemv_eager - 10 * env.n_substeps * env.solver_iterations, (
      gemv, gemv_eager)


def test_a_replayed_step_counts_every_iteration_fused(production):
  env, es = production
  act = torch.zeros(es.phys.qpos.shape[0], 4, device=es.phys.qpos.device)
  env.step(es, act)                               # the chains captured
  profiling.reset()
  profiling.enable()
  try:
    env.step(es, act)
    c = profiling.snapshot()['counters']
  finally:
    profiling.disable()
    profiling.reset()
  n = env.n_substeps * env.solver_iterations
  assert c['solver.iterations'] == c['solver.fused_iterations'] == n
  assert c['solver.graphed_iterations'] == n


@pytest.mark.parametrize('case', list(PALLAS_DIGESTS))
def test_the_tpu_kernels_form_is_bit_for_bit_as_before(case, card):
  """``method='pallas'`` at 4 row groups: the kernel's forces on operands
  drawn on the CPU hash as the kernel's source's did before the 'psd' form
  was added, in each plan."""
  (nI, nv, nE, K_, nlim), C, digest = PALLAS_DIGESTS[case]
  ops = random_psd_operands(64, K_, nlim, nv, nE,
                            torch.Generator().manual_seed(K_ + nE))
  ops = {k: v.to(card) if isinstance(v, torch.Tensor) else v
         for k, v in ops.items()}
  f = SP.psd_solve(**ops, cluster=C)
  got = hashlib.sha256(f.cpu().numpy().tobytes()).hexdigest()[:16]
  assert got == digest
