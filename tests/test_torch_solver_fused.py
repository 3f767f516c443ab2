"""The 'psd' iteration as one launch of the fused kernel (K2 in its form 1,
``physics/solver.py`` ``fuses``, ``_fits``, ``_solve_rows`` and
``_checked_orders``), on the CPU.

On the CPU the rule never engages and ``_solve_rows`` returns the eager
loop's forces bit for bit.  Each of the rule's clauses but the card's is
held on its own (``_fits``); with ``fuses`` replaced by ``_fits`` the first
solve of a layout checks the kernel (its plain twin here, which in the
'psd' form, with 4 or 6 row groups, is the eager loop's arithmetic), later
solves take it, and a layout whose check fails, or which is first solved
under a graph's capture, raises.  The reading of the
libraries' summation orders (``solver_pallas._chain_family``) and form 1's
launch plan are held here too; the kernel itself is held against the eager
loop, bit for bit, on the card (``tests/test_torch_card_psd_rolling.py``).
Imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from geeco_tpu_torch.envs.base import make_env
from geeco_tpu_torch.physics import solver as S
from geeco_tpu_torch.physics import solver_pallas as SP
from geeco_tpu_torch.utils import build, profiling

ITER = 30


def _operands(seed, ngrp=6, nE=6, B=3, K=8, nlim=2, nv=12):
  """Random well-posed operands of ``_solve_rows``: (rows, ops, b, precond,
  f0, cone), f0 projected as ``solve`` projects it."""
  g = torch.Generator().manual_seed(seed)
  r = lambda *s: torch.randn(*s, generator=g)
  u = lambda *s: torch.rand(*s, generator=g)
  nI = ngrp * K + 2 * nlim
  J = r(B, nI, nv) / nv ** 0.5
  A = r(B, nv, nv) / nv ** 0.5
  M = torch.eye(nv) + A @ A.transpose(1, 2)
  X = torch.linalg.solve(M, J.transpose(1, 2))
  R = 0.1 + u(B, nI)
  diag = (J * X.transpose(1, 2)).sum(-1) + R
  ops = (J, X, R)
  if nE:
    JE = r(B, nE, nv) / nv ** 0.5
    XE = torch.linalg.solve(M, JE.transpose(1, 2))
    AIE = J @ XE
    EEinv = torch.linalg.inv(JE @ XE + torch.diag_embed(0.1 + u(B, nE)))
    diag = diag - torch.einsum('zie,zef,zif->zi', AIE, EEinv, AIE)
    ops = (J, X, R, JE, AIE, EEinv)
  rows = S._Rows(K, ngrp, ngrp * K, nI)
  cone = (0.5 + 0.5 * u(B, K), 0.005 + 0.01 * u(B, K),
          0.002 + 0.01 * u(B, K), (u(B, K) > 0.3).float(),
          (u(B, 2 * nlim) > 0.5).float())
  f0 = S._project(r(B, nI), rows, *cone)
  return rows, ops, r(B, nI), 1.0 / diag, f0, cone


def _eager(method, rows, ops, b, precond, f0, cone):
  return S._iterate(lambda f: S._apply(f, *ops),
                    lambda f: S._project(f, rows, *cone), f0, b, precond,
                    ITER, method)


# summation orders of the family the kernel sums in (the H100's at B=256)
ORDERS = dict(gu=4, wu=64, gj=2, wj=20, gw=2, ww=20, gz=2, wz=3, ga=2, wa=3,
              rw=32)


@pytest.fixture
def cpu_rule(monkeypatch):
  """The rule on the CPU, its clauses but the card's deciding (``_fits``),
  with no layout checked yet; the libraries' orders read as ``ORDERS``
  (the twin runs in the kernel's place and sums as the eager loop does)."""
  monkeypatch.setattr(S, 'fuses', S._fits)
  monkeypatch.setattr(S, '_orders', {})
  monkeypatch.setattr(S, '_checked', set())
  monkeypatch.setattr(SP, 'library_orders', lambda *ops: dict(ORDERS))


# what each case changes of the operands (or the method) so that one
# clause of the rule fails
NOT_FUSED = {
    'float64': lambda a: dict(a, ops=tuple(t.double() for t in a['ops']),
                              b=a['b'].double(),
                              precond=a['precond'].double(),
                              f0=a['f0'].double(),
                              cone=tuple(t.double() for t in a['cone'])),
    'autograd': lambda a: dict(a, b=a['b'].clone().requires_grad_()),
    # X's rows contiguous, as 'blockgj' leaves them
    'rows of X contiguous': lambda a: dict(a, ops=(
        a['ops'][0], a['ops'][1].contiguous(), *a['ops'][2:])),
    'cg': lambda a: dict(a, method='cg'),
    'bb': lambda a: dict(a, method='bb'),
    'apgd': lambda a: dict(a, method='apgd'),
    # a J too wide for the SM even split over four blocks: no plan
    'no plan': lambda a: a,
    # weld rows beyond one warp's lanes
    '33 weld rows': lambda a: a,
    'no weld rows': lambda a: a,
}


def _case(case, seed):
  if case == 'no plan':
    rows, *rest = _operands(seed, K=320, nlim=9, nv=87, B=1)
  elif case == '33 weld rows':
    rows, *rest = _operands(seed, nE=33)
  elif case == 'no weld rows':
    rows, *rest = _operands(seed, nE=0)
  else:
    rows, *rest = _operands(seed)
  args = dict(method='psd', rows=rows,
              **dict(zip(('ops', 'b', 'precond', 'f0', 'cone'), rest)))
  return NOT_FUSED.get(case, lambda a: a)(args)


@pytest.mark.parametrize('case', ['cpu'] + list(NOT_FUSED))
def test_rule_is_false_and_solve_rows_is_the_eager_loop(case, request):
  """The rule fails (on the CPU; with ``_fits`` deciding, on the one clause
  the case breaks) and ``_solve_rows`` returns the eager loop's forces bit
  for bit."""
  if case != 'cpu':
    request.getfixturevalue('cpu_rule')
  a = _case(case, 7)
  assert not S.fuses(a['method'], a['rows'], a['ops'], a['b'],
                     a['precond'], a['f0'], a['cone'])
  if case == 'cpu':              # the card's clause alone fails
    assert S._fits(a['method'], a['rows'], a['ops'], a['b'], a['precond'],
                   a['f0'], a['cone'])
  got = S._solve_rows(a['method'], ITER, a['rows'], 0, a['ops'], a['b'],
                      a['precond'], a['f0'], a['cone'])
  want = _eager(a['method'], a['rows'], a['ops'], a['b'], a['precond'],
                a['f0'], a['cone'])
  assert torch.equal(got.detach(), want.detach())


@pytest.mark.parametrize('ngrp', [6, 4])
def test_fused_path_runs_after_a_bit_equal_first_solve(ngrp, cpu_rule):
  """With ``_fits`` deciding the rule holds on a planned shape.  The first
  solve of a layout returns the eager loop's forces and checks the kernel
  (its twin here) summed in the libraries' orders against them; equal, the
  layout's later solves go to ``psd_solve`` with the rolling rows, the
  weld form and the orders, and give the eager loop's forces.  Both count
  their iterations as fused."""
  rows, ops, b, precond, f0, cone = _operands(ngrp, ngrp)
  assert S.fuses('psd', rows, ops, b, precond, f0, cone)
  want = _eager('psd', rows, ops, b, precond, f0, cone)
  profiling.reset()
  profiling.enable()
  try:
    first = S._solve_rows('psd', ITER, rows, 0, ops, b, precond, f0, cone)
    assert torch.equal(first, want)
    assert S._orders[S._layout(ops, b)] == ORDERS
    with SP.capture() as calls:
      got = S._solve_rows('psd', ITER, rows, 0, ops, b, precond, f0, cone)
    counters = profiling.snapshot()['counters']
  finally:
    profiling.disable()
    profiling.reset()
  assert len(calls) == 1
  assert ('mu_roll' in calls[0]) == (ngrp == 6) and 'J_E' in calls[0]
  assert torch.equal(got, want)
  assert counters['solver.fused_iterations'] == 2 * ITER
  assert counters['solver.iterations'] == 2 * ITER


def test_a_solve_of_nan_forces_reads_the_orders_and_checks_later(
    cpu_rule):
  """After a failed factor (NaN operands, which the substep raises) a
  solve reads the layout's orders and returns the loop's forces, but
  holds the kernel to nothing: the layout's next solve outside a capture
  runs the loop and checks the kernel on finite forces."""
  rows, ops, b, precond, f0, cone = _operands(8)
  bad = (ops[0], ops[1] * float('nan'), *ops[2:])
  key = S._layout(bad, b)
  with SP.capture() as calls:
    got = S._solve_rows('psd', ITER, rows, 0, bad, b, precond, f0, cone)
  assert torch.isnan(got).any() and not calls
  assert S._orders[key] == ORDERS and key not in S._checked
  with SP.capture() as calls:
    got = S._solve_rows('psd', ITER, rows, 0, ops, b, precond, f0, cone)
  assert len(calls) == 1 and key in S._checked
  assert torch.equal(got, _eager('psd', rows, ops, b, precond, f0, cone))


# what makes a layout's first-solve check fail: the kernel (its twin
# here) one rounding off the eager loop, or the libraries' orders of no
# family the kernel sums in
CHECK_FAULTS = {
    'kernel one rounding off': ('psd_solve', lambda real: (
        lambda *a, **k: real(*a, **k) * (1 + 2.0 ** -20)),
        'forces differ from the eager loop'),
    'orders unread': ('library_orders', lambda real: (lambda *a: None),
                      'no order of the family'),
}


@pytest.mark.parametrize('fault', list(CHECK_FAULTS))
def test_a_layout_whose_check_fails_raises(fault, cpu_rule, monkeypatch):
  """A planned layout whose first solve cannot hold the kernel to the
  eager loop's forces bit for bit raises, naming the layout, and is left
  unchecked: no solve of it falls back to the eager loop unseen."""
  rows, ops, b, precond, f0, cone = _operands(5)
  name, make, message = CHECK_FAULTS[fault]
  monkeypatch.setattr(SP, name, make(getattr(SP, name)))
  for _ in range(2):
    with pytest.raises(RuntimeError, match=message) as err:
      S._solve_rows('psd', ITER, rows, 0, ops, b, precond, f0, cone)
    assert 'layout' in str(err.value)
  assert S._layout(ops, b) not in S._checked


def test_a_layout_first_solved_under_capture_raises(cpu_rule, monkeypatch):
  """A planned layout met first inside a graph's capture cannot be checked
  there: the solve raises instead of recording the eager loop."""
  rows, ops, b, precond, f0, cone = _operands(6)
  monkeypatch.setattr(S, '_capturing', lambda device: True)
  with SP.capture() as calls, pytest.raises(RuntimeError,
                                            match='capture'):
    S._solve_rows('psd', ITER, rows, 0, ops, b, precond, f0, cone)
  assert not calls and S._layout(ops, b) not in S._orders


def test_orders_of_the_family_are_read_back_from_their_subtrees():
  """``_chain_family`` recovers (G, W) from the subtree sizes at the pairs
  (0, j) of a sum in that family's order (the orders read on the H100:
  u = X v over 786 rows in 4 and in 8 chains of 64-row chunks, J_E u in 8
  chains of 5)."""
  for k, G, W in ((786, 4, 64), (786, 8, 64), (39, 8, 5), (39, 2, 20),
                  (6, 2, 3), (6, 2, 4), (39, 1, 39)):
    group = [(j // W) % G for j in range(k)]
    size = [group.count(g) for g in range(G)]
    lca0 = []
    for j in range(1, k):
      q = group[j]
      if q == 0:
        lca0.append(sum(1 for i in range(j + 1) if group[i] == 0))
      else:
        lca0.append(sum(size[g] for g in range(0, G, q & -q)))
    assert SP._chain_family(k, lca0) == (G, W)
  assert SP._chain_family(5, [2, 2, 4, 5]) is None


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('ngrp', [6, 4])
def test_twin_in_the_psd_form_equals_iterate(ngrp, seed):
  """``psd_solve_reference`` with ``J_E`` (and ``mu_roll`` at 6 groups) is
  ``_iterate('psd')`` on random well-posed operands, within 1e-6 of the
  largest force."""
  rows, ops, b, precond, f0, cone = _operands(seed, ngrp)
  J, X, R, JE, AIE, EEinv = ops
  mu_t, mu_tor, mu_roll, con_act, lim_act = cone
  got = SP.psd_solve_reference(
      J, X, AIE, EEinv, R, b, precond, f0, mu_t, mu_tor, con_act, lim_act,
      rows.Kc, 2, ITER, mu_roll=mu_roll if ngrp == 6 else None, J_E=JE)
  want = _eager('psd', rows, ops, b, precond, f0, cone)
  assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_project_rows_with_rolling_rows_is_the_solvers_projection():
  rows, ops, b, precond, f0, cone = _operands(3, 6)
  mu_t, mu_tor, mu_roll, con_act, lim_act = cone
  f = torch.randn(f0.shape, generator=torch.Generator().manual_seed(3))
  assert torch.equal(
      SP.project_rows(f, mu_t, mu_tor, con_act, lim_act, rows.Kc, 2,
                      mu_roll),
      S._project(f, rows, *cone))


def test_no_fused_iteration_on_the_cpu():
  """A substep of pad2-cube2 on the CPU counts its iterations and no fused
  one."""
  env = make_env('pad2-cube2', device='cpu', n_substeps=1, settle_steps=0,
                 solver_iterations=4)
  es = env.reset_random(2, torch.Generator().manual_seed(0))
  profiling.reset()
  profiling.enable()
  try:
    env.step(es, torch.zeros(2, 4))
    counters = profiling.snapshot()['counters']
  finally:
    profiling.disable()
    profiling.reset()
  assert counters['solver.iterations'] == 4
  assert counters['solver.fused_iterations'] == 0


# the production shapes with rolling rows: (nI, nv, nE, K) and whether one
# block's shared memory holds X and the rows of an env
PLANNED = {'pad2-cube2': ((786, 39, 6, 128), True),
           'clutter4': ((1170, 63, 6, 192), False),
           'nut-cone': ((1362, 39, 6, 224), False)}


@pytest.mark.parametrize('B', [256, 64, 1])
@pytest.mark.parametrize('scene', list(PLANNED))
def test_fused_plan_holds_an_env_in_one_block(scene, B):
  """One block an env, a thread per row, X and the rows in its shared
  memory: pad2-cube2's fit, clutter4's and nut-cone's X does not."""
  (nI, nv, nE, K), fits = PLANNED[scene]
  lay = SP.fused_plan(B, nI, nv, nE, K, 9)
  assert (lay is not None) == fits, lay
  if fits:
    assert lay['cluster'] == 1 and lay['smem'] <= SP._SMEM_MAX
    assert lay['smem'] > 4 * nv * nI                  # X, on the SM
    spec = SP.build_spec(B, nI, nv, nE, K, 9, ngrp=6, orders=ORDERS)
    assert spec['form'] == 1 and spec['threads'] >= nI


def test_fused_plan_none_where_the_kernel_has_no_plan():
  assert SP.fused_plan(3, 6 * 320 + 18, 87, 6, 320, 9) is None
  assert SP.fused_plan(64, 786, 39, 33, 128, 9) is None
  assert SP.fused_plan(64, 786, 39, 0, 128, 9) is None
  assert SP.fused_plan(64, 786, 39, 6, 128, 9) is not None


def test_exact_layout_counts_what_is_staged():
  """Form 1's shared memory (``psdx::make_plan``): X and A_IE, eight row
  vectors, J_E, EEinv, u and its chain sums, w, z, the contact and limit
  arrays, the two sums and the row sums' partial sums, then as many of
  Jᵀ's dofs as fit (19 of 39 at pad2-cube2's shapes); the rest of J stays
  in device memory."""
  base = dict(nI=786, nv=39, nE=6, K=128, nlim=9)
  rest = (39 * 788 + 786 * 6 + 8 * 788 + 236 + 36 + 40 + 40 + 8 + 8 +
          4 * 128 + 20 + 4 + 32)
  one = SP._exact_layout(**base, gu=1, rw=32)
  assert one['smem'] == 4 * (rest + 19 * 788) <= SP._SMEM_MAX
  assert SP._exact_layout(**base, gu=8, rw=32)['smem'] - one['smem'] == 4 * (
      312 - 40)
  assert SP._exact_layout(**base, gu=1, rw=128)['smem'] - one['smem'] == 4 * 96
  assert one['threads'] == 800 and one['cluster'] == 1


@pytest.mark.parametrize('B, threads', [(4, 128), (8, 64), (16, 32)])
def test_tree_sums_are_torchs_row_sums_on_the_h100(B, threads):
  """``_tree_sums`` with the threads torch took a row gives, bit for bit,
  the row sums torch 2.11 computed on an H100 (rows 0 and 1, at offsets 0
  and 2 floats, of random float32 [B, 786] tensors;
  tests/fixtures/h100_row_sums.npz), and no other count of threads does:
  the rows tell the counts apart."""
  d = np.load(os.path.join(os.path.dirname(__file__), 'fixtures',
                           'h100_row_sums.npz'))
  x, want = d[f'x_B{B}'], d[f's_B{B}']
  for t in SP._ROW_SUM_THREADS:
    got = np.concatenate([SP._tree_sums(x[r:r + 1], r * 786 % 4, t)
                          for r in range(2)])
    assert np.array_equal(got, want) == (t == threads), t
    assert SP._tree_sums(x[:0], 2, t).shape == (0,)


@pytest.mark.parametrize('B', [1, 3, 8])
def test_row_sum_threads_are_read_from_the_sums(B, monkeypatch):
  """With torch's row sum replaced by ``_tree_sums`` at 128 threads a row,
  ``_row_sum_threads`` reads 128 back, for rows that start at every offset
  within 16 bytes and batches with fewer rows than offsets."""

  def tree_sum(self, dim, keepdim=False):
    x = self.numpy()
    n = x.shape[1]
    out = np.concatenate([SP._tree_sums(x[r:r + 1], r * n % 4, 128)
                          for r in range(x.shape[0])])
    return torch.from_numpy(out)[:, None]

  monkeypatch.setattr(torch.Tensor, 'sum', tree_sum)
  for n in (786, 787, 788):
    assert SP._row_sum_threads(B, n, 'cpu') == 128, n


def test_library_orders_are_none_where_the_row_sums_are_no_tree():
  """The CPU's row sums are of none of the trees the kernel sums in
  (``_row_sum_threads``), so the orders read there are None."""
  for B in (1, 2, 8):
    assert SP._row_sum_threads(B, 786, 'cpu') is None
  rows, ops, *_ = _operands(2)
  J, X, R, JE, AIE, EEinv = ops
  assert SP.library_orders(J, X, JE, AIE, EEinv) is None


def test_psd_form_library_is_keyed_by_groups_form_and_orders():
  spec = SP.build_spec(64, 786, 39, 6, 128, 9, ngrp=6, orders=ORDERS)
  path, args = build.psd_library(spec)
  assert '-DPSD_NGRP=6' in args and '-DPSD_FORM=1' in args
  assert '-DPSD_GU=4' in args and '-DPSD_WU=64' in args
  other = SP.build_spec(64, 786, 39, 6, 128, 9, ngrp=6,
                        orders=dict(ORDERS, gu=8))
  assert build.psd_library(other)[0] != path
  assert build._load_psd.cache_info().currsize == 0      # nvcc never ran


def test_psd_solve_checks_the_rolling_and_weld_operands():
  rows, ops, b, precond, f0, cone = _operands(4, 6)
  J, X, R, JE, AIE, EEinv = ops
  mu_t, mu_tor, mu_roll, con_act, lim_act = cone
  kw = dict(K=rows.Kc, nlim=2, iterations=3)
  args = tuple(t.contiguous() for t in (J, X, AIE, EEinv, R, b, precond, f0,
                                        mu_t, mu_tor, con_act, lim_act))
  with pytest.raises(ValueError, match='mu_roll must be'):
    SP.psd_solve(*args, **kw, mu_roll=mu_roll[:, :3].contiguous(), J_E=JE)
  with pytest.raises(ValueError, match='J_E must be'):
    SP.psd_solve(*args, **kw, mu_roll=mu_roll, J_E=JE[:, :2].contiguous())
  with pytest.raises(ValueError, match='4\\*K'):
    SP.psd_solve(args[0][:, :20].contiguous(),
                 args[1][:, :, :20].contiguous(),
                 args[2][:, :20].contiguous(), args[3],
                 *(t[:, :20].contiguous() for t in args[4:8]), *args[8:],
                 **kw)
  assert SP.psd_solve.launches == 0
