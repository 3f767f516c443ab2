"""The contact solver's projected iteration written over explicit tensors
(``geeco_tpu_torch/physics/solver.py`` ``_solve_rows``), which the last of
the substep's CUDA graphs records on the card
(``physics/substep_graph.py``; its own tests are
``tests/test_torch_substep_graph.py``).

On the CPU the loop of small kernels runs: no chain of graphs is made,
``solver.graphed_iterations`` reads 0 while ``solver.iterations`` counts
every iteration, and the iteration gives the forces of the closure-based
solve kept below as ``_closure_solve`` bit for bit.  An input that
autograd tracks gets the loop, and gradients through it.  On the card
(skipped without one) a solve inside a caller's capture records the loop
into it, counts those iterations as graphed (they run as its replay) and
gives the eager loop's forces.  tests/conftest.py imports JAX, which the
card lacks, so there the file runs without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_solver_graph.py

This file imports no JAX.
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from geeco_tpu_torch.core import mjcf
from geeco_tpu_torch.core.model import make_state, set_joint_qpos
from geeco_tpu_torch.envs.base import ASSET_ROOT, MODEL_XML
from geeco_tpu_torch.physics import collision as C
from geeco_tpu_torch.physics import dynamics as D
from geeco_tpu_torch.physics import solver as S
from geeco_tpu_torch.physics import substep_graph as SG
from geeco_tpu_torch.physics.step import build_stepper
from geeco_tpu_torch.utils import profiling

torch.set_num_threads(1)

METHODS = ('psd', 'cg', 'bb', 'apgd', 'psd_block', 'bb_block')

# two boxes on the floor and no weld (nE = 0); condim 6 with a rolling
# coefficient, so that rolling='auto' gives the rolling rows (ngrp = 6)
BOXES = """
<mujoco>
  <option timestep="0.002" density="0"/>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="5 5 1" condim="6"
          friction="1.0 0.005 0.002"/>
    <body name="b1" pos="0 0 0.0248">
      <joint type="free"/>
      <geom type="box" size="0.025 0.025 0.025" condim="6" mass="2"
            friction="1.0 0.005 0.002"/>
    </body>
    <body name="b2" pos="0.01 0.005 0.0745">
      <joint type="free"/>
      <geom type="box" size="0.025 0.025 0.025" condim="6" mass="1"
            friction="1.0 0.005 0.002"/>
    </body>
  </worldbody>
</mujoco>
"""


@functools.lru_cache(maxsize=None)
def _model(scene: str):
  if scene == 'pad2-cube2':
    return mjcf.load_model(os.path.join(ASSET_ROOT, 'envs',
                                        MODEL_XML[scene]))[0]
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, 'boxes.xml')
    with open(path, 'w') as f:
      f.write(BOXES)
    return mjcf.load_model(path)[0]


def _start(scene: str, B: int, device='cpu', **stepper_kw):
  """(stepper, state): B envs of the scene with their objects resting on
  the table or floor (a few settling substeps on the CPU, each env a few
  mm apart), moved to ``device``."""
  m = _model(scene)
  st = build_stepper(m, **stepper_kw)
  state = st.init_state(make_state(m, B))
  q = state.qpos
  shift = torch.arange(B, dtype=torch.float32)[:, None] * 0.004
  if scene == 'pad2-cube2':
    for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                      ('robot0:slide2', 0.0)):
      q = set_joint_qpos(m, q, name, val)
    for name, xy in (('object0:joint', (1.3, 0.6)),
                     ('object1:joint', (1.25, 0.9))):
      pose = torch.tensor([xy[0], xy[1], 0.3075, 1.0, 0.0, 0.0, 0.0])
      q = set_joint_qpos(m, q, name, pose + torch.cat(
          [shift, torch.zeros(B, 6)], 1))
  else:
    q = q + torch.cat([shift, torch.zeros(B, q.shape[1] - 1)], 1)
  state = state.replace(qpos=q)
  for _ in range(4):
    state = st.substep(state, 20, 'psd')
  if device != 'cpu':
    st = st._replace(model=m.to(device))
    state = state.to(device)
  return st, state


def _solve_inputs(st, state):
  """What ``Stepper._substep_c`` hands ``solve`` in the state's substep."""
  smooth = D.smooth_dynamics(st.model, state, st.anc_mask,
                             st.model.opt.timestep)
  contacts = C.collide(st.model, smooth.kin)
  con = S.make_constraints(st.model, st.cs, smooth, contacts, state,
                           st.anc_mask)
  return smooth, con


def _closure_project(Kc, ngrp, lo_lim, hi_lim, mu_t, mu_tor, mu_roll,
                     con_active, lim_active):
  """The projection as ``solve`` wrote it, a closure over its operands."""

  def project(f):
    cols = []
    if Kc:
      fn = torch.clamp(f[:, 0:Kc], min=0.0) * con_active
      ft1 = f[:, Kc:2 * Kc]
      ft2 = f[:, 2 * Kc:3 * Kc]
      ftor = f[:, 3 * Kc:4 * Kc]
      t_norm = torch.sqrt(ft1 * ft1 + ft2 * ft2 + 1e-18)
      scale = torch.clamp(mu_t * fn / t_norm, max=1.0)
      lim_tor = mu_tor * fn
      cols = [fn, ft1 * scale * con_active, ft2 * scale * con_active,
              torch.maximum(torch.minimum(ftor, lim_tor), -lim_tor) *
              con_active]
      if ngrp == 6:
        lim_r = mu_roll * fn
        for g in (4, 5):
          fr = f[:, g * Kc:(g + 1) * Kc]
          cols.append(torch.maximum(torch.minimum(fr, lim_r), -lim_r) *
                      con_active)
    cols.append(f[:, ngrp * Kc:lo_lim])
    if hi_lim > lo_lim:
      cols.append(torch.clamp(f[:, lo_lim:hi_lim], min=0.0) * lim_active)
    cols.append(f[:, hi_lim:])
    return torch.cat(cols, 1)
  return project


def _closure_solve(model, cs, smooth, con, warmstart, iterations=60,
                   method='psd'):
  """``solve`` as it was written with closures over the call's tensors
  (every method but the fused one), the reference of the explicit
  iteration."""
  B, ne_sel = con.J.shape[0], con.J.shape[1]
  bid, nblocks = None, 0
  if method in S.BLOCK_METHODS:
    quotas = tuple(k for _, k in cs.quota_sel)
    bid = model.const(f'cs.block_ids.{cs.ngrp}.{cs.nlim}.{quotas}',
                      S.block_ids(cs))
    nblocks = int(bid.max()) + 1
  JT = con.J.transpose(1, 2)
  X = torch.cholesky_solve(JT, smooth.chol)
  diagA = torch.einsum('zev,zve->ze', con.J, X)
  R = (1.0 - con.d_imp) / con.d_imp * con.invweight
  b = torch.einsum('zev,zv->ze', con.J, smooth.qacc_smooth) - con.aref
  Kc = cs.ncon_sel
  order = S._row_order(Kc, cs.nlim, cs.neq, cs.ngrp)
  lo_lim, hi_lim = order['lim']
  eq_lo, eq_hi = order['eq']
  nI, nE = eq_lo, eq_hi - eq_lo
  con_active = con.active[:, :Kc].to(X.dtype)
  lim_active = con.active[:, lo_lim:hi_lim].to(X.dtype)

  project = _closure_project(Kc, cs.ngrp, lo_lim, hi_lim, con.mu_t,
                             con.mu_tor, con.mu_roll, con_active, lim_active)

  f0 = project(X.new_zeros((B, ne_sel)) if warmstart is None
               else S.gather_warmstart(cs, con, warmstart))

  def mv(A, v):
    return torch.bmm(A, v[..., None])[..., 0]

  if nE:
    J_I, J_E = con.J[:, :nI], con.J[:, eq_lo:eq_hi]
    X_I, X_E = X[:, :, :nI], X[:, :, eq_lo:eq_hi]
    R_I, R_E = R[:, :nI], R[:, eq_lo:eq_hi]
    b_I, b_E = b[:, :nI], b[:, eq_lo:eq_hi]
    A_EE = torch.bmm(J_E, X_E) + torch.diag_embed(R_E)
    A_EE_inv = torch.linalg.inv(A_EE)
    A_IE = torch.bmm(J_I, X_E)
    Z = torch.bmm(A_EE_inv, A_IE.transpose(1, 2))
    diag_red = diagA[:, :nI] + R_I - torch.einsum('zie,zei->zi', A_IE, Z)
    b_red = b_I - mv(A_IE, mv(A_EE_inv, b_E))
    precond = 1.0 / torch.clamp(diag_red, min=1e-12)

    def A_red(f):
      u = mv(X_I, f)
      return mv(J_I, u) + R_I * f - mv(A_IE, mv(A_EE_inv, mv(J_E, u)))

    fI = S._iterate(A_red, project, f0[:, :nI], b_red, precond, iterations,
                    method, bid, nblocks)
    fE = -mv(A_EE_inv, b_E + mv(A_IE.transpose(1, 2), fI))
    f = torch.cat([fI, fE], 1)
  else:
    precond = 1.0 / (diagA + R + 1e-12)
    f = S._iterate(lambda f: mv(con.J, mv(X, f)) + R * f, project, f0, b,
                   precond, iterations, method, bid, nblocks)
  qacc = smooth.qacc_smooth + mv(X, f)
  return S.scatter_forces(cs, con, f), qacc


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


def _counts(snap):
  c = snap['counters']
  return c.get('solver.iterations'), c.get('solver.graphed_iterations')


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize('scene,rolling,ngrp,nE', [
    ('pad2-cube2', False, 4, 6), ('pad2-cube2', 'auto', 6, 6),
    ('boxes', False, 4, 0), ('boxes', 'auto', 6, 0)])
def test_the_explicit_iteration_gives_the_closure_solves_forces(
    scene, rolling, ngrp, nE):
  st, state = _start(scene, 2, rolling=rolling)
  assert st.cs.ngrp == ngrp and 6 * st.cs.neq == nE
  smooth, con = _solve_inputs(st, state)
  assert con.active[:, :st.cs.ncon_sel].any()
  f, qacc = S.solve(st.model, st.cs, smooth, con,
                    S.minv_jt(smooth, con.J), state.efc_force)
  f_ref, qacc_ref = _closure_solve(st.model, st.cs, smooth, con,
                                   state.efc_force)
  assert torch.equal(f, f_ref) and torch.equal(qacc, qacc_ref)
  assert f[:, :st.cs.ncon].abs().max() > 0


@pytest.mark.parametrize('method', METHODS)
def test_every_method_gives_the_closure_solves_forces(method):
  st, state = _start('pad2-cube2', 2, select_mode='quota')
  smooth, con = _solve_inputs(st, state)
  f, qacc = S.solve(st.model, st.cs, smooth, con,
                    S.minv_jt(smooth, con.J), state.efc_force, 30, method)
  f_ref, qacc_ref = _closure_solve(st.model, st.cs, smooth, con,
                                   state.efc_force, 30, method)
  assert torch.equal(f, f_ref) and torch.equal(qacc, qacc_ref)


def test_on_the_cpu_the_eager_loop_runs_and_no_graph_is_made(tracer):
  st, state = _start('pad2-cube2', 2)
  chains = len(SG._chains)
  profiling.enable()
  st.step(state, n_substeps=2, solver_iterations=60)
  snap = profiling.snapshot()
  assert _counts(snap) == (2 * 60, 0)
  solve = snap['spans']['physics.solve']['counters']
  assert solve['solver.iterations'] == 120
  assert solve['solver.graphed_iterations'] == 0
  assert len(SG._chains) == chains


def _random_rows(seed, device, B=4, K=8, nlim=2, nv=12, nE=6, ngrp=6):
  """Random well-posed operands of ``_solve_rows``: an SPD mass matrix,
  X = M⁻¹Jᵀ, nE weld rows eliminated by their Schur block."""
  g = torch.Generator().manual_seed(seed)

  def rand(*shape):
    return torch.randn(*shape, generator=g, dtype=torch.float64)

  nI = ngrp * K + 2 * nlim
  J, JE = rand(B, nI, nv) / nv ** 0.5, rand(B, nE, nv) / nv ** 0.5
  A = rand(B, nv, nv) / nv ** 0.5
  M = torch.eye(nv) + A @ A.transpose(1, 2)
  X = torch.linalg.solve(M, J.transpose(1, 2))
  XE = torch.linalg.solve(M, JE.transpose(1, 2))
  R = 0.1 + torch.rand(B, nI, generator=g, dtype=torch.float64)
  A_EE_inv = torch.linalg.inv(JE @ XE + 0.5 * torch.eye(nE))
  A_IE = J @ XE
  diag = torch.einsum('biv,bvi->bi', J, X) + R - torch.einsum(
      'bie,bef,bif->bi', A_IE, A_EE_inv, A_IE)
  f32 = lambda t: t.to(torch.float32).to(device)
  ops = tuple(map(f32, (J, X, R, JE, A_IE, A_EE_inv)))
  u = lambda *s: torch.rand(*s, generator=g, dtype=torch.float64)
  cone = tuple(map(f32, (0.5 + 0.5 * u(B, K), 0.005 + 0.01 * u(B, K),
                         0.001 + 0.01 * u(B, K), (u(B, K) > 0.3).double(),
                         (u(B, 2 * nlim) > 0.5).double())))
  rows = S._Rows(K, ngrp, ngrp * K, nI)
  return rows, ops, f32(rand(B, nI)), f32(1.0 / diag), f32(rand(B, nI)), cone


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_an_input_that_requires_grad_takes_the_eager_loop(device, tracer):
  if device == 'cuda' and not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the graph path runs only there')
  rows, ops, b, precond, f0, cone = _random_rows(3, device)
  b = b.clone().requires_grad_(True)
  profiling.enable()
  f = S._solve_rows('psd', 20, rows, 0, ops, b, precond, f0, cone)
  assert _counts(profiling.snapshot()) == (20, 0)
  assert f.requires_grad                    # autograd saw the iteration
  f.sum().backward()
  assert torch.isfinite(b.grad).all() and b.grad.abs().max() > 0


def test_where_the_cone_binds_the_explicit_iteration_matches_the_closures():
  """Random operands whose friction forces end on their cones (the resting
  scenes above keep them inside): the explicit iteration against the
  closures over the same tensors."""
  rows, ops, b, precond, f0, cone = _random_rows(9, 'cpu')
  J, X, R, J_E, A_IE, A_EE_inv = ops
  project = _closure_project(rows.Kc, rows.ngrp, rows.lim_lo, rows.lim_hi,
                             *cone)

  def mv(A, v):
    return torch.bmm(A, v[..., None])[..., 0]

  def A_red(f):
    u = mv(X, f)
    return mv(J, u) + R * f - mv(A_IE, mv(A_EE_inv, mv(J_E, u)))

  want = S._iterate(A_red, project, project(f0), b, precond, 60, 'psd')
  got = S._solve_rows('psd', 60, rows, 0, ops, b, precond,
                      S._project(f0, rows, *cone), cone)
  assert torch.equal(got, want)
  K, mu_t, act = rows.Kc, cone[0], cone[3]
  fn, ft = got[:, :K], got[:, K:3 * K].reshape(-1, 2, K)
  on_cone = (act > 0) & (fn > 0) & (ft.norm(dim=1) > 0.999 * mu_t * fn)
  assert on_cone.any()


# ----------------------------------------------------------------- the card


def test_a_solve_under_capture_takes_the_eager_loop(card, tracer):
  """The eager loop (``_solve_rows``' Python loop of small kernels, the
  only one the solver has) is recorded into a caller's graph: its
  iterations count as graphed, since they run as the graph's replay, and
  the replay gives the loop's forces."""
  rows, ops, b, precond, f0, cone = _random_rows(7, card, B=3)
  args = ('bb', 40, rows, 0, ops, b, precond, f0, cone)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    want = S._solve_rows(*args)         # the eager loop, and the warm-up
  torch.cuda.current_stream().wait_stream(side)
  profiling.enable()
  g = torch.cuda.CUDAGraph()
  with torch.cuda.graph(g):
    got = S._solve_rows(*args)
  # the loop recorded into the caller's graph runs as its replay
  assert _counts(profiling.snapshot()) == (40, 40)
  g.replay()
  torch.cuda.synchronize()
  assert torch.equal(got, want)
  assert np.isfinite(got.cpu().numpy()).all()
