"""Full physics step: smooth dynamics -> collide -> solve -> integrate.

Counterpart of ``geeco_tpu/physics/step.py``.  ``build_stepper(model)``
precomputes the static structure; ``Stepper.substep`` and ``Stepper.step``
advance B envs at once (the JAX package vmaps and scans; here the env axis
is written out and the substeps are a Python loop).  ``solver_method`` is
threaded to ``solver.solve``, ``hysteresis`` to ``solver.make_constraints``
and ``mass_inverse`` ('chol' or 'blockgj') to ``dynamics.smooth_factor``;
``build_stepper(select_mode=)`` picks the global top-K or the per-body
quota contact selection.  ``Substep`` holds a substep's pieces in order.

On the card a substep runs as the replay of a chain of CUDA graphs, one
chain per shape (``physics/substep_graph.py``); elsewhere, and under
autograd, eagerly; the results are the same bit for bit.  Where a replay's
factorization or inverse failed, ``step`` and ``substep`` raise at their
end what the eager substep raises at once (``torch.linalg.LinAlgError``).

``unroll`` and ``solver_unroll`` are the JAX package's scan-unroll hints
(how many substeps, and solver iterations, XLA unrolls into one loop
body).  They leave the results unchanged there, and a Python loop has
nothing to unroll, so here they are validated as ``jax.lax.scan`` validates
them and otherwise do nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.model import Kin, Model, State
from ..utils import profiling
from . import collision as C
from . import dynamics as D
from . import kinematics as K
from . import solver as S
from . import substep_graph as SG


def check_unroll(unroll) -> None:
  """Validate a scan-unroll hint as ``jax.lax.scan`` does: a bool or a
  non-negative int."""
  if isinstance(unroll, bool):
    return
  if not isinstance(unroll, int):
    raise TypeError(f'{type(unroll).__name__!r} object cannot be interpreted '
                    'as an integer')
  if unroll < 0:
    raise ValueError('`unroll` must be a `bool` or a non-negative `int`.')


class Stepper(NamedTuple):
  model: Model
  anc_mask: np.ndarray
  cs: S.ConstraintStatic
  ne: int

  def fk(self, state: State) -> Kin:
    return K.fk(self.model, state)

  def _substep_c(self, state: State, solver_iterations: int,
                 solver_method: str, hysteresis: float,
                 contacts: C.Contacts | None, mass_inverse: str = 'chol'
                 ) -> tuple[State, C.Contacts]:
    """One substep: on the card the replay of its chain of CUDA graphs
    (``physics/substep_graph.py``), elsewhere eager, with the same
    results.  Counts ``physics.substeps`` and, of those,
    ``physics.graphed_substeps``."""
    sub = Substep(self, solver_iterations, solver_method, hysteresis,
                  mass_inverse)
    graphed = SG.engages(self, state, contacts)
    profiling.count('physics.substeps')
    profiling.count('physics.graphed_substeps', int(graphed))
    if graphed:
      return SG.substep(sub, state, contacts)
    return sub.run(state, contacts)

  def _advance(self, state: State, qacc: torch.Tensor, f: torch.Tensor
               ) -> State:
    """The semi-implicit update from the solve's accelerations ``qacc``
    and forces ``f``."""
    dt = self.model.opt.timestep
    qvel = state.qvel + dt * qacc
    qpos = K.integrate_qpos(self.model, state.qpos, qvel, dt)
    return state.replace(qpos=qpos, qvel=qvel, time=state.time + dt,
                         efc_force=f)

  def substep(self, state: State, solver_iterations: int = 60,
              solver_method: str = 'psd', hysteresis: float = 0.0,
              solver_unroll: int = 1, mass_inverse: str = 'chol') -> State:
    check_unroll(solver_unroll)
    state = self._substep_c(state, solver_iterations, solver_method,
                            hysteresis, None, mass_inverse)[0]
    SG.raise_faults(state.qpos.device)
    return state

  def step(self, state: State, n_substeps: int = 20,
           solver_iterations: int = 60, collide_every: int = 1,
           solver_method: str = 'psd', hysteresis: float = 0.0,
           unroll: int = 1, solver_unroll: int = 1,
           mass_inverse: str = 'chol') -> State:
    """n_substeps of physics.

    ``collide_every=k`` runs narrowphase collision once per k substeps and
    reuses the contact set for the k-1 following substeps; Jacobians,
    reference accelerations and the solve still use each substep's own
    kinematics.  k=1 (default) collides every substep, as mj_step does.
    """
    check_unroll(unroll)
    check_unroll(solver_unroll)
    k = max(1, collide_every)
    if n_substeps % k:
      raise ValueError(f'n_substeps={n_substeps} is not a multiple of '
                       f'collide_every={k}')
    contacts = None
    for i in range(n_substeps):
      if i % k == 0:
        contacts = None
      state, contacts = self._substep_c(state, solver_iterations,
                                        solver_method, hysteresis, contacts,
                                        mass_inverse)
    SG.raise_faults(state.qpos.device)
    return state

  def init_state(self, state: State) -> State:
    """Attach a zero warmstart vector of the right static size."""
    return state.replace(efc_force=state.qpos.new_zeros(
        (state.qpos.shape[0], self.ne)))


def _call(fn, *args):
  return fn(*args)


class Substep(NamedTuple):
  """One substep's pieces, in the order ``run`` calls them.  Written once:
  the eager substep is ``run`` as it stands, and a chain of CUDA graphs
  (``physics/substep_graph.py``) runs the same sequence to warm up, to
  capture and to replay."""
  stepper: Stepper
  iterations: int
  method: str
  hysteresis: float
  mass_inverse: str

  def smooth(self, state: State) -> D.Smooth:
    """FK with the jvp bias forces, the mass matrix, the forces, M_impl
    and its factor (its inverse under 'blockgj')."""
    st = self.stepper
    return D.smooth_factor(st.model, state, st.anc_mask,
                           st.model.opt.timestep, self.mass_inverse)

  def mass_solve(self, smooth: D.Smooth) -> torch.Tensor:
    """The unconstrained acceleration, through the factor."""
    return D.mass_solve(smooth.chol, smooth.qfrc_smooth)

  def collide(self, smooth: D.Smooth) -> C.Contacts:
    return C.collide(self.stepper.model, smooth.kin)

  def constraints(self, smooth: D.Smooth, contacts: C.Contacts,
                  state: State) -> S.Constraints:
    st = self.stepper
    return S.make_constraints(st.model, st.cs, smooth, contacts, state,
                              st.anc_mask, hysteresis=self.hysteresis)

  def minv_jt(self, smooth: D.Smooth, con: S.Constraints) -> torch.Tensor:
    return S.minv_jt(smooth, con.J)

  def solve(self, state: State, smooth: D.Smooth, con: S.Constraints,
            X: torch.Tensor | None) -> State:
    """The solve, the velocity update and the integration."""
    st = self.stepper
    f, qacc = S.solve(st.model, st.cs, smooth, con, X, state.efc_force,
                      iterations=self.iterations, method=self.method)
    return st._advance(state, qacc, f)

  def run(self, state: State, contacts: C.Contacts | None,
          span=profiling.span, graph=_call, eager=_call
          ) -> tuple[State, C.Contacts]:
    """(the new state, the contacts): the pieces in order, within the four
    physics spans (``span``).  Each piece a CUDA graph can hold is
    called through ``graph(piece, *args)``, each it cannot through
    ``eager``: MAGMA's batched ``cholesky_solve``, which allocates and
    synchronizes, applies the factor to the forces and to Jᵀ under
    'chol'.  ``contacts``: those a substep reuses (``collide_every`` > 1),
    or None to collide."""
    with span('physics.smooth'):
      smooth = graph(self.smooth, state)
      if smooth.chol is not None:
        smooth = smooth._replace(qacc_smooth=eager(self.mass_solve, smooth))
    if contacts is None:
      with span('physics.collide'):
        contacts = graph(self.collide, smooth)
    with span('physics.constraints'):
      con = graph(self.constraints, smooth, contacts, state)
    with span('physics.solve'):
      X = None
      if con.J.shape[1]:
        X = (graph if smooth.chol is None else eager)(self.minv_jt, smooth,
                                                      con)
      state = graph(self.solve, state, smooth, con, X)
    return state, contacts


def build_stepper(model: Model, contact_select_k: int = 128,
                  rolling: str | bool = 'auto',
                  select_mode: str = 'topk', quota_obj: int = 24,
                  quota_mesh: int = 48, quota_robot: int = 32) -> Stepper:
  anc_mask = K.ancestor_mask(model)
  cs = S.constraint_static(model, anc_mask, select_k=contact_select_k,
                           rolling=rolling, select_mode=select_mode,
                           quota_obj=quota_obj, quota_mesh=quota_mesh,
                           quota_robot=quota_robot)
  return Stepper(model=model, anc_mask=anc_mask, cs=cs, ne=cs.ne)
