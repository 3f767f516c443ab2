"""Full physics step: smooth dynamics -> collide -> solve -> integrate.

Counterpart of ``geeco_tpu/physics/step.py``.  ``build_stepper(model)``
precomputes the static structure; ``Stepper.substep`` and ``Stepper.step``
advance B envs at once (the JAX package vmaps and scans; here the env axis
is written out and the substeps are a Python loop).  ``solver_method`` is
threaded to ``solver.solve`` and ``hysteresis`` to
``solver.make_constraints``; ``build_stepper(select_mode=)`` picks the
global top-K or the per-body quota contact selection.  The TPU-only levers
(``mass_inverse``, the unroll counts) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.model import Kin, Model, State
from . import collision as C
from . import dynamics as D
from . import kinematics as K
from . import solver as S


class Stepper(NamedTuple):
  model: Model
  anc_mask: np.ndarray
  cs: S.ConstraintStatic
  ne: int

  def fk(self, state: State) -> Kin:
    return K.fk(self.model, state)

  def _substep_c(self, state: State, solver_iterations: int,
                 solver_method: str, hysteresis: float,
                 contacts: C.Contacts | None
                 ) -> tuple[State, C.Contacts]:
    model = self.model
    dt = model.opt.timestep
    smooth = D.smooth_dynamics(model, state, self.anc_mask, dt)
    if contacts is None:
      contacts = C.collide(model, smooth.kin)
    con = S.make_constraints(model, self.cs, smooth, contacts, state,
                             self.anc_mask, hysteresis=hysteresis)
    f, qacc = S.solve(model, self.cs, smooth, con, state.efc_force,
                      iterations=solver_iterations, method=solver_method)
    qvel = state.qvel + dt * qacc
    qpos = K.integrate_qpos(model, state.qpos, qvel, dt)
    return state.replace(qpos=qpos, qvel=qvel, time=state.time + dt,
                         efc_force=f), contacts

  def substep(self, state: State, solver_iterations: int = 60,
              solver_method: str = 'psd', hysteresis: float = 0.0) -> State:
    return self._substep_c(state, solver_iterations, solver_method,
                           hysteresis, None)[0]

  def step(self, state: State, n_substeps: int = 20,
           solver_iterations: int = 60, collide_every: int = 1,
           solver_method: str = 'psd', hysteresis: float = 0.0) -> State:
    """n_substeps of physics.

    ``collide_every=k`` runs narrowphase collision once per k substeps and
    reuses the contact set for the k-1 following substeps; Jacobians,
    reference accelerations and the solve still use each substep's own
    kinematics.  k=1 (default) collides every substep, as mj_step does.
    """
    k = max(1, collide_every)
    if n_substeps % k:
      raise ValueError(f'n_substeps={n_substeps} is not a multiple of '
                       f'collide_every={k}')
    contacts = None
    for i in range(n_substeps):
      if i % k == 0:
        contacts = None
      state, contacts = self._substep_c(state, solver_iterations,
                                        solver_method, hysteresis, contacts)
    return state

  def init_state(self, state: State) -> State:
    """Attach a zero warmstart vector of the right static size."""
    return state.replace(efc_force=state.qpos.new_zeros(
        (state.qpos.shape[0], self.ne)))


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
