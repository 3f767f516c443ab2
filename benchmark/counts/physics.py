"""Operations of one physics substep of one env, from the configuration's
shapes.

The substep's counted terms (operations = 2 x multiply-adds for products):
  * ``mass_factor``: the Cholesky factor of the nv x nv mass matrix,
    nv^3 / 3;
  * ``delassus_solves``: M^-1 J^T by two triangular solves per constraint
    row, 2 nv^2 per row, over the nI + nE rows solved;
  * ``delassus_rows``: the diagonal of J M^-1 J^T and J qacc_smooth, 2 nv
    each per row;
  * ``weld_schur``: the nE weld rows eliminated by Schur complement: J_E X_E
    (2 nE^2 nv), J_I X_E (2 nI nE nv), A_EE^-1 A_IE^T (2 nE^2 nI), the
    reduced diagonal (2 nI nE), the inverse of A_EE (2 nE^3);
  * ``iterations``: each projected-steepest-descent iteration applies the
    reduced operator twice, X_I f (2 nv nI), J_I u (2 nI nv), J_E u
    (2 nE nv), A_EE^-1 (2 nE^2), A_IE (2 nI nE) and R f (2 nI) each, and
    takes ``VECTOR_OPS_PER_ROW`` operations a row for the step sizes,
    the update and the cone projection;
  * ``qacc``: qacc_smooth + M^-1 J^T f, 2 nv (nI + nE).
Not counted (gathers, elementwise work and small products whose size the
configuration does not state): kinematics, bias forces, the mass matrix's
assembly, collision and the contact rows' assembly, integration.  The
count is a floor of the substep's work.

nI = ngrp * contact_rows + 2 * joint_limits (the inequality rows),
nE = 6 * welds.
"""

from __future__ import annotations

from typing import Dict

VECTOR_OPS_PER_ROW = 10
APPLICATIONS_PER_ITERATION = 2


def substep_terms(nv: int, contact_rows: int, ngrp: int, joint_limits: int,
                  welds: int, iterations: int) -> Dict[str, float]:
  """The counted operations of one substep of one env, term by term."""
  nI = ngrp * contact_rows + 2 * joint_limits
  nE = 6 * welds
  rows = nI + nE
  apply = (2 * nv * nI + 2 * nI * nv + 2 * nE * nv + 2 * nE * nE +
           2 * nI * nE + 2 * nI)
  return {
      'mass_factor': nv ** 3 / 3,
      'delassus_solves': 2 * nv * nv * rows,
      'delassus_rows': 2 * 2 * nv * rows,
      'weld_schur': (2 * nE * nE * nv + 2 * nI * nE * nv + 2 * nE * nE * nI
                     + 2 * nI * nE + 2 * nE ** 3),
      'iterations': iterations * (APPLICATIONS_PER_ITERATION * apply +
                                  VECTOR_OPS_PER_ROW * nI),
      'qacc': 2 * nv * rows,
  }


def control_step_flops(shapes: Dict, envs: int) -> float:
  """Counted float32 operations of one control step of ``envs`` envs:
  ``shapes`` holds nv, contact_rows, ngrp, joint_limits, welds, iterations
  and substeps."""
  per = substep_terms(shapes['nv'], shapes['contact_rows'], shapes['ngrp'],
                      shapes['joint_limits'], shapes['welds'],
                      shapes['iterations'])
  return float(sum(per.values())) * shapes['substeps'] * envs
