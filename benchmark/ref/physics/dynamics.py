"""Smooth (unconstrained) dynamics: mass matrix, bias, passive, actuation.

Counterpart of ``geeco_tpu/physics/dynamics.py``, batched over a leading env
axis B:
  M(q)      = Σ_b m_b Jp_bᵀ Jp_b + Jr_bᵀ I_b^w Jr_b   (einsum over bodies)
  bias(q,v) = Σ_b Jp_bᵀ m_b (a_b − g) + Jr_bᵀ (I_b^w α_b + ω_b × I_b^w ω_b)
where (a_b, α_b) = d/dt (J_b v) at constant v come from one
``torch.func.jvp`` through the batched forward kinematics.

Joint damping is implicit in the integrator: the velocity update solves
(M + h·diag(damping)), which the reference's 1e11 world-slide damping needs
at h = 2 ms.  ``mass_inverse`` picks how, as in the JAX package: 'chol'
factorizes it (``torch.linalg.cholesky``; the solver then applies the
inverse with ``torch.cholesky_solve``), 'blockgj' forms the explicit
inverse by block-diagonal Gauss-Jordan elimination (``physics/linalg.py``),
which the solver applies as a matrix product.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as gm
from ..core.model import Kin, Model, State
from . import kinematics as K
from . import linalg as L


class Smooth(NamedTuple):
  kin: Kin
  info: K.DofInfo
  M: torch.Tensor            # [B, nv, nv] mass matrix (incl. armature)
  M_impl: torch.Tensor       # [B, nv, nv] M + h*diag(damping)
  chol: torch.Tensor | None  # [B, nv, nv] LOWER Cholesky factor of M_impl
  #                            ('chol')
  qfrc_smooth: torch.Tensor  # [B, nv] applied + bias-compensated force
  qacc_smooth: torch.Tensor  # [B, nv] unconstrained acceleration
  minv: torch.Tensor | None = None  # [B, nv, nv] M_impl^-1 ('blockgj')


def inertia_world(model: Model, kin: Kin) -> torch.Tensor:
  """Rotational inertia of each body in world frame [B, nbody, 3, 3]."""
  iquat_mat = gm.quat_to_mat(model.body_iquat)      # [nbody, 3, 3]
  R = torch.einsum('zbij,bjk->zbik', kin.ximat, iquat_mat)
  return torch.einsum('zbij,bj,zbkj->zbik', R, model.body_inertia, R)


def mass_matrix(model: Model, kin: Kin, jacp: torch.Tensor,
                jacr: torch.Tensor) -> torch.Tensor:
  Iw = inertia_world(model, kin)
  M = torch.einsum('zbdi,b,zbei->zde', jacp, model.body_mass, jacp)
  M = M + torch.einsum('zbdi,zbij,zbej->zde', jacr, Iw, jacr)
  return M + torch.diag(model.dof_armature)


def kin_and_bias(model: Model, state: State, anc_mask: np.ndarray):
  """One jvp sweep through FK yields the kinematics, Jacobians AND the
  bias-force ingredients (body accelerations at constant qvel).

  Returns (kin, info, jacp, jacr, qfrc_bias).  The primal pass of the jvp
  is the forward kinematics.
  """
  qvel = state.qvel

  def body_twists(qpos):
    kin_q = K.fk(model, state.replace(qpos=qpos))
    info_q = K.dof_info(model, kin_q)
    jp, jr = K.com_jacobians(model, kin_q, info_q, anc_mask)
    v = torch.einsum('zbdi,zd->zbi', jp, qvel)
    w = torch.einsum('zbdi,zd->zbi', jr, qvel)
    kin_leaves = tuple(getattr(kin_q, f.name) for f in dataclasses.fields(Kin))
    return (v, w), (kin_leaves, info_q.axis, info_q.anchor, jp, jr)

  tangent = K.qpos_tangent(model, state.qpos, qvel)
  (v, w), (a, alpha), aux = torch.func.jvp(
      body_twists, (state.qpos,), (tangent,), has_aux=True)
  kin_leaves, axis, anchor, jacp, jacr = aux
  kin = Kin(*kin_leaves)
  info = K.DofInfo(axis=axis, anchor=anchor,
                   is_rot=K._c(model, 'is_rot'),
                   is_trans=K._c(model, 'is_trans'))

  Iw = inertia_world(model, kin)
  g = model.opt.gravity
  f_lin = model.body_mass[:, None] * (a - g)           # [B, nbody, 3]
  Iww = torch.einsum('zbij,zbj->zbi', Iw, w)
  f_ang = torch.einsum('zbij,zbj->zbi', Iw, alpha) + gm.cross(w, Iww)
  qfrc_bias = (torch.einsum('zbdi,zbi->zd', jacp, f_lin) +
               torch.einsum('zbdi,zbi->zd', jacr, f_ang))
  return kin, info, jacp, jacr, qfrc_bias


def passive_force(model: Model, state: State) -> torch.Tensor:
  """Joint spring forces (damping is implicit in the integrator)."""
  ks = K.kin_static(model)
  qfrc = state.qvel.new_zeros(state.qvel.shape)
  if len(ks.sj):
    sj = K._c(model, 'sj')
    stiff = model.jnt_stiffness[sj]
    springref = model.jnt_springref[sj]
    qfrc[:, K._c(model, 'sj_dadr')] = -stiff * (
        state.qpos[:, K._c(model, 'sj_qadr')] - springref)
  return qfrc


def actuator_force(model: Model, state: State) -> torch.Tensor:
  """Position-servo torques mapped into dof space (vectorised)."""
  qfrc = state.qvel.new_zeros(state.qvel.shape)
  if model.nu == 0:
    return qfrc
  jid = model.actuator_jntid
  qadr = model.const('act_qadr', [model.jnt_qposadr[j] for j in jid])
  dadr = model.const('act_dadr', [model.jnt_dofadr[j] for j in jid])
  ctrl = torch.clamp(state.ctrl, model.actuator_ctrlrange[:, 0],
                     model.actuator_ctrlrange[:, 1])
  qfrc[:, dadr] = model.actuator_kp * (ctrl - state.qpos[:, qadr])
  return qfrc


def fluid_force(model: Model, state: State, kin: Kin, jacp: torch.Tensor,
                jacr: torch.Tensor) -> torch.Tensor:
  """Quadratic drag from ambient fluid density (inertia-box model)."""
  density = model.opt.density
  v = torch.einsum('zbdi,zd->zbi', jacp, state.qvel)  # COM linear velocity
  m = torch.clamp(model.body_mass, min=1e-9)
  I = model.body_inertia
  box2 = torch.stack([
      (I[:, 1] + I[:, 2] - I[:, 0]),
      (I[:, 0] + I[:, 2] - I[:, 1]),
      (I[:, 0] + I[:, 1] - I[:, 2]),
  ], -1) * (3.0 / (2.0 * m[:, None]))
  half = torch.sqrt(torch.clamp(box2, min=1e-12))
  area = 4.0 * torch.stack([half[:, 1] * half[:, 2], half[:, 0] * half[:, 2],
                            half[:, 0] * half[:, 1]], -1)
  mean_area = area.mean(dim=-1, keepdim=True)           # [nbody, 1]
  drag = -0.5 * density * mean_area * gm.norm(v, keepdim=True) * v
  drag = torch.where(model.body_mass[:, None] > 0, drag,
                     torch.zeros((), dtype=drag.dtype, device=drag.device))
  return torch.einsum('zbdi,zbi->zd', jacp, drag)


def smooth_dynamics(model: Model, state: State, anc_mask: np.ndarray,
                    dt, mass_inverse: str = 'chol') -> Smooth:
  """``mass_inverse``: 'chol' (the Cholesky factor, solved lazily) or
  'blockgj' (the explicit inverse, ``linalg.spd_block_inverse``): the same
  math, set ``chol`` or ``minv``."""
  if mass_inverse not in ('chol', 'blockgj'):
    raise ValueError(f'unknown mass_inverse {mass_inverse!r}')
  kin, info, jacp, jacr, qfrc_bias = kin_and_bias(model, state, anc_mask)
  M = mass_matrix(model, kin, jacp, jacr)
  qfrc = (actuator_force(model, state) + passive_force(model, state) +
          fluid_force(model, state, kin, jacp, jacr) - qfrc_bias)
  M_impl = M + dt * torch.diag(model.dof_damping)
  # implicit damping consumes existing momentum too:
  #   (M + h D) v' = M v + h (qfrc - D·0)  =>  acc = Minv_impl (qfrc - D v)
  qfrc_total = qfrc - model.dof_damping * state.qvel
  if mass_inverse == 'blockgj':
    minv = L.spd_block_inverse(M_impl, L.dof_blocks(anc_mask))
    qacc = torch.einsum('zij,zj->zi', minv, qfrc_total)
    return Smooth(kin=kin, info=info, M=M, M_impl=M_impl, chol=None,
                  qfrc_smooth=qfrc_total, qacc_smooth=qacc, minv=minv)
  chol = torch.linalg.cholesky(M_impl)
  qacc = torch.cholesky_solve(qfrc_total[..., None], chol)[..., 0]
  return Smooth(kin=kin, info=info, M=M, M_impl=M_impl, chol=chol,
                qfrc_smooth=qfrc_total, qacc_smooth=qacc)
