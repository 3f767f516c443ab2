"""Constraint assembly + projected-gradient contact solver.

Counterpart of ``geeco_tpu/physics/solver.py``, with a leading env axis B
on every dynamic tensor.  MuJoCo-style soft constraints (solref/solimp
impedance, reference accelerations, R-regularisation) are solved in the
dual (force) space with a diagonally preconditioned projected iteration;
friction cones are elliptic.

Row layout (static per model):
  [ncon * ngrp]  contact rows: (normal, tangent1, tangent2, torsional
                 [, roll1, roll2])
  [nlim * 2]     joint-limit rows (lower, upper)
  [neq * 6]      weld rows (3 translation + 3 rotation)

``constraint_static`` is host-side numpy, carried across, with the JAX
package's ``rolling`` and ``select_mode`` options: ``'topk'`` solves the K
deepest contacts, ``'quota'`` the deepest few of each free body's rows
(``_quota_groups``).  ``solve`` takes every method of the JAX package
(``METHODS``): the iterations ``psd``, ``cg``, ``bb`` and ``apgd``, the
per-island block variants ``psd_block`` and ``bb_block`` (quota selection
only: their row blocks are the quota groups, ``block_ids``), and
``'pallas'``, which runs the PSD iteration as one fused kernel per substep
(``solver_pallas.psd_solve``) in the TPU kernel's form when the rows form 4
contact groups (ngrp=4, no rolling rows), and the ``'psd'`` iteration
otherwise, as the JAX package does.  On the card the ``'psd'`` iteration
itself is one launch of that kernel in its form 1, which gives the eager
loop's forces bit for bit, wherever the kernel has a plan for the shapes
(``_solve_rows``, ``fuses``; the first solve of an operands' layout holds
the kernel to the loop and raises where they differ); the other methods'
iterations are a loop of small kernels.  Either is recorded into the last of the substep's CUDA
graphs (``physics/substep_graph.py``) and replays with it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import math as gm
from ..core.model import FREE, MESH, Model, State, make_state
from ..utils import profiling
from . import collision as C
from . import dynamics as D
from . import kinematics as K
from . import linalg as L
from . import solver_pallas as SP

METHODS = ('psd', 'cg', 'bb', 'apgd', 'psd_block', 'bb_block', 'pallas')
BLOCK_METHODS = ('psd_block', 'bb_block')


class ConstraintStatic(NamedTuple):
  """Static constraint layout for a model (numpy)."""
  ncon: int
  nlim: int
  neq: int
  ne: int
  con_body1: np.ndarray     # [ncon]
  con_body2: np.ndarray     # [ncon]
  con_friction: np.ndarray  # [ncon, 3]
  con_solref: np.ndarray    # [ncon, 2]
  con_solimp: np.ndarray    # [ncon, 3]
  con_condim: np.ndarray    # [ncon]
  lim_dof: np.ndarray       # [nlim]
  lim_qadr: np.ndarray      # [nlim]
  lim_range: np.ndarray     # [nlim, 2]
  lim_solref: np.ndarray    # [nlim, 2]
  lim_solimp: np.ndarray    # [nlim, 3]
  invweight: np.ndarray     # [ne] reference-pose inverse weight per row
  ncon_sel: int             # active-set size (top-K contacts solved)
  ngrp: int                 # contact row groups: 4, or 6 with rolling rows
  # quota selection: (candidate-index array, k) per group, or None for the
  # global top-K.  The groups partition the candidate rows by the free body
  # they constrain (robot/static rows in a group of their own), so depth
  # ranks on robot rows cannot change which rows a resting body keeps.
  quota_sel: Optional[Tuple[Tuple[np.ndarray, int], ...]] = None


def _reference_pose_jacobians(model: Model, anc_mask: np.ndarray):
  """(jacp, jacr, M^-1) at the reference pose, float64 numpy."""
  state0 = make_state(model, 1)
  kin = K.fk(model, state0)
  info = K.dof_info(model, kin)
  jacp, jacr = K.com_jacobians(model, kin, info, anc_mask)
  M = D.mass_matrix(model, kin, jacp, jacr)[0]
  Minv = np.linalg.inv(M.cpu().numpy().astype(np.float64))
  return (jacp[0].cpu().numpy().astype(np.float64),
          jacr[0].cpu().numpy().astype(np.float64), Minv)


def _body_invweights(model: Model, anc_mask: np.ndarray) -> np.ndarray:
  """Reference-pose inverse weights [nbody, 2] (translation, rotation):
  mean diagonal of J M(q0)^-1 Jᵀ at each COM, like MuJoCo's
  body_invweight0, so regularisation does not collapse near kinematic
  singularities."""
  jp, jr, Minv = _reference_pose_jacobians(model, anc_mask)
  A_t = np.einsum('bvi,vw,bwi->b', jp, Minv, jp) / 3.0
  A_r = np.einsum('bvi,vw,bwi->b', jr, Minv, jr) / 3.0
  return np.stack([A_t, A_r], -1).astype(np.float32)


def _dof_invweights(model: Model, anc_mask: np.ndarray) -> np.ndarray:
  _, _, Minv = _reference_pose_jacobians(model, anc_mask)
  return np.diag(Minv).astype(np.float32)


def _quota_groups(model: Model, b1: np.ndarray, b2: np.ndarray,
                  quota_obj: int, quota_mesh: int, quota_robot: int
                  ) -> Tuple[Tuple[np.ndarray, int], ...]:
  """Partition the candidate contact rows into per-free-body quota groups.

  Row -> group: the free body it constrains (rows between two free bodies
  go to the lower body id); rows touching no free body (robot, table,
  walls) form the 'robot' group, last.  Bodies with mesh-hull geoms get
  the larger ``quota_mesh`` budget (hull face manifolds give more
  simultaneous rows than a box's).
  """
  free = {int(model.jnt_bodyid[j]) for j in range(model.njnt)
          if model.jnt_type[j] == FREE}
  g_body = np.asarray(model.geom_bodyid)
  g_type = np.asarray(model.geom_type)
  has_mesh = {b: bool(np.any((g_body == b) & (g_type == MESH)))
              for b in free}
  groups: dict = {b: [] for b in sorted(free)}
  groups['robot'] = []
  for i in range(len(b1)):
    f1 = int(b1[i]) in free
    f2 = int(b2[i]) in free
    if f1 and f2:
      groups[min(int(b1[i]), int(b2[i]))].append(i)
    elif f1:
      groups[int(b1[i])].append(i)
    elif f2:
      groups[int(b2[i])].append(i)
    else:
      groups['robot'].append(i)
  out = []
  for key, rows in groups.items():
    if not rows:
      continue
    if key == 'robot':
      k = min(len(rows), quota_robot)
    else:
      k = min(len(rows), quota_mesh if has_mesh[key] else quota_obj)
    out.append((np.asarray(rows, np.int32), k))
  return tuple(out)


def constraint_static(model: Model, anc_mask: np.ndarray,
                      select_k: int = 128,
                      rolling: str | bool = 'auto',
                      select_mode: str = 'topk',
                      quota_obj: int = 24, quota_mesh: int = 48,
                      quota_robot: int = 32) -> ConstraintStatic:
  """The static row layout.  ``rolling``: True forces the two rolling
  groups (ngrp=6), False leaves them out (ngrp=4), 'auto' emits them only
  where a condim-6 pair has a rolling coefficient above 1e-3 (MuJoCo's
  default is 1e-4).  ``select_mode``: 'topk' (the ``select_k`` deepest
  contacts) or 'quota' (the deepest of each quota group; K is then the sum
  of the quotas)."""
  b1, b2, fric, solref, solimp, condim = C.contact_params(model)
  ncon = len(b1)
  quota_sel = None
  if select_mode == 'quota' and ncon:
    quota_sel = _quota_groups(model, b1, b2, quota_obj, quota_mesh,
                              quota_robot)
    select_k = sum(k for _, k in quota_sel)
  elif select_mode not in ('topk', 'quota'):
    raise ValueError(f'unknown select_mode {select_mode!r}')
  ncon_sel = min(ncon, select_k) if select_k else ncon
  if rolling == 'auto':
    rolling = bool(ncon) and bool(
        np.any((condim >= 6) & (fric[:, 2] > 1e-3)))
  ngrp = 6 if rolling else 4
  lim_dof, lim_qadr, lim_range, lim_solref, lim_solimp = [], [], [], [], []
  jnt_range = model.jnt_range.cpu().numpy()
  jnt_solref = model.jnt_solref.cpu().numpy()
  jnt_solimp = model.jnt_solimp.cpu().numpy()
  for j in range(model.njnt):
    if model.jnt_limited[j]:
      lim_dof.append(model.jnt_dofadr[j])
      lim_qadr.append(model.jnt_qposadr[j])
      lim_range.append(jnt_range[j])
      lim_solref.append(jnt_solref[j])
      lim_solimp.append(jnt_solimp[j])
  nlim = len(lim_dof)
  ne = ncon * ngrp + nlim * 2 + model.neq * 6

  binvw = _body_invweights(model, anc_mask)
  dinvw = _dof_invweights(model, anc_mask)
  con_w_t = binvw[b1, 0] + binvw[b2, 0] if ncon else np.zeros(0)
  con_w_r = binvw[b1, 1] + binvw[b2, 1] if ncon else np.zeros(0)
  lim_w = dinvw[np.asarray(lim_dof, np.int32)] if nlim else np.zeros(0)
  eq_w = []
  for e in range(model.neq):
    w1 = binvw[model.eq_body1[e]]
    w2 = binvw[model.eq_body2[e]]
    eq_w.extend([w1[0] + w2[0]] * 3)
    eq_w.extend([w1[1] + w2[1]] * 3)
  con_w = [con_w_t, con_w_t, con_w_t, con_w_r]  # n, t1, t2, torsion
  if ngrp == 6:
    con_w += [con_w_r, con_w_r]                 # roll1, roll2
  invweight = np.concatenate(con_w + [
      lim_w, lim_w, np.asarray(eq_w, np.float32),
  ]).astype(np.float32) if ne else np.zeros(0, np.float32)
  invweight = np.maximum(invweight, 1e-8)

  return ConstraintStatic(
      ncon=ncon, nlim=nlim, neq=model.neq, ne=ne,
      con_body1=b1, con_body2=b2, con_friction=fric, con_solref=solref,
      con_solimp=solimp, con_condim=condim,
      lim_dof=np.asarray(lim_dof, np.int32),
      lim_qadr=np.asarray(lim_qadr, np.int32),
      lim_range=np.asarray(lim_range, np.float32).reshape(nlim, 2),
      lim_solref=np.asarray(lim_solref, np.float32).reshape(nlim, 2),
      lim_solimp=np.asarray(lim_solimp, np.float32).reshape(nlim, 3),
      invweight=invweight,
      ncon_sel=ncon_sel,
      ngrp=ngrp,
      quota_sel=quota_sel,
  )


class Constraints(NamedTuple):
  J: torch.Tensor          # [B, ne_sel, nv]
  aref: torch.Tensor       # [B, ne_sel]
  d_imp: torch.Tensor      # [B, ne_sel] impedance in (0, 1)
  active: torch.Tensor     # [B, ne_sel] bool
  invweight: torch.Tensor  # [B, ne_sel]
  mu_t: torch.Tensor       # [B, K] tangential friction per selected contact
  mu_tor: torch.Tensor     # [B, K] torsional friction
  mu_roll: torch.Tensor    # [B, K] rolling friction (used when ngrp == 6)
  sel_idx: torch.Tensor    # [B, K] selected contact indices


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
  """MuJoCo impedance sigmoid d(|pos|) with power=2, midpoint=0.5."""
  dmin, dmax, width = solimp[..., 0], solimp[..., 1], solimp[..., 2]
  x = torch.clamp(pos.abs() / torch.clamp(width, min=1e-9), 0.0, 1.0)
  y = torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) * (1.0 - x))
  return torch.clamp(dmin + y * (dmax - dmin), 1e-4, 1.0 - 1e-6)


def _kb(solref: torch.Tensor, d: torch.Tensor, dmax: torch.Tensor):
  tc = torch.clamp(solref[..., 0], min=1e-6)
  dr = torch.clamp(solref[..., 1], min=1e-6)
  b = 2.0 / (dmax * tc)
  k = d / (dmax * dmax * tc * tc * dr * dr)
  return k, b


def _tangent_frame(n: torch.Tensor):
  """Two unit tangents orthogonal to n (branch-free)."""
  ez = torch.zeros_like(n)
  ez[..., 2] = 1.0
  ex = torch.zeros_like(n)
  ex[..., 0] = 1.0
  ref = torch.where(n[..., 2:3].abs() < 0.9, ez, ex)
  t1 = gm.cross(ref, n)
  t1 = t1 / torch.clamp(gm.norm(t1, keepdim=True), min=1e-9)
  t2 = gm.cross(n, t1)
  return t1, t2


def _select_contacts(score: torch.Tensor, k: int) -> torch.Tensor:
  """Indices of the k smallest scores, lower index first among ties.

  Same selection as ``jax.lax.top_k(-score, k)``: which inactive rows fill
  the active set changes the global step size of the solve, so ties must
  break as in the JAX package.
  """
  return torch.sort(score, dim=-1, stable=True).indices[:, :k]


def make_constraints(model: Model, cs: ConstraintStatic, smooth: D.Smooth,
                     contacts: C.Contacts, state: State,
                     anc_mask: np.ndarray,
                     hysteresis: float = 0.0) -> Constraints:
  """The selected contact rows, the limit rows and the weld rows.

  ``hysteresis`` > 0 gives contacts that carried normal force in the last
  substep (``state.efc_force``) that much depth bonus in the selection, so
  the active set's composition is sticky.
  """
  info = smooth.info
  nv = model.nv
  B = state.qpos.shape[0]
  qvel = state.qvel
  J_rows, aref_rows, d_rows, active_rows, invw_rows = [], [], [], [], []
  empty = qvel.new_zeros((B, 0))
  mu_t = mu_tor = mu_roll = empty
  sel_idx = torch.zeros((B, 0), dtype=torch.int64, device=qvel.device)
  anc = model.const('anc_mask', anc_mask)
  # the per-row weights depend on the row layout: one model may serve
  # steppers with and without the rolling rows
  invw_key = f'cs.invweight.ngrp{cs.ngrp}'

  def rowmv(Jr, v):                     # [B, n, nv] @ [B, nv] -> [B, n]
    return torch.einsum('zcv,zv->zc', Jr, v)

  # ---------------- contacts (top-K active selection) ----------------
  if cs.ncon:
    Kc = cs.ncon_sel
    score = contacts.dist
    if hysteresis > 0.0 and state.efc_force is not None:
      warm_n = state.efc_force[:, :cs.ncon].detach()       # normal rows
      score = score - hysteresis * (warm_n > 0.0).to(score.dtype)
    if cs.quota_sel is not None:
      # top-k within each static group: one body's rows cannot evict
      # another's
      parts = []
      for gi, (idx, k) in enumerate(cs.quota_sel):
        idx_t = model.const(f'cs.quota{gi}', idx)
        parts.append(idx_t[_select_contacts(score[:, idx_t], k)])
      sel_idx = torch.cat(parts, 1)                            # [B, K]
    else:
      sel_idx = _select_contacts(score, Kc)                    # [B, K]

    def gather(x):                       # [B, ncon, ...] at sel_idx
      idx = sel_idx.reshape(sel_idx.shape + (1,) * (x.ndim - 2))
      return torch.gather(x, 1, idx.expand((B, Kc) + x.shape[2:]))

    pts = gather(contacts.pos)
    n = gather(contacts.normal)
    dist = gather(contacts.dist)
    body1 = model.const('cs.con_body1', cs.con_body1)[sel_idx]
    body2 = model.const('cs.con_body2', cs.con_body2)[sel_idx]
    friction = model.const('cs.con_friction', cs.con_friction)[sel_idx]
    solimp = model.const('cs.con_solimp', cs.con_solimp)[sel_idx]
    solref = model.const('cs.con_solref', cs.con_solref)[sel_idx]
    tor_on = model.const('cs.tor_on', (cs.con_condim >= 4).astype(
        np.float32))[sel_idx]
    roll_on = model.const('cs.roll_on', (cs.con_condim >= 6).astype(
        np.float32))[sel_idx]
    invw = model.const(invw_key, cs.invweight)
    inv_t = invw[:cs.ncon][sel_idx]
    inv_r = invw[3 * cs.ncon:4 * cs.ncon][sel_idx]
    mu_t = friction[..., 0]
    mu_tor = friction[..., 1]
    mu_roll = friction[..., 2]

    mask = (anc[body2] - anc[body1])[..., None]              # [B, K, nv, 1]
    r = pts[:, :, None, :] - info.anchor[:, None, :, :]      # [B, K, nv, 3]
    axis = info.axis[:, None].expand(r.shape)
    jp = (info.is_trans[:, None] * axis +
          info.is_rot[:, None] * gm.cross(axis, r))
    Jp_rel = mask * jp
    Jr_rel = mask * info.is_rot[:, None] * axis

    t1, t2 = _tangent_frame(n)
    J_n = torch.einsum('zcvi,zci->zcv', Jp_rel, n)
    J_t1 = torch.einsum('zcvi,zci->zcv', Jp_rel, t1)
    J_t2 = torch.einsum('zcvi,zci->zcv', Jp_rel, t2)
    J_tor = torch.einsum('zcvi,zci->zcv', Jr_rel, n) * tor_on[..., None]

    d_con = impedance(solimp, dist)                           # [B, K]
    k, b = _kb(solref, d_con, solimp[..., 1])

    aref_n = -b * rowmv(J_n, qvel) - k * torch.clamp(dist, max=0.0)
    aref_t1 = -b * rowmv(J_t1, qvel)
    aref_t2 = -b * rowmv(J_t2, qvel)
    aref_tor = -b * rowmv(J_tor, qvel)

    act = dist < 0.0
    groups = [(J_n, aref_n, inv_t), (J_t1, aref_t1, inv_t),
              (J_t2, aref_t2, inv_t), (J_tor, aref_tor, inv_r)]
    if cs.ngrp == 6:  # rolling rows around the two tangents (condim 6)
      J_r1 = torch.einsum('zcvi,zci->zcv', Jr_rel, t1) * roll_on[..., None]
      J_r2 = torch.einsum('zcvi,zci->zcv', Jr_rel, t2) * roll_on[..., None]
      groups += [(J_r1, -b * rowmv(J_r1, qvel), inv_r),
                 (J_r2, -b * rowmv(J_r2, qvel), inv_r)]
    for Jr, ar, iw in groups:
      J_rows.append(Jr)
      aref_rows.append(ar)
      d_rows.append(d_con)
      active_rows.append(act)
      invw_rows.append(iw)

  # ---------------- joint limits ----------------
  if cs.nlim:
    qp = state.qpos[:, model.const('cs.lim_qadr', cs.lim_qadr)]
    lo = model.const('cs.lim_lo', cs.lim_range[:, 0])
    hi = model.const('cs.lim_hi', cs.lim_range[:, 1])
    e_np = np.zeros((cs.nlim, nv), np.float32)
    e_np[np.arange(cs.nlim), cs.lim_dof] = 1.0
    e = model.const('cs.lim_e', e_np).expand(B, cs.nlim, nv)
    solimp = model.const('cs.lim_solimp', cs.lim_solimp)
    solref = model.const('cs.lim_solref', cs.lim_solref)
    base = cs.ngrp * cs.ncon
    lim_invw = model.const(invw_key, cs.invweight)[
        base:base + cs.nlim].expand(B, cs.nlim)
    for pos, Jr in (((qp - lo), e), ((hi - qp), -e)):
      d_l = impedance(solimp, torch.clamp(pos, max=0.0))
      k, b = _kb(solref, d_l, solimp[:, 1])
      aref = -b * rowmv(Jr, qvel) - k * torch.clamp(pos, max=0.0)
      J_rows.append(Jr)
      aref_rows.append(aref)
      d_rows.append(d_l)
      active_rows.append(pos < 0.0)
      invw_rows.append(lim_invw)

  # ---------------- weld equalities ----------------
  kin = smooth.kin
  for e_i in range(model.neq):
    b1 = model.eq_body1[e_i]
    b2 = model.eq_body2[e_i]
    perr = kin.xpos[:, b2] - kin.xpos[:, b1]
    rerr = gm.quat_sub(kin.xquat[:, b2], kin.xquat[:, b1])
    pos6 = torch.cat([perr, rerr], -1)                        # [B, 6]

    point = kin.xpos[:, b2]
    m21 = (anc[b2] - anc[b1])[:, None]                        # [nv, 1]
    rr = point[:, None, :] - info.anchor
    jp = (info.is_trans[:, None] * info.axis +
          info.is_rot[:, None] * gm.cross(info.axis, rr))
    Jp_rel = m21 * jp                                         # [B, nv, 3]
    Jr_rel = m21 * info.is_rot[:, None] * info.axis
    J6 = torch.cat([Jp_rel.transpose(1, 2), Jr_rel.transpose(1, 2)], 1)

    solimp = model.eq_solimp[e_i]
    solref = model.eq_solref[e_i]
    d_e = impedance(solimp[None, :], gm.norm(pos6))           # [B]
    d_e6 = d_e[:, None].expand(B, 6)
    k, b = _kb(solref[None, :], d_e6, solimp[1])
    aref = -b * rowmv(J6, qvel) - k * pos6
    J_rows.append(J6)
    aref_rows.append(aref)
    d_rows.append(d_e6)
    active_rows.append(torch.ones((B, 6), dtype=torch.bool,
                                  device=qvel.device))
    base = cs.ngrp * cs.ncon + 2 * cs.nlim + 6 * e_i
    invw_rows.append(model.const(invw_key, cs.invweight)[
        base:base + 6].expand(B, 6))

  if not J_rows:
    return Constraints(J=qvel.new_zeros((B, 0, nv)), aref=empty,
                       d_imp=empty, active=empty.bool(), invweight=empty,
                       mu_t=empty, mu_tor=empty, mu_roll=empty,
                       sel_idx=sel_idx)

  return Constraints(
      J=torch.cat([j.reshape(B, -1, nv) for j in J_rows], 1),
      aref=torch.cat([a.reshape(B, -1) for a in aref_rows], 1),
      d_imp=torch.cat([d.reshape(B, -1) for d in d_rows], 1),
      active=torch.cat([a.reshape(B, -1) for a in active_rows], 1),
      invweight=torch.cat([w.reshape(B, -1) for w in invw_rows], 1),
      mu_t=mu_t, mu_tor=mu_tor, mu_roll=mu_roll, sel_idx=sel_idx,
  )


def _row_order(ncon: int, nlim: int, neq: int, ngrp: int = 4) -> dict:
  """Index ranges of each row family in a concatenated layout."""
  off = 0
  out = {}
  for name, n in (('con_n', ncon), ('con_t1', ncon), ('con_t2', ncon),
                  ('con_tor', ncon)):
    out[name] = (off, off + n)
    off += n
  if ngrp == 6:
    out['con_roll'] = (off, off + 2 * ncon)
    off += 2 * ncon
  out['lim'] = (off, off + 2 * nlim)
  off += 2 * nlim
  out['eq'] = (off, off + 6 * neq)
  return out


def gather_warmstart(cs: ConstraintStatic, con: Constraints,
                     warm_full: torch.Tensor) -> torch.Tensor:
  """Map a full-layout warmstart [B, ne] onto the selected-row layout."""
  B = warm_full.shape[0]
  Kc = con.sel_idx.shape[1]
  warm2 = warm_full[:, :cs.ngrp * cs.ncon].reshape(B, cs.ngrp, cs.ncon)
  sel = torch.gather(warm2, 2, con.sel_idx[:, None, :].expand(
      B, cs.ngrp, Kc))
  return torch.cat([sel.reshape(B, -1), warm_full[:, cs.ngrp * cs.ncon:]],
                   1)


def scatter_forces(cs: ConstraintStatic, con: Constraints,
                   f_sel: torch.Tensor) -> torch.Tensor:
  """Selected-row forces [B, ne_sel] -> full-layout vector [B, ne]."""
  B = f_sel.shape[0]
  Kc = cs.ncon_sel
  f2 = f_sel[:, :cs.ngrp * Kc].reshape(B, cs.ngrp, Kc)
  full2 = f_sel.new_zeros((B, cs.ngrp, cs.ncon)).scatter(
      2, con.sel_idx[:, None, :].expand(B, cs.ngrp, Kc), f2)
  return torch.cat([full2.reshape(B, -1), f_sel[:, cs.ngrp * Kc:]], 1)


def block_ids(cs: ConstraintStatic) -> Optional[np.ndarray]:
  """Static row -> island-block id over the selected inequality rows.

  One block per quota group (each free body's rows, then the robot/static
  rows, see ``_quota_groups``) and one more for the joint-limit rows.  Only
  quota selection has them: slot j of ``sel_idx`` then belongs to quota
  group q(j) in every env.  Layout as ``_row_order``: ngrp x K contact
  rows, then 2 x nlim limit rows.
  """
  if cs.quota_sel is None:
    return None
  slot_block = np.concatenate(
      [np.full(k, gi, np.int32) for gi, (_, k) in enumerate(cs.quota_sel)]
  ) if cs.quota_sel else np.zeros(0, np.int32)
  nb = len(cs.quota_sel)
  return np.concatenate(
      [np.tile(slot_block, cs.ngrp), np.full(2 * cs.nlim, nb, np.int32)])


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return (x * y).sum(-1, keepdim=True)


def _step(num: torch.Tensor, den: torch.Tensor, floor: float = 1e-12,
          other=0.0) -> torch.Tensor:
  """num / den where den > floor, else ``other``."""
  return torch.where(den > floor, num / torch.clamp(den, min=floor), other)


def _iterate(Aop, project, f0: torch.Tensor, b: torch.Tensor,
             precond: torch.Tensor, iterations: int, method: str = 'psd',
             bid: Optional[torch.Tensor] = None,
             nblocks: int = 0) -> torch.Tensor:
  """Projected iteration on min 1/2 fᵀAf + bᵀf s.t. cone, for B envs.

  A Python loop where the JAX package scans.  Methods:
    psd   preconditioned steepest descent with the exact quadratic step:
          two operator applications an iteration, monotone.
    cg    preconditioned conjugate gradient (Fletcher-Reeves) with
          projection, falling back to the gradient step on non-positive
          curvature (three operator applications: the fallback's is always
          computed, as in the JAX package).
    bb    projected Barzilai-Borwein: the step from the previous (s, y)
          pair, one operator application an iteration.
    apgd  Nesterov-accelerated projected gradient with adaptive restart.
  Block variants (``bid`` [nI] int64, the row -> block map of
  ``block_ids``, with ``nblocks`` blocks, a host int as in the JAX package:
  reading it off ``bid`` would synchronize): a step size per island of
  rows, so a rank change on one island's rows does not move another
  island's forces.
    psd_block  per-block exact steps composed into one direction, then a
               global exact line search along it (three applications).
    bb_block   per-block Barzilai-Borwein steps (one application).
  The per-block sums are a one-hot product over the static ``bid`` (the
  JAX package's ``segment_sum``): no atomics, so the result does not
  depend on the order rows finish in.
  """
  if method in BLOCK_METHODS:
    if bid is None:
      raise ValueError(f"{method!r} requires quota contact selection "
                       "(constraint_static(select_mode='quota'))")
    if nblocks < 1:
      raise ValueError(f'{method!r} needs nblocks, the block count of bid')
    onehot = (bid[:, None] == torch.arange(nblocks, device=bid.device)
              ).to(f0.dtype)

    def seg(x):                                    # [B, nI] -> [B, nblocks]
      return (x[..., None] * onehot).sum(-2)

  if method == 'psd_block':
    f = f0
    for _ in range(iterations):
      g = Aop(f) + b
      d = precond * g
      Ad = Aop(d)
      alpha_b = _step(seg(g * d), seg(d * Ad))
      dp = alpha_b[:, bid] * d
      Adp = Aop(dp)    # A (D d) != D (A d): the composite needs its own Aop
      f = project(f - _step(_dot(g, dp), _dot(dp, Adp)) * dp)
    return f

  if method in ('bb', 'bb_block'):
    # one exact preconditioned-gradient step seeds the (s, y) history
    g0 = Aop(f0) + b
    d0 = precond * g0
    alpha0 = _step(_dot(g0, d0), _dot(d0, Aop(d0)))
    f, f_prev, g_prev = project(f0 - alpha0 * d0), f0, g0
    alpha_prev = torch.clamp(alpha0, min=1e-8)
    if method == 'bb_block':
      alpha_prev = alpha_prev.expand(-1, onehot.shape[1])
    for _ in range(iterations):
      g = Aop(f) + b                      # the ONLY operator application
      s = f - f_prev
      y = g - g_prev
      if method == 'bb':
        # s^T P^-1 s / s^T y (BB1 in the P metric); an unusable curvature
        # pair reuses the previous step size
        alpha = _step(_dot(s, s / precond), _dot(s, y), 1e-14, alpha_prev)
        step = alpha
      else:
        alpha = _step(seg(s * s / precond), seg(s * y), 1e-14, alpha_prev)
        step = alpha[:, bid]
      f, f_prev, g_prev, alpha_prev = project(f - step * precond * g), f, \
          g, alpha
    return f

  if method == 'psd':
    f = f0
    for _ in range(iterations):
      g = Aop(f) + b
      d = precond * g
      f = project(f - _step(_dot(g, d), _dot(d, Aop(d))) * d)
    return f

  if method == 'cg':
    f, d_prev = f0, torch.zeros_like(f0)
    gz_prev = f0.new_zeros((f0.shape[0], 1))
    for _ in range(iterations):
      g = Aop(f) + b
      z = precond * g
      gz = _dot(g, z)
      d = z + _step(gz, gz_prev) * d_prev
      Ad = Aop(d)
      curved = _dot(d, Ad) > 1e-12
      # non-positive curvature along d: the plain gradient step
      d = torch.where(curved, d, z)
      dAd = torch.where(curved, _dot(d, Ad), _dot(z, Aop(z)))
      f, d_prev, gz_prev = project(f - _step(_dot(g, d), dAd) * d), d, gz
    return f

  if method == 'apgd':
    # a psd step taken at the extrapolated point y; the momentum restarts
    # whenever g . (f_new - f) > 0
    f, y, t = f0, f0, f0.new_ones((f0.shape[0], 1))
    for _ in range(iterations):
      g = Aop(y) + b
      d = precond * g
      f_new = project(y - _step(_dot(g, d), _dot(d, Aop(d))) * d)
      restart = _dot(g, f_new - f) > 0.0
      t_new = torch.where(restart, 1.0,
                          0.5 * (1.0 + torch.sqrt(1.0 + 4 * t * t)))
      beta = torch.where(restart, 0.0, (t - 1.0) / t_new)
      f, y, t = f_new, f_new + beta * (f_new - f), t_new
    return f

  raise ValueError(f'unknown solver method {method!r}')


class _Rows(NamedTuple):
  """The iterated rows' static layout (``_row_order``): ``Kc`` selected
  contacts in ``ngrp`` groups of rows, the joint-limit rows
  [lim_lo, lim_hi)."""
  Kc: int
  ngrp: int
  lim_lo: int
  lim_hi: int


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return torch.bmm(A, v[..., None])[..., 0]        # [B, m, n] @ [B, n]


def _apply(f: torch.Tensor, J, X, R, J_E=None, A_IE=None, A_EE_inv=None):
  """The iterated operator: J X f + R f (X = M⁻¹Jᵀ); with the weld rows'
  operands, less their Schur complement A_IE A_EE⁻¹ J_E X f."""
  u = _mv(X, f)
  if J_E is None:
    return _mv(J, u) + R * f
  return _mv(J, u) + R * f - _mv(A_IE, _mv(A_EE_inv, _mv(J_E, u)))


def _project(f: torch.Tensor, rows: _Rows, mu_t, mu_tor, mu_roll,
             con_active, lim_active) -> torch.Tensor:
  """Each selected contact's rows onto its friction cone (elliptic
  tangents, boxed torsion and rolling), the limit rows onto f >= 0, the
  inactive rows to 0; rows past the limits pass."""
  Kc, lo_lim, hi_lim = rows.Kc, rows.lim_lo, rows.lim_hi
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
    if rows.ngrp == 6:
      lim_r = mu_roll * fn
      for g in (4, 5):
        fr = f[:, g * Kc:(g + 1) * Kc]
        cols.append(torch.maximum(torch.minimum(fr, lim_r), -lim_r) *
                    con_active)
  cols.append(f[:, rows.ngrp * Kc:lo_lim])
  if hi_lim > lo_lim:
    cols.append(torch.clamp(f[:, lo_lim:hi_lim], min=0.0) * lim_active)
  cols.append(f[:, hi_lim:])
  return torch.cat(cols, 1)


# the operands' layout (``_layout``) -> the eager loop's summation orders
# on it (``_checked_orders``); ``_checked``: the layouts where the fused
# kernel summed in them gave the loop's finite forces bit for bit
_orders: dict = {}
_checked: set = set()


def _layout(ops, b) -> tuple:
  """What fixes the eager loop's summation orders: the card, the batch,
  and each operand's sizes, strides and offset."""
  return (b.device,) + tuple((tuple(t.shape), t.stride(), t.storage_offset())
                             for t in (*ops, b))


def fuses(method: str, rows: _Rows, ops, b, precond, f0, cone) -> bool:
  """Whether the projected iteration runs as one launch of the fused
  kernel with the eager loop's summation orders (``solver_pallas.psd_solve``
  in form 1): on a card, where ``_fits`` holds.  Decided on what the solve
  observes; everywhere else the eager loop runs."""
  return b.device.type == 'cuda' and _fits(method, rows, ops, b, precond,
                                           f0, cone)


def _fits(method: str, rows: _Rows, ops, b, precond, f0, cone) -> bool:
  """``fuses`` on any device: the method is 'psd', every operand float32
  on ``b``'s device, none that autograd needs, X stored as its transpose's
  rows (as ``mass_inverse='chol'`` leaves it: with X's rows contiguous, as
  under 'blockgj', cuBLAS sums u = X v in an order the kernel does not
  mirror), the rows the contact groups and the limit rows alone, weld
  rows, and a plan for the shapes (``solver_pallas.fused_plan``)."""
  tensors = (*ops, b, precond, f0, *cone)
  dev = b.device
  if (method != 'psd' or len(ops) < 6 or ops[1].stride(1) != 1 or
      any(t.device != dev or t.dtype != torch.float32 for t in tensors)):
    return False
  if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
    return False
  B, nI = b.shape
  if rows.lim_lo != rows.ngrp * rows.Kc or nI != rows.lim_hi:
    return False
  return SP.fused_plan(B, nI, ops[0].shape[2], ops[3].shape[1], rows.Kc,
                       (rows.lim_hi - rows.lim_lo) // 2) is not None


def _fused_psd(iterations: int, rows: _Rows, ops, b, precond, f0, cone,
               orders: dict):
  """The 'psd' iteration as one launch of the fused kernel summed in
  ``orders`` (its plain twin on the CPU), on ``_solve_rows``' operands."""
  J, X, R, J_E, A_IE, EEinv = ops
  mu_t, mu_tor, mu_roll, con_active, lim_active = (t.contiguous()
                                                    for t in cone)
  return SP.psd_solve(
      J, *(t.contiguous() for t in (X, A_IE, EEinv, R, b, precond, f0)),
      mu_t, mu_tor, con_active, lim_active, rows.Kc,
      (rows.lim_hi - rows.lim_lo) // 2, iterations,
      mu_roll=mu_roll if rows.ngrp == 6 else None, J_E=J_E.contiguous(),
      orders=orders)


def _checked_orders(iterations, rows, ops, b, precond, f0, cone, eager):
  """The summation orders of the eager loop on these operands
  (``solver_pallas.library_orders``), and whether the fused kernel summed
  in them gave ``eager``, the loop's forces, bit for bit: False where
  those are not finite (after a failed factor, which the substep raises),
  and nothing is compared.  Raises where the orders are not of the family
  the kernel sums in, or the kernel's forces differ: the kernel has a plan
  for these shapes, and a solve that cannot take it is a fault to mend (a
  library that sums in another order), not a path."""
  where = (f'solver: the fused kernel (solver_pallas.psd_solve, form 1) at '
           f'the layout {_layout(ops, b)}')
  orders = SP.library_orders(ops[0], ops[1], ops[3], ops[4], ops[5])
  if orders is None:
    raise RuntimeError(f'{where}: the eager loop\'s products sum in no '
                       'order of the family the kernel sums in '
                       '(solver_pallas.library_orders)')
  if not bool(torch.isfinite(eager).all()):
    return orders, False
  f = _fused_psd(iterations, rows, ops, b, precond, f0, cone, orders)
  if not torch.equal(f, eager):
    gap = float((f - eager).abs().max())
    raise RuntimeError(f'{where}, summed in {orders}: forces differ from the '
                       f'eager loop\'s by up to {gap:.3g}')
  return orders, True


def _capturing(device: torch.device) -> bool:
  """Whether the current stream of ``device`` is a card's and is capturing
  a CUDA graph."""
  if device.type != 'cuda':
    return False
  with torch.cuda.device(device):
    return torch.cuda.is_current_stream_capturing()


def _solve_rows(method: str, iterations: int, rows: _Rows, nblocks: int,
                ops, b, precond, f0, cone, bid=None) -> torch.Tensor:
  """The projected iteration (``_iterate`` over the operator's operands
  ``ops`` (``_apply``) and the projection's ``cone`` (``_project``)): one
  launch of the fused kernel where ``fuses`` holds, else a loop of small
  kernels; on the card the substep's last CUDA graph records either and
  replays it (``physics/substep_graph.py``).  Until the kernel has been
  held to the loop's finite forces at an operands' layout
  (``_checked_orders``, which raises where they differ), a solve of the
  layout outside a capture runs the loop and holds it so; the first has
  to come before any capture of that layout, as a chain's eager warm-up
  does.
  Counts ``solver.iterations`` and, of those,
  ``solver.graphed_iterations`` (the iterations recorded into a graph
  being captured, which run as its replay) and ``solver.fused_iterations``
  (the iterations the fused kernel runs)."""
  capturing = _capturing(b.device)
  fused = fuses(method, rows, ops, b, precond, f0, cone)
  profiling.count('solver.iterations', iterations)
  profiling.count('solver.graphed_iterations', iterations if capturing else 0)
  profiling.count('solver.fused_iterations', iterations if fused else 0)
  if not fused:
    return _iterate(lambda f: _apply(f, *ops),
                    lambda f: _project(f, rows, *cone), f0, b, precond,
                    iterations, method, bid, nblocks)
  key = _layout(ops, b)
  if key not in _checked and not capturing:
    eager = _iterate(lambda f: _apply(f, *ops),
                     lambda f: _project(f, rows, *cone), f0, b, precond,
                     iterations, method, bid, nblocks)
    _orders[key], checked = _checked_orders(iterations, rows, ops, b,
                                            precond, f0, cone, eager)
    if checked:
      _checked.add(key)
    return eager
  if key not in _orders:
    raise RuntimeError(f'solver: the layout {key} is first solved inside '
                       'a CUDA graph capture, where the fused kernel '
                       'cannot be checked; solve it once before capture')
  return _fused_psd(iterations, rows, ops, b, precond, f0, cone, _orders[key])


def minv_jt(smooth: D.Smooth, J: torch.Tensor) -> torch.Tensor:
  """X = M_impl⁻¹ Jᵀ [B, nv, ne] for rows J [B, ne, nv], as ``smooth``
  carries the inverse: through the factor (``torch.cholesky_solve``) or,
  under 'blockgj', a product with the explicit inverse."""
  JT = J.transpose(1, 2)
  if smooth.minv is not None:
    return torch.bmm(smooth.minv, JT)
  return torch.cholesky_solve(JT, smooth.chol)


def solve(model: Model, cs: ConstraintStatic, smooth: D.Smooth,
          con: Constraints, X: torch.Tensor | None,
          warmstart: torch.Tensor | None, iterations: int = 60,
          method: str = 'psd'):
  """Projected-gradient solve with weld-equality elimination.

  The weld rows couple to the 1e11-damped world slides and dominate the
  dual conditioning; they are solved exactly by Schur complement (they need
  no cone projection) and only the inequality rows are iterated.

  What runs where.  On the CPU every method but ``'pallas'`` iterates in
  PyTorch, one small kernel per operation (``_iterate``).  On the card
  ``'psd'`` runs its whole iteration as one launch of the fused kernel
  (``solver_pallas.psd_solve`` in form 1: this loop's operator
  ``(J_I u + R f) - A_IE (EEinv (J_E u))``, u = X_I f, and projection,
  every sum in the order the loop's ``torch.bmm`` and ``sum`` take it, so
  that the forces are the loop's bit for bit) wherever ``fuses`` holds
  (float32, no autograd, X as ``mass_inverse='chol'`` stores it, weld
  rows, one env's X and rows within a block, as at pad2-cube2's shapes;
  clutter4's and nut-cone's are too large), after a solve of the
  operands' layout held the kernel to the loop, bit for bit
  (``_checked_orders``, which raises where they differ);
  elsewhere, and for the other methods, the loop of small kernels.  Either
  is recorded into the substep's last CUDA graph and replays with it
  (``_solve_rows``, ``physics/substep_graph.py``).  ``method='pallas'`` runs the whole
  iteration as one fused kernel launch (``solver_pallas.psd_solve``: the
  CUDA kernel on the card, its plain twin on the CPU), with the TPU
  kernel's operator form; it needs ngrp=4, and at ngrp=6 (rolling rows) it
  runs the ``'psd'`` iteration, as in the JAX package.  The block methods
  need quota selection.  M⁻¹ is applied as ``smooth`` carries it: the Cholesky factor
  (``torch.cholesky_solve``), or under ``mass_inverse='blockgj'`` the
  explicit inverse.  The weld Schur block is inverted by
  ``torch.linalg.inv`` (``linalg.inv``) under both (the JAX package
  unrolls a Gauss-Jordan inverse there, to avoid While loops on the TPU;
  taking that under 'chol' moves a noisy expert rollout 1.03e-4 from
  JAX's, past the env tests' 1e-4).  ``X`` is M⁻¹Jᵀ (``minv_jt``; None
  where there are no rows), which the substep computes apart: under
  'chol' it is MAGMA's batched solve, which no CUDA graph can hold.
  Returns (f_full [B, ne], qacc [B, nv]).
  """
  if method not in METHODS:
    raise ValueError(f'unknown solver method {method!r}')
  fused = method == 'pallas' and cs.ngrp == 4
  B, ne_sel = con.J.shape[0], con.J.shape[1]
  if ne_sel == 0:
    return smooth.qacc_smooth.new_zeros((B, cs.ne)), smooth.qacc_smooth
  bid, nblocks = None, 0
  if method in BLOCK_METHODS:
    bid_np = block_ids(cs)
    if bid_np is None:
      raise ValueError(f"{method!r} requires quota contact selection "
                       "(constraint_static(select_mode='quota'))")
    quotas = tuple(k for _, k in cs.quota_sel)
    bid = model.const(f'cs.block_ids.{cs.ngrp}.{cs.nlim}.{quotas}', bid_np)
    nblocks = int(bid_np.max()) + 1 if bid_np.size else 1
  it_method = 'psd' if method == 'pallas' else method

  diagA = torch.einsum('zev,zve->ze', con.J, X)
  R = (1.0 - con.d_imp) / con.d_imp * con.invweight
  b = torch.einsum('zev,zv->ze', con.J, smooth.qacc_smooth) - con.aref

  Kc = cs.ncon_sel
  order = _row_order(Kc, cs.nlim, cs.neq, cs.ngrp)
  lo_lim, hi_lim = order['lim']
  eq_lo, eq_hi = order['eq']
  nI = eq_lo                                       # inequality row count
  nE = eq_hi - eq_lo
  profiling.count('contact_rows.iterated', B * nI)
  if profiling.on():
    profiling.count_device('contact_rows.active', con.active[:, :nI].sum())
  con_active = con.active[:, :Kc].to(X.dtype)
  lim_active = con.active[:, lo_lim:hi_lim].to(X.dtype)
  rows = _Rows(Kc, cs.ngrp, lo_lim, hi_lim)
  cone = (con.mu_t, con.mu_tor, con.mu_roll, con_active, lim_active)

  if warmstart is None:
    f0 = X.new_zeros((B, ne_sel))
  else:
    f0 = gather_warmstart(cs, con, warmstart)
  f0 = _project(f0, rows, *cone)

  def fused_solve(J, X_, A_IE, EEinv, R_, b_, precond, f0_):
    """The iteration in one kernel launch (the plain twin on the CPU)."""
    ops = (J, X_, A_IE, EEinv, R_, b_, precond, f0_, con.mu_t, con.mu_tor,
           con_active, lim_active)
    return SP.psd_solve(*(t.contiguous() for t in ops), Kc, cs.nlim,
                        iterations)

  if nE:
    J_I, J_E = con.J[:, :nI], con.J[:, eq_lo:eq_hi]
    X_I, X_E = X[:, :, :nI], X[:, :, eq_lo:eq_hi]
    R_I, R_E = R[:, :nI], R[:, eq_lo:eq_hi]
    b_I, b_E = b[:, :nI], b[:, eq_lo:eq_hi]
    A_EE = torch.bmm(J_E, X_E) + torch.diag_embed(R_E)         # [B, nE, nE]
    A_EE_inv = L.inv(A_EE)                       # the small SPD Schur block
    A_IE = torch.bmm(J_I, X_E)                                 # [B, nI, nE]
    Z = torch.bmm(A_EE_inv, A_IE.transpose(1, 2))              # [B, nE, nI]
    diag_red = diagA[:, :nI] + R_I - torch.einsum('zie,zei->zi', A_IE, Z)
    b_red = b_I - _mv(A_IE, _mv(A_EE_inv, b_E))
    precond = 1.0 / torch.clamp(diag_red, min=1e-12)
    if fused:
      fI = fused_solve(J_I, X_I, A_IE, A_EE_inv, R_I, b_red, precond,
                       f0[:, :nI])
    else:
      fI = _solve_rows(it_method, iterations, rows, nblocks,
                       (J_I, X_I, R_I, J_E, A_IE, A_EE_inv), b_red, precond,
                       f0[:, :nI], cone, bid)
    fE = -_mv(A_EE_inv, b_E + _mv(A_IE.transpose(1, 2), fI))
    f = torch.cat([fI, fE], 1)
  else:
    precond = 1.0 / (diagA + R + 1e-12)
    if fused:
      f = fused_solve(con.J, X, X.new_zeros((B, ne_sel, 0)),
                      X.new_zeros((B, 0, 0)), R, b, precond, f0)
    else:
      f = _solve_rows(it_method, iterations, rows, nblocks, (con.J, X, R),
                      b, precond, f0, cone, bid)

  qacc = smooth.qacc_smooth + _mv(X, f)
  return scatter_forces(cs, con, f), qacc
