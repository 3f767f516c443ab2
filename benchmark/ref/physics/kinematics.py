"""Forward kinematics, body Jacobians and qpos integration (PyTorch).

Counterpart of ``geeco_tpu/physics/kinematics.py``.  The tree is vectorised
over joints and bodies: per-joint local transforms in one masked pass,
per-body composition over (padded) joint slots, then every body's world pose
composed along its front-padded ancestor chain with a log2(D) pairwise
reduce.  Every function takes a leading env axis B.

Conventions (as the JAX package, not MuJoCo):
  * free joints use WORLD-frame angular velocity: qvel[3:6] of a free joint
    is world omega and integration left-multiplies the exponential;
  * hinge/slide displacement is (qpos - jnt_ref).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import math as gm
from ..core.model import (FREE, HINGE, JOINT_DOF_DIM, Kin, Model, SLIDE,
                          State)


# ---------------------------------------------------------------------------
# static kinematic structure (host-side numpy, cached per scene topology)
# ---------------------------------------------------------------------------


class KinStatic(NamedTuple):
  """Precomputed index arrays for the vectorised sweeps (all numpy)."""
  sj: np.ndarray          # [ns] joint ids of scalar joints
  sj_qadr: np.ndarray     # [ns] qpos address
  sj_dadr: np.ndarray     # [ns] dof address
  fj: np.ndarray          # [nf] free joint ids
  fj_qadr: np.ndarray     # [nf]
  fj_dadr: np.ndarray     # [nf]
  body_jslot: np.ndarray  # [nbody, JMAX] joint id per slot, -1 = none
  body_free: np.ndarray   # [nbody] free joint id or -1
  body_mocap: np.ndarray  # [nbody] mocap id or -1
  anc: np.ndarray         # [nbody, Dp] ancestor chains, root first
  jnt_qadr: np.ndarray    # [njnt]
  jnt_hinge: np.ndarray   # [njnt] 1.0 where hinge
  jnt_scalar: np.ndarray  # [njnt] 1.0 where slide/hinge
  body_free_inv: np.ndarray  # [nbody] index into fj (0 where none)
  dof_body: np.ndarray    # [nv]
  dof_jnt: np.ndarray     # [nv]
  dof_free: np.ndarray    # [nv] 1.0 for free-joint dofs
  dof_free_axis: np.ndarray  # [nv, 3]
  is_rot: np.ndarray      # [nv]
  is_trans: np.ndarray    # [nv]


@functools.lru_cache(maxsize=32)
def _kin_static(parentid, mocapid, jntadr, jnt_type, jnt_qposadr,
                jnt_dofadr, jnt_bodyid) -> KinStatic:
  nbody = len(parentid)
  njnt = len(jnt_type)
  sj, fj = [], []
  for j in range(njnt):
    if jnt_type[j] == FREE:
      fj.append(j)
    elif jnt_type[j] in (SLIDE, HINGE):
      sj.append(j)
    else:
      raise NotImplementedError('ball joints not used by GEECO scenes')
  sj = np.asarray(sj, np.int32)
  fj = np.asarray(fj, np.int32)

  jmax = max(max((len(a) for a in jntadr), default=0), 1)
  body_jslot = np.full((nbody, jmax), -1, np.int32)
  body_free = np.full(nbody, -1, np.int32)
  for b in range(nbody):
    slots = [j for j in jntadr[b] if jnt_type[j] != FREE]
    body_jslot[b, :len(slots)] = slots
    for j in jntadr[b]:
      if jnt_type[j] == FREE:
        if parentid[b] != 0 or len(jntadr[b]) != 1:
          raise NotImplementedError(
              'a free joint must be the only joint of a world child')
        body_free[b] = j
  for b in range(nbody):
    if mocapid[b] >= 0 and parentid[b] != 0:
      raise NotImplementedError('mocap bodies must be children of world')

  depth = np.zeros(nbody, np.int32)
  for b in range(1, nbody):
    depth[b] = depth[parentid[b]] + 1

  nv = sum(JOINT_DOF_DIM[t] for t in jnt_type)
  dof_body = np.zeros(nv, np.int32)
  dof_jnt = np.zeros(nv, np.int32)
  dof_free = np.zeros(nv, np.float32)
  dof_free_axis = np.zeros((nv, 3), np.float32)
  is_rot = np.zeros(nv, np.float32)
  is_trans = np.zeros(nv, np.float32)
  for j in range(njnt):
    d0 = jnt_dofadr[j]
    b = jnt_bodyid[j]
    if jnt_type[j] == FREE:
      for k in range(6):
        dof_body[d0 + k] = b
        dof_jnt[d0 + k] = j
        dof_free[d0 + k] = 1.0
        dof_free_axis[d0 + k, k % 3] = 1.0
      is_trans[d0:d0 + 3] = 1.0
      is_rot[d0 + 3:d0 + 6] = 1.0
    else:
      dof_body[d0] = b
      dof_jnt[d0] = j
      is_rot[d0] = 1.0 if jnt_type[j] == HINGE else 0.0
      is_trans[d0] = 1.0 if jnt_type[j] == SLIDE else 0.0

  dmax = max(1, int(depth.max()))
  dp = 1
  while dp < dmax:
    dp *= 2
  anc = np.zeros((nbody, dp), np.int32)
  for b in range(nbody):
    chain = []
    p = b
    while p:
      chain.append(p)
      p = parentid[p]
    chain.reverse()
    anc[b, dp - len(chain):] = chain

  body_free_inv = np.zeros(nbody, np.int32)
  for i, j in enumerate(fj):
    body_free_inv[jnt_bodyid[j]] = i

  return KinStatic(
      sj=sj,
      sj_qadr=np.asarray([jnt_qposadr[j] for j in sj], np.int32),
      sj_dadr=np.asarray([jnt_dofadr[j] for j in sj], np.int32),
      fj=fj,
      fj_qadr=np.asarray([jnt_qposadr[j] for j in fj], np.int32),
      fj_dadr=np.asarray([jnt_dofadr[j] for j in fj], np.int32),
      body_jslot=body_jslot,
      body_free=body_free,
      body_mocap=np.asarray(mocapid, np.int32),
      anc=anc,
      jnt_qadr=np.asarray(jnt_qposadr, np.int32),
      jnt_hinge=np.asarray([1.0 if t == HINGE else 0.0 for t in jnt_type],
                           np.float32),
      jnt_scalar=np.asarray([1.0 if t in (SLIDE, HINGE) else 0.0
                             for t in jnt_type], np.float32),
      body_free_inv=body_free_inv,
      dof_body=dof_body,
      dof_jnt=dof_jnt,
      dof_free=dof_free,
      dof_free_axis=dof_free_axis,
      is_rot=is_rot,
      is_trans=is_trans,
  )


def kin_static(model: Model) -> KinStatic:
  return _kin_static(model.body_parentid, model.body_mocapid,
                     model.body_jntadr, model.jnt_type, model.jnt_qposadr,
                     model.jnt_dofadr, model.jnt_bodyid)


def _c(model: Model, name: str) -> torch.Tensor:
  """A KinStatic array as a (cached) tensor on the model's device."""
  return model.const('ks.' + name, getattr(kin_static(model), name))


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


def fk(model: Model, state: State) -> Kin:
  """World poses of all bodies, geoms and sites, for B envs at once.

  Local transforms for ALL joints in one masked pass, free/mocap overrides
  as full-width selects, then every body's world pose composed along its
  (front-identity-padded) ancestor chain with a log2(D) pairwise reduce.
  Written without in-place ops so that ``torch.func.jvp`` runs through it.
  """
  ks = kin_static(model)
  qpos = state.qpos                                   # [B, nq]
  B = qpos.shape[0]
  nbody = model.nbody
  ident = model.const('ident_quat', np.array([1.0, 0, 0, 0], np.float32))

  # --- per-joint local transforms ------------------------------------------
  disp = (qpos[:, _c(model, 'jnt_qadr')] - model.jnt_ref) * \
      _c(model, 'jnt_scalar')                         # [B, njnt]
  axis = model.jnt_axis                               # [njnt, 3]
  half = 0.5 * disp * _c(model, 'jnt_hinge')
  qj = torch.cat([torch.cos(half)[..., None],
                  axis * torch.sin(half)[..., None]], -1)  # [B, njnt, 4]
  anchor = model.jnt_pos
  t_hinge = anchor - gm.quat_rotate(qj, anchor)
  t_slide = axis * disp[..., None]
  hinge = (_c(model, 'jnt_hinge') > 0)[:, None]
  scal = (_c(model, 'jnt_scalar') > 0)[:, None]
  zero = torch.zeros((), dtype=qpos.dtype, device=qpos.device)
  jt = torch.where(scal, torch.where(hinge, t_hinge, t_slide), zero)
  jq = torch.where(scal & hinge, qj, ident)

  # --- per-body local transform: (body_pos, body_quat) ∘ joint slots ------
  lp = model.body_pos.expand(B, nbody, 3)
  lq = model.body_quat.expand(B, nbody, 4)
  for s in range(ks.body_jslot.shape[1]):
    slot = ks.body_jslot[:, s]
    live = model.const(f'ks.jslot_live{s}', (slot >= 0)[:, None])
    idx = model.const(f'ks.jslot_idx{s}', np.maximum(slot, 0))
    tq = torch.where(live, jq[:, idx], ident)
    tt = torch.where(live, jt[:, idx], zero)
    lp = lp + gm.quat_rotate(lq, tt)
    lq = gm.quat_mul(lq, tq)

  # --- free bodies: world pose straight from qpos (parent is world) -------
  if len(ks.fj):
    fidx = model.const('ks.fj_q7', ks.fj_qadr[:, None] + np.arange(7)[None])
    fb = qpos[:, fidx][:, _c(model, 'body_free_inv')]   # [B, nbody, 7]
    free = model.const('ks.is_free_body', (ks.body_free >= 0)[:, None])
    lp = torch.where(free, fb[..., :3], lp)
    lq = torch.where(free, gm.quat_normalize(fb[..., 3:7]), lq)

  # --- mocap bodies: pose from State (parent is world) --------------------
  if (ks.body_mocap >= 0).any():
    mids = model.const('ks.mocap_idx', np.maximum(ks.body_mocap, 0))
    moc = model.const('ks.is_mocap', (ks.body_mocap >= 0)[:, None])
    lp = torch.where(moc, state.mocap_pos[:, mids], lp)
    lq = torch.where(moc, gm.quat_normalize(state.mocap_quat[:, mids]), lq)

  # --- world row = identity, then ancestor-chain composition --------------
  world = model.const('ks.is_world', (np.arange(nbody) == 0)[:, None])
  lp = torch.where(world, zero, lp)
  lq = torch.where(world, ident, lq)
  anc = _c(model, 'anc')
  cp = lp[:, anc]                                     # [B, nbody, Dp, 3]
  cq = lq[:, anc]
  while cp.shape[2] > 1:
    p1, q1 = cp[:, :, 0::2], cq[:, :, 0::2]           # root side
    p2, q2 = cp[:, :, 1::2], cq[:, :, 1::2]
    cp = p1 + gm.quat_rotate(q1, p2)
    cq = gm.quat_mul(q1, q2)
  xpos, xquat = cp[:, :, 0], cq[:, :, 0]

  ximat = gm.quat_to_mat(xquat)
  xipos = xpos + gm.quat_rotate(xquat, model.body_ipos)

  gb = model.const('geom_bodyid', model.geom_bodyid)
  geom_xpos = xpos[:, gb] + gm.quat_rotate(xquat[:, gb], model.geom_pos)
  geom_xquat = gm.quat_mul(xquat[:, gb], model.geom_quat)
  if model.nsite:
    sb = model.const('site_bodyid', model.site_bodyid)
    site_xpos = xpos[:, sb] + gm.quat_rotate(xquat[:, sb], model.site_pos)
    site_xmat = gm.quat_to_mat(gm.quat_mul(xquat[:, sb], model.site_quat))
  else:
    site_xpos = qpos.new_zeros((B, 0, 3))
    site_xmat = qpos.new_zeros((B, 0, 3, 3))

  return Kin(xpos=xpos, xquat=xquat, ximat=ximat, xipos=xipos,
             geom_xpos=geom_xpos, geom_xquat=geom_xquat,
             site_xpos=site_xpos, site_xmat=site_xmat)


# ---------------------------------------------------------------------------
# dof geometry + ancestor masks (static structure, dynamic values)
# ---------------------------------------------------------------------------


class DofInfo(NamedTuple):
  axis: torch.Tensor      # [B, nv, 3] world axis of each dof
  anchor: torch.Tensor    # [B, nv, 3] world anchor point (rotational dofs)
  is_rot: torch.Tensor    # [nv] 1.0 where dof contributes angular velocity
  is_trans: torch.Tensor  # [nv] 1.0 where dof contributes linear velocity


def ancestor_mask(model: Model) -> np.ndarray:
  """Static [nbody, nv] mask: dof d moves body b."""
  mask = np.zeros((model.nbody, model.nv), np.float32)
  for b in range(1, model.nbody):
    cur = b
    while cur != 0:
      for j in model.body_jntadr[cur]:
        adr = model.jnt_dofadr[j]
        mask[b, adr:adr + JOINT_DOF_DIM[model.jnt_type[j]]] = 1.0
      cur = model.body_parentid[cur]
  return mask


def dof_info(model: Model, kin: Kin) -> DofInfo:
  """World-frame axis/anchor per dof, vectorised over dofs and envs.

  Scalar joints: axis = R(xquat[b])·jnt_axis, anchor = body origin +
  R(xquat[b])·jnt_pos.  Free joints: world axes (eye rows), anchor = body
  origin.
  """
  b = _c(model, 'dof_body')
  q = kin.xquat[:, b]                                  # [B, nv, 4]
  dof_jnt = _c(model, 'dof_jnt')
  free = (_c(model, 'dof_free') > 0)[:, None]
  zero = torch.zeros((), dtype=q.dtype, device=q.device)
  local_axis = model.jnt_axis[dof_jnt]                 # [nv, 3]
  local_anchor = torch.where(free, zero, model.jnt_pos[dof_jnt])
  axis = torch.where(free, _c(model, 'dof_free_axis'),
                     gm.quat_rotate(q, local_axis))
  anchor = kin.xpos[:, b] + gm.quat_rotate(q, local_anchor)
  return DofInfo(axis=axis, anchor=anchor, is_rot=_c(model, 'is_rot'),
                 is_trans=_c(model, 'is_trans'))


def point_jacobian(model: Model, kin: Kin, info: DofInfo,
                   point: torch.Tensor, bodyid: int,
                   anc_mask: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """6-dof Jacobian of world points ``point`` [B, 3] attached to ``bodyid``.

  Returns (jacp [B, nv, 3], jacr [B, nv, 3]).
  """
  mask = model.const('anc_mask', anc_mask)[bodyid][:, None]   # [nv, 1]
  r = point[:, None, :] - info.anchor                           # [B, nv, 3]
  jacp = mask * (info.is_trans[:, None] * info.axis +
                 info.is_rot[:, None] * gm.cross(info.axis, r))
  jacr = mask * info.is_rot[:, None] * info.axis
  return jacp, jacr


def com_jacobians(model: Model, kin: Kin, info: DofInfo,
                  anc_mask: np.ndarray
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Stacked COM Jacobians: (jacp, jacr), each [B, nbody, nv, 3]."""
  mask = model.const('anc_mask', anc_mask)[:, :, None]       # [nbody, nv, 1]
  r = kin.xipos[:, :, None, :] - info.anchor[:, None, :, :]  # [B,nbody,nv,3]
  axis = info.axis[:, None].expand(r.shape)
  jacp = mask * (info.is_trans[:, None] * axis +
                 info.is_rot[:, None] * gm.cross(axis, r))
  jacr = mask * info.is_rot[:, None] * axis
  return jacp, jacr


# ---------------------------------------------------------------------------
# qpos tangent / integration (vectorised over joints)
# ---------------------------------------------------------------------------


def qpos_tangent(model: Model, qpos: torch.Tensor, qvel: torch.Tensor
                 ) -> torch.Tensor:
  """d(qpos)/dt as a tangent vector aligned with the qpos layout [B, nq]."""
  ks = kin_static(model)
  tang = qpos.new_zeros(qpos.shape)
  if len(ks.sj):
    tang[:, _c(model, 'sj_qadr')] = qvel[:, _c(model, 'sj_dadr')]
  if len(ks.fj):
    pos_idx, quat_idx, v_idx, w_idx = _free_index(model)
    tang[:, pos_idx] = qvel[:, v_idx]
    tang[:, quat_idx] = gm.quat_tangent(qpos[:, quat_idx], qvel[:, w_idx])
  return tang


def _free_index(model: Model):
  """[nf, 3|4] qpos/qvel address blocks of the free joints."""
  ks = kin_static(model)
  q, d = ks.fj_qadr[:, None], ks.fj_dadr[:, None]
  return (model.const('ks.fj_pos', q + np.arange(3)[None]),
          model.const('ks.fj_quat', q + np.arange(3, 7)[None]),
          model.const('ks.fj_v', d + np.arange(3)[None]),
          model.const('ks.fj_w', d + np.arange(3, 6)[None]))


def integrate_qpos(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   dt) -> torch.Tensor:
  """Semi-implicit position update (quaternion-exact for free joints)."""
  ks = kin_static(model)
  out = qpos.clone()
  if len(ks.sj):
    qadr = _c(model, 'sj_qadr')
    out[:, qadr] = qpos[:, qadr] + dt * qvel[:, _c(model, 'sj_dadr')]
  if len(ks.fj):
    pos_idx, quat_idx, v_idx, w_idx = _free_index(model)
    out[:, pos_idx] = qpos[:, pos_idx] + dt * qvel[:, v_idx]
    out[:, quat_idx] = gm.quat_integrate(qpos[:, quat_idx], qvel[:, w_idx],
                                         dt)
  return out
