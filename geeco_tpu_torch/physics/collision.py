"""Narrowphase collision: fixed-size contact set from static pair lists.

Counterpart of ``geeco_tpu/physics/collision.py`` for the pair kernels the
box scenes use: plane-capsule, plane-box, capsule-box and box-box (with
their segment/box helpers), plus plane-sphere and sphere-box.  Any other
type pair raises ``NotImplementedError``, as the JAX dispatcher does for
unknown pairs; the ellipsoid, cylinder, sphere-sphere, sphere-capsule,
capsule-capsule and convex-hull kernels are not ported yet.

The JAX package writes each kernel for one pair and vmaps it; here every
kernel takes tensors with leading (env, pair) axes written out:
``p [B, P, 3]``, ``q [B, P, 4]`` and ``s [P, 3]``, and returns points with an
extra per-pair axis, ``pos [B, P, npts, 3]``.

Contact conventions (as the JAX package):
  * ``normal`` points from geom1 toward geom2 (positive force separates);
  * ``dist`` is the signed gap (negative = penetrating);
  * each pair emits a fixed number of candidate points (``_POINTS``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import math as gm
from ..core.model import (BOX, CAPSULE, CYLINDER, ELLIPSOID, Kin, MESH, Model,
                          PLANE, SPHERE)

# points emitted per (type1, type2) pair kernel (the JAX package's table)
_POINTS = {
    (PLANE, SPHERE): 1, (PLANE, CAPSULE): 2, (PLANE, ELLIPSOID): 1,
    (PLANE, CYLINDER): 4, (PLANE, BOX): 8,
    (SPHERE, SPHERE): 1, (SPHERE, CAPSULE): 1, (SPHERE, ELLIPSOID): 1,
    (SPHERE, BOX): 1, (SPHERE, CYLINDER): 1,
    (CAPSULE, CAPSULE): 1, (CAPSULE, ELLIPSOID): 1, (CAPSULE, BOX): 3,
    (CAPSULE, CYLINDER): 1, (CYLINDER, BOX): 3, (CYLINDER, CYLINDER): 1,
    (CYLINDER, ELLIPSOID): 1,
    (ELLIPSOID, ELLIPSOID): 1, (ELLIPSOID, BOX): 1,
    (BOX, BOX): 8,
    (PLANE, MESH): 4, (SPHERE, MESH): 1, (ELLIPSOID, MESH): 1,
    (CAPSULE, MESH): 3, (CYLINDER, MESH): 3, (BOX, MESH): 6,
    (MESH, MESH): 6,
}


class Contacts(NamedTuple):
  pos: torch.Tensor     # [B, ncon, 3]
  normal: torch.Tensor  # [B, ncon, 3] from geom1 -> geom2
  dist: torch.Tensor    # [B, ncon]
  geom1: np.ndarray     # [ncon] int (static, identical across envs)
  geom2: np.ndarray     # [ncon] int


def ncon_max(model: Model) -> int:
  total = 0
  for (t1, t2), pairs in model.col_pairs:
    total += _POINTS[(t1, t2)] * len(pairs)
  return total


# ---------------------------------------------------------------------------
# primitive helpers
# ---------------------------------------------------------------------------

_CORNERS = np.asarray(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    np.float32)  # [8, 3]


def _corners(like: torch.Tensor) -> torch.Tensor:
  return torch.as_tensor(_CORNERS, device=like.device)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return (a * b).sum(-1)


def _zaxis(q: torch.Tensor) -> torch.Tensor:
  z = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
  z[..., 2] = 1.0
  return gm.quat_rotate(q, z)


def _capsule_segment(pos, quat, size):
  """World-space endpoints of capsule axis segment."""
  axis = _zaxis(quat)
  hl = size[..., 1:2]
  return pos - hl * axis, pos + hl * axis


def _plane_frame(pos, quat):
  return pos, _zaxis(quat)


# ---------------------------------------------------------------------------
# pair kernels: (p1, q1, s1, p2, q2, s2) -> (pos, n, dist), npts axis at -2
# ---------------------------------------------------------------------------


def plane_capsule(p1, q1, s1, p2, q2, s2):
  pp, n = _plane_frame(p1, q1)
  a, b = _capsule_segment(p2, q2, s2)
  r = s2[..., 0]
  da = _dot(a - pp, n) - r
  db = _dot(b - pp, n) - r
  pa = a - (r + 0.5 * da)[..., None] * n
  pb = b - (r + 0.5 * db)[..., None] * n
  return (torch.stack([pa, pb], -2), torch.stack([n, n], -2),
          torch.stack([da, db], -1))


def plane_box(p1, q1, s1, p2, q2, s2):
  pp, n = _plane_frame(p1, q1)
  local = _corners(p2) * s2[..., None, :]                 # [.., 8, 3]
  R2 = gm.quat_to_mat(q2)
  corners = p2[..., None, :] + torch.einsum('...kj,...ij->...ki', local, R2)
  d = torch.einsum('...ki,...i->...k', corners - pp[..., None, :], n)
  normals = n[..., None, :].expand(corners.shape)
  return corners, normals, d


def plane_sphere(p1, q1, s1, p2, q2, s2):
  pp, n = _plane_frame(p1, q1)
  r = s2[..., 0]
  d = _dot(p2 - pp, n) - r
  pos = p2 - (r + 0.5 * d)[..., None] * n
  return pos[..., None, :], n[..., None, :], d[..., None]


def _sphere_box_one(center, r, pbox, qbox, sbox):
  """Point of radius r vs box: (pos, n box->sphere, d); center [..., 3]."""
  Rb = gm.quat_to_mat(qbox)
  local = torch.einsum('...ji,...j->...i', Rb, center - pbox)   # Rbᵀ (c - p)
  clamped = torch.maximum(torch.minimum(local, sbox), -sbox)
  delta = local - clamped
  dist_out = gm.norm(delta)
  outside = dist_out > 1e-9
  n_out = delta / torch.clamp(dist_out, min=1e-9)[..., None]
  # inside: push along the axis of least depth
  depth_ax = sbox - local.abs()
  ax = torch.argmin(depth_ax, dim=-1, keepdim=True)   # first minimum
  sign = torch.sign(torch.gather(local, -1, ax) + 1e-12)
  n_in = torch.zeros_like(local).scatter(-1, ax, sign)
  d_in = -(torch.gather(depth_ax, -1, ax)[..., 0] + r)
  d = torch.where(outside, dist_out - r, d_in)
  n_local = torch.where(outside[..., None], n_out, n_in)
  n_world = torch.einsum('...ij,...j->...i', Rb, n_local)
  pos = center - n_world * (r + 0.5 * d)[..., None]
  return pos, n_world, d


def sphere_box(p1, q1, s1, p2, q2, s2):
  pos, n_box2sph, d = _sphere_box_one(p1, s1[..., 0], p2, q2, s2)
  # normal must point geom1 (sphere) -> geom2 (box)
  return pos[..., None, :], -n_box2sph[..., None, :], d[..., None]


def capsule_box(p1, q1, s1, p2, q2, s2):
  a, b = _capsule_segment(p1, q1, s1)
  r = s1[..., 0]
  pts = torch.stack([a, 0.5 * (a + b), b], -2)           # [..., 3, 3]
  exp = lambda x: x[..., None, :].expand(pts.shape[:-1] + x.shape[-1:])
  pos, n, d = _sphere_box_one(pts, r[..., None], exp(p2), exp(q2),
                              s2[..., None, :])
  return pos, -n, d


def _keep_deepest(cand_d, k):
  """Indices of the k smallest candidate distances.

  ``jax.lax.top_k(-d, k)`` keeps the lower index first among equal keys;
  a stable ascending sort does the same (``torch.topk`` leaves the order of
  ties unspecified, and the deactivated candidates all tie at 1.0).
  """
  return torch.sort(cand_d, dim=-1, stable=True).indices[..., :k]


def box_box(p1, q1, s1, p2, q2, s2):
  """SAT + corner-candidate manifold, up to 8 points."""
  R1 = gm.quat_to_mat(q1)
  R2 = gm.quat_to_mat(q2)
  dvec = p2 - p1

  # 15 candidate axes
  c1, c2 = R1.transpose(-1, -2), R2.transpose(-1, -2)    # rows = columns
  cr = gm.cross(c1[..., :, None, :], c2[..., None, :, :])  # [..., 3, 3, 3]
  cr = cr.reshape(cr.shape[:-3] + (9, 3))
  nrm = gm.norm(cr, keepdim=True)
  # degenerate (parallel edges): substitute face axis so SAT is unaffected
  cr = torch.where(nrm > 1e-6, cr / torch.clamp(nrm, min=1e-6),
                   c1[..., 0:1, :])
  A = torch.cat([c1, c2, cr], -2)                        # [..., 15, 3]

  ext1 = torch.einsum('...ai,...ij->...aj', A, R1).abs() @ s1[..., None]
  ext2 = torch.einsum('...ai,...ij->...aj', A, R2).abs() @ s2[..., None]
  ext1, ext2 = ext1[..., 0], ext2[..., 0]
  proj = torch.einsum('...ai,...i->...a', A, dvec)
  sep = proj.abs() - ext1 - ext2

  best = torch.argmax(sep, dim=-1, keepdim=True)        # first maximum
  sep_max = torch.gather(sep, -1, best)[..., 0]
  A_best = torch.gather(A, -2, best[..., None].expand(
      best.shape[:-1] + (1, 3)))[..., 0, :]
  n = A_best * torch.sign(torch.gather(proj, -1, best) + 1e-12)

  C = _corners(p1)
  cw1 = p1[..., None, :] + torch.einsum('...kj,...ij->...ki',
                                        C * s1[..., None, :], R1)
  cw2 = p2[..., None, :] + torch.einsum('...kj,...ij->...ki',
                                        C * s2[..., None, :], R2)
  nR1 = torch.einsum('...i,...ij->...j', n, R1)
  nR2 = torch.einsum('...i,...ij->...j', n, R2)
  ext1n = _dot(nR1.abs(), s1)
  ext2n = _dot(nR2.abs(), s2)
  d_c2 = torch.einsum('...ki,...i->...k', cw2 - p1[..., None, :], n) - \
      ext1n[..., None]
  d_c1 = (_dot(p2, n) - ext2n)[..., None] - \
      torch.einsum('...ki,...i->...k', cw1, n)

  cand_pos = torch.cat([cw2, cw1], -2)                  # [..., 16, 3]
  cand_d = torch.cat([d_c2, d_c1], -1)                  # [..., 16]
  # lateral pruning: candidate must lie (loosely) inside the other box
  tol = 1.5
  l2 = torch.einsum('...ki,...ij->...kj', cw2 - p1[..., None, :], R1).abs() \
      - tol * s1[..., None, :]
  l1 = torch.einsum('...ki,...ij->...kj', cw1 - p2[..., None, :], R2).abs() \
      - tol * s2[..., None, :]
  lateral_ok = torch.cat([l2.amax(-1) < 0.05, l1.amax(-1) < 0.05], -1)
  one = torch.ones((), dtype=cand_d.dtype, device=cand_d.device)
  cand_d = torch.where(lateral_ok, cand_d, one)
  # separated -> deactivate all
  cand_d = torch.where((sep_max < 0)[..., None], cand_d,
                       torch.clamp(cand_d, min=1.0))
  idx = _keep_deepest(cand_d, 8)
  pos8 = torch.gather(cand_pos, -2, idx[..., None].expand(idx.shape + (3,)))
  d8 = torch.gather(cand_d, -1, idx)
  n8 = n[..., None, :].expand(pos8.shape)

  # edge-edge winner (axes 6..14): emit the closest-point contact between
  # the two supporting edges instead of the (empty) corner manifold
  is_ee = best[..., 0] >= 6
  ei = torch.clamp(best[..., 0] - 6, min=0)
  i1, i2 = ei // 3, ei % 3
  d1 = torch.gather(c1, -2, i1[..., None, None].expand(
      i1.shape + (1, 3)))[..., 0, :]
  d2 = torch.gather(c2, -2, i2[..., None, None].expand(
      i2.shape + (1, 3)))[..., 0, :]
  ar = torch.arange(3, device=p1.device)
  zero = torch.zeros((), dtype=n.dtype, device=n.device)
  sgn1 = torch.where(ar == i1[..., None], zero, torch.sign(nR1))
  sgn2 = torch.where(ar == i2[..., None], zero, torch.sign(-nR2))
  v1 = p1 + torch.einsum('...ij,...j->...i', R1, sgn1 * s1)
  v2 = p2 + torch.einsum('...ij,...j->...i', R2, sgn2 * s2)
  r12 = v2 - v1
  bb = _dot(d1, d2)
  den = 1.0 - bb * bb
  safe = den.abs() > 1e-9
  den_s = torch.where(safe, den, one)
  t = torch.where(safe, (_dot(r12, d1) - bb * _dot(r12, d2)) / den_s, zero)
  s = torch.where(safe, (bb * _dot(r12, d1) - _dot(r12, d2)) / den_s, zero)
  pos_ee = 0.5 * (v1 + t[..., None] * d1 + v2 + s[..., None] * d2)
  d_ee = torch.cat([sep_max[..., None],
                    one.expand(sep_max.shape + (7,))], -1)
  d8 = torch.where(is_ee[..., None], d_ee, d8)
  pos8 = torch.where(is_ee[..., None, None],
                     pos_ee[..., None, :].expand(pos8.shape), pos8)
  return pos8, n8, d8


def _kernel(t1: int, t2: int):
  """(t1, t2) -> batched pair kernel; only the box- and sphere-scene pairs
  are ported."""
  if (t1, t2) == (PLANE, SPHERE):
    return plane_sphere
  if (t1, t2) == (PLANE, CAPSULE):
    return plane_capsule
  if (t1, t2) == (PLANE, BOX):
    return plane_box
  if (t1, t2) == (SPHERE, BOX):
    return sphere_box
  if (t1, t2) == (CAPSULE, BOX):
    return capsule_box
  if (t1, t2) == (BOX, BOX):
    return box_box
  raise NotImplementedError(f'collision kernel ({t1}, {t2})')


# ---------------------------------------------------------------------------
# top-level collide
# ---------------------------------------------------------------------------


def collide(model: Model, kin: Kin) -> Contacts:
  """Evaluate all static pairs for B envs; fixed-size contact arrays."""
  B = kin.geom_xpos.shape[0]
  all_pos, all_n, all_d = [], [], []
  geom1_rows, geom2_rows = [], []
  off = 0
  if model.col_pairs:
    G1 = np.concatenate([[p[0] for p in pairs]
                         for _, pairs in model.col_pairs])
    G2 = np.concatenate([[p[1] for p in pairs]
                         for _, pairs in model.col_pairs])
    g1a, g2a = model.const('col_g1', G1), model.const('col_g2', G2)
    P1a, Q1a = kin.geom_xpos[:, g1a], kin.geom_xquat[:, g1a]
    P2a, Q2a = kin.geom_xpos[:, g2a], kin.geom_xquat[:, g2a]
    S1a, S2a = model.geom_size[g1a], model.geom_size[g2a]
  for (t1, t2), pairs in model.col_pairs:
    npts = _POINTS[(t1, t2)]
    kern = _kernel(t1, t2)
    g1 = np.asarray([p[0] for p in pairs], np.int32)
    g2 = np.asarray([p[1] for p in pairs], np.int32)
    sl = slice(off, off + len(pairs))
    off += len(pairs)
    pos, n, d = kern(P1a[:, sl], Q1a[:, sl], S1a[sl],
                     P2a[:, sl], Q2a[:, sl], S2a[sl])  # [B, P, npts, ...]
    all_pos.append(pos.reshape(B, -1, 3))
    all_n.append(n.reshape(B, -1, 3))
    all_d.append(d.reshape(B, -1))
    geom1_rows.append(np.repeat(g1, npts))
    geom2_rows.append(np.repeat(g2, npts))
  if not all_pos:
    z = kin.geom_xpos.new_zeros
    return Contacts(pos=z((B, 0, 3)), normal=z((B, 0, 3)), dist=z((B, 0)),
                    geom1=np.zeros(0, np.int32), geom2=np.zeros(0, np.int32))
  return Contacts(
      pos=torch.cat(all_pos, 1),
      normal=torch.cat(all_n, 1),
      dist=torch.cat(all_d, 1),
      geom1=np.concatenate(geom1_rows),
      geom2=np.concatenate(geom2_rows),
  )


def contact_params(model: Model) -> Tuple[np.ndarray, ...]:
  """Static per-contact-row combined material params (numpy).

  Returns (body1, body2, friction[ncon,3], solref[ncon,2], solimp[ncon,3],
  condim[ncon]) aligned with collide() rows.  MuJoCo equal-priority
  combination: friction = elementwise max, solref/solimp = mean,
  condim = max.
  """
  g_body = np.asarray(model.geom_bodyid)
  fric = np.asarray(model.geom_friction.cpu())
  solref = np.asarray(model.geom_solref.cpu())
  solimp = np.asarray(model.geom_solimp.cpu())
  condim = np.asarray(model.geom_condim)
  b1, b2, fr, sr, si, cd = [], [], [], [], [], []
  for (t1, t2), pairs in model.col_pairs:
    npts = _POINTS[(t1, t2)]
    for g1, g2 in pairs:
      for _ in range(npts):
        b1.append(g_body[g1])
        b2.append(g_body[g2])
        fr.append(np.maximum(fric[g1], fric[g2]))
        sr.append(0.5 * (solref[g1] + solref[g2]))
        si.append(0.5 * (solimp[g1] + solimp[g2]))
        cd.append(max(condim[g1], condim[g2]))
  if not b1:
    return (np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros((0, 3)), np.zeros((0, 2)), np.zeros((0, 3)),
            np.zeros(0, np.int32))
  return (np.asarray(b1, np.int32), np.asarray(b2, np.int32),
          np.asarray(fr, np.float32), np.asarray(sr, np.float32),
          np.asarray(si, np.float32), np.asarray(cd, np.int32))
