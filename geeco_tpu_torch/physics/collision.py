"""Narrowphase collision: fixed-size contact set from static pair lists.

Counterpart of ``geeco_tpu/physics/collision.py``: every pair kernel of
the JAX package, so every GEECO scene collides.  Primitive pairs (plane,
sphere, capsule, ellipsoid, cylinder, box) go through ``_kernel``, which
treats a cylinder as a capsule except against a plane, and an ellipsoid as
its min-radius bounding sphere refined along the contact normal
(``_ellipsoid_support_fix``).  Mesh geoms collide through their padded
convex hulls (``plane_hull``, ``sphere_hull``, ``capsule_hull``,
``box_hull``, ``hull_hull``: face and edge-edge separating axes).  A type
pair the JAX dispatcher lacks raises ``NotImplementedError``, as there.

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

import functools
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
  return _table('corners', like.device)


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
  """A static table of this module on ``device``, copied there once (a
  copy from the host each call would stop a CUDA graph's capture).
  Callers only read it."""
  return torch.as_tensor({'corners': _CORNERS, 'box_faces': _BOX_FACES}[name],
                         device=device)


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


def _sphere_radius(gtype: int, size):
  """Bounding radius of a sphere (size[0]) or an ellipsoid (min axis)."""
  if gtype == ELLIPSOID:
    return size.amin(-1)
  return size[..., 0]


def _closest_on_segment(a, b, p):
  ab = b - a
  t = torch.clamp(_dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12),
                  0.0, 1.0)
  return a + t[..., None] * ab


def _closest_segment_segment(p1, q1, p2, q2):
  """Closest points between segments (Ericson, branch-free)."""
  d1, d2 = q1 - p1, q2 - p2
  r = p1 - p2
  a = _dot(d1, d1)
  e = _dot(d2, d2)
  f = _dot(d2, r)
  c = _dot(d1, r)
  b = _dot(d1, d2)
  denom = a * e - b * b
  s = torch.where(denom > 1e-12, torch.clamp(
      (b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0), 0.0)
  t = (b * s + f) / torch.clamp(e, min=1e-12)
  t_cl = torch.clamp(t, 0.0, 1.0)
  s = torch.clamp((b * t_cl - c) / torch.clamp(a, min=1e-12), 0.0, 1.0)
  return p1 + s[..., None] * d1, p2 + t_cl[..., None] * d2


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """``x[..., i, :]`` for an index per batch element: x [..., N, C] (its
  leading dims broadcast to i's), i [...] -> [..., C]."""
  x = x.expand(i.shape + x.shape[-2:])
  return torch.gather(x, -2, i[..., None, None].expand(
      i.shape + (1, x.shape[-1])))[..., 0, :]


def _pick1(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """``x[..., i]`` for an index per batch element: x [..., N], i [...]."""
  return torch.gather(x.expand(i.shape + x.shape[-1:]), -1,
                      i[..., None])[..., 0]


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


def plane_sphere(p1, q1, s1, p2, q2, s2, t2=SPHERE):
  pp, n = _plane_frame(p1, q1)
  r = _sphere_radius(t2, s2)
  d = _dot(p2 - pp, n) - r
  pos = p2 - (r + 0.5 * d)[..., None] * n
  return pos[..., None, :], n[..., None, :], d[..., None]


def plane_ellipsoid(p1, q1, s1, p2, q2, s2):
  pp, n = _plane_frame(p1, q1)
  R2 = gm.quat_to_mat(q2)
  # support of the ellipsoid along -n
  nl = torch.einsum('...ji,...j->...i', R2, n)             # R2ᵀ n
  denom = gm.norm(s2 * nl) + 1e-12
  sup_local = -(s2 * s2 * nl) / denom[..., None]
  sup = p2 + torch.einsum('...ij,...j->...i', R2, sup_local)
  d = _dot(sup - pp, n)
  return sup[..., None, :], n[..., None, :], d[..., None]


def plane_cylinder(p1, q1, s1, p2, q2, s2):
  """Exact cylinder support vs plane: a rim tripod on the deeper end
  (stable face rest) plus the matching rim point on the other end (line
  rest when lying); 4 candidate points."""
  pp, n = _plane_frame(p1, q1)
  axis = _zaxis(q2)
  r, h = s2[..., 0:1], s2[..., 1:2]
  ca = _dot(axis, n)[..., None]
  # radial direction toward the plane, orthogonal to the axis
  _, rad = gm.norm_safe(-(n - ca * axis))
  end_deep = p2 - torch.sign(ca) * h * axis
  end_far = p2 + torch.sign(ca) * h * axis
  # rim tripod on the deep end: rad rotated 0 / +120 / -120 deg about axis
  c120, s120 = -0.5, float(np.float32(np.sqrt(3.0)) / np.float32(2.0))
  xr = gm.cross(axis, rad)
  t1v = rad * c120 + xr * s120
  t2v = rad * c120 - xr * s120
  pts = torch.stack([end_deep + r * rad, end_far + r * rad,
                     end_deep + r * t1v, end_deep + r * t2v], -2)
  d = torch.einsum('...ki,...i->...k', pts - pp[..., None, :], n)
  return pts, n[..., None, :].expand(pts.shape), d


def sphere_sphere(p1, q1, s1, p2, q2, s2, t1=SPHERE, t2=SPHERE):
  r1, r2 = _sphere_radius(t1, s1), _sphere_radius(t2, s2)
  dist, n = gm.norm_safe(p2 - p1)
  d = dist - r1 - r2
  pos = p1 + n * (r1 + 0.5 * d)[..., None]
  return pos[..., None, :], n[..., None, :], d[..., None]


def sphere_capsule(p1, q1, s1, p2, q2, s2, t1=SPHERE):
  r1 = _sphere_radius(t1, s1)
  a, b = _capsule_segment(p2, q2, s2)
  c = _closest_on_segment(a, b, p1)
  dist, n = gm.norm_safe(c - p1)
  d = dist - r1 - s2[..., 0]
  pos = p1 + n * (r1 + 0.5 * d)[..., None]
  return pos[..., None, :], n[..., None, :], d[..., None]


def capsule_capsule(p1, q1, s1, p2, q2, s2):
  a1, b1 = _capsule_segment(p1, q1, s1)
  a2, b2 = _capsule_segment(p2, q2, s2)
  c1, c2 = _closest_segment_segment(a1, b1, a2, b2)
  dist, n = gm.norm_safe(c2 - c1)
  d = dist - s1[..., 0] - s2[..., 0]
  pos = c1 + n * (s1[..., 0] + 0.5 * d)[..., None]
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


def sphere_box(p1, q1, s1, p2, q2, s2, t1=SPHERE):
  pos, n_box2sph, d = _sphere_box_one(p1, _sphere_radius(t1, s1), p2, q2,
                                      s2)
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


# ---------------------------------------------------------------------------
# convex-hull kernels (mesh narrowphase)
#
# Hulls are padded (vert [P, HV, 3] + vmask, face [P, HF, 4] half-spaces
# n·x <= off + fmask, unique edge directions [P, HE, 3] + emask) in the geom
# frame (core/mjcf.py build_hull).  phi(x) = max_f (n_f·x - off_f) is the
# exact signed distance inside and a lower bound outside.  Contacts are
# vertex-vs-face both ways, or one edge-edge contact when a cross axis wins.
# ---------------------------------------------------------------------------


def _hull_phi_normal(pt_local, hf, hfm):
  """Signed distance proxy and outward face normal at a local point."""
  d = (hf[..., :3] * pt_local[..., None, :]).sum(-1) - hf[..., 3]
  d = torch.where(hfm > 0.5, d, -1e9)
  i = torch.argmax(d, dim=-1)                   # first maximum, as jnp
  return _pick1(d, i), _pick(hf[..., :3], i)


def _hull_world(p, q, hv):
  """Hull vertices [P, HV, 3] -> world [B, P, HV, 3], and the rotation."""
  R = gm.quat_to_mat(q)
  return p[..., None, :] + hv @ R.transpose(-1, -2), R


def plane_hull(p1, q1, s1, p2, q2, hv2, hvm2):
  """Plane (geom1) vs hull (geom2): the 4 deepest vertices."""
  pp, n = _plane_frame(p1, q1)
  w, _ = _hull_world(p2, q2, hv2)                          # [B, P, HV, 3]
  d = torch.einsum('...vi,...i->...v', w - pp[..., None, :], n)
  d = torch.where(hvm2 > 0.5, d, 1e9)
  idx = _keep_deepest(d, 4)
  pos = torch.gather(w, -2, idx[..., None].expand(idx.shape + (3,)))
  return pos, n[..., None, :].expand(pos.shape), torch.gather(d, -1, idx)


def _sphere_hull_one(center, r, p2, q2, hf2, hfm2):
  """Point of radius r vs hull: (pos, n geom1 -> geom2, d)."""
  R2 = gm.quat_to_mat(q2)
  local = torch.einsum('...ji,...j->...i', R2, center - p2)   # R2ᵀ (c - p)
  phi, nloc = _hull_phi_normal(local, hf2, hfm2)
  n_out = torch.einsum('...ij,...j->...i', R2, nloc)   # hull -> sphere
  d = phi - r
  pos = center - n_out * (r + 0.5 * d)[..., None]
  return pos, -n_out, d


def sphere_hull(p1, q1, s1, p2, q2, hf2, hfm2, t1=SPHERE):
  pos, n, d = _sphere_hull_one(p1, _sphere_radius(t1, s1), p2, q2, hf2,
                               hfm2)
  return pos[..., None, :], n[..., None, :], d[..., None]


def capsule_hull(p1, q1, s1, p2, q2, hf2, hfm2):
  a, b = _capsule_segment(p1, q1, s1)
  pts = torch.stack([a, 0.5 * (a + b), b], -2)           # [..., 3, 3]
  exp = lambda x: x[..., None, :].expand(pts.shape[:-1] + x.shape[-1:])
  return _sphere_hull_one(pts, s1[..., None, 0], exp(p2), exp(q2),
                          hf2[:, None], hfm2[:, None])


def hull_hull(p1, q1, hv1, hvm1, hf1, hfm1, he1, hem1,
              p2, q2, hv2, hvm2, hf2, hfm2, he2, hem2, npts: int = 6):
  """Hull vs hull: face + edge-edge SAT, deepest-vertex manifold.

  The separating axes are the face normals of both hulls and the cross
  products of their unique edge directions.  When a face axis wins, the
  manifold is the npts deepest vertices of the other hull along it (with a
  lateral gate); when an edge-edge axis wins, one contact at the closest
  point between the two supporting edges, and npts-1 rows at 1e9.
  """
  w1, R1 = _hull_world(p1, q1, hv1)                        # [B, P, HV, 3]
  w2, R2 = _hull_world(p2, q2, hv2)
  big = 1e9

  def face_axes(hf, hfm, R, p, w_other, hvm_other):
    n = hf[..., :3] @ R.transpose(-1, -2)                  # [B, P, F, 3]
    sup = hf[..., 3] + torch.einsum('...fi,...i->...f', n, p)
    proj = w_other @ n.transpose(-1, -2)                   # [B, P, HV, F]
    proj = torch.where(hvm_other[..., None] > 0.5, proj, big)
    sep = proj.amin(-2) - sup
    return n, sup, proj, torch.where(hfm > 0.5, sep, -big)

  # axes from A's faces (candidate verts are B's), then from B's faces
  nA, supA, projA, sepA = face_axes(hf1, hfm1, R1, p1, w2, hvm2)
  nB, supB, projB, sepB = face_axes(hf2, hfm2, R2, p2, w1, hvm1)

  # edge-edge cross axes
  e1w = he1 @ R1.transpose(-1, -2)                         # [B, P, E1, 3]
  e2w = he2 @ R2.transpose(-1, -2)
  E2 = e2w.shape[-2]
  cr = gm.cross(e1w[..., :, None, :], e2w[..., None, :, :])
  cr = cr.reshape(cr.shape[:-3] + (-1, 3))                # [B, P, A, 3]
  nrm = gm.norm(cr)
  ok = ((hem1[..., :, None] * hem2[..., None, :]).flatten(-2) > 0.5) & \
      (nrm > 1e-6)
  ax = cr / torch.clamp(nrm, min=1e-6)[..., None]
  sgn = torch.where(torch.einsum('...ai,...i->...a', ax, p2 - p1) < 0,
                    -1.0, 1.0)
  ax = ax * sgn[..., None]                                 # hull1 -> hull2
  prE1 = torch.where(hvm1[..., None] > 0.5, w1 @ ax.transpose(-1, -2), -big)
  prE2 = torch.where(hvm2[..., None] > 0.5, w2 @ ax.transpose(-1, -2), big)
  sepE = prE2.amin(-2) - prE1.amax(-2)                     # [B, P, A]
  sepE = torch.where(ok, sepE, -big)

  F1, F2, A = sepA.shape[-1], sepB.shape[-1], sepE.shape[-1]
  sep = torch.cat([sepA, sepB, sepE], -1)
  best = torch.argmax(sep, dim=-1)                         # first maximum
  is_ee = best >= F1 + F2
  from_a = best < F1
  iA = torch.clamp(best, 0, F1 - 1)
  iB = torch.clamp(best - F1, 0, F2 - 1)
  iE = torch.clamp(best - F1 - F2, 0, A - 1)

  # per-vertex depth along the best axis, with a lateral gate: the
  # candidate must lie (loosely) inside the other hull's other half-spaces
  lat_tol = 0.03

  def depth(proj, sup, hfm, i):
    cols = torch.arange(proj.shape[-1], device=proj.device)
    off = proj - sup[..., None, :]
    lat = torch.where((cols == i[..., None, None]) | (hfm[..., None, :] < 0.5),
                      -big, off).amax(-1)
    d_i = torch.gather(off, -1, i[..., None, None].expand(
        off.shape[:-1] + (1,)))[..., 0]
    return torch.where(lat < lat_tol, d_i, big)

  dd = torch.where(from_a[..., None], depth(projA, supA, hfm1, iA),
                   depth(projB, supB, hfm2, iB))           # [B, P, HV]
  pos = torch.where(from_a[..., None, None], w2, w1)
  n12 = torch.where(from_a[..., None], _pick(nA, iA), -_pick(nB, iB))

  idx = _keep_deepest(dd, npts)
  d_out = torch.gather(dd, -1, idx)
  n_out = n12[..., None, :].expand(idx.shape + (3,))
  pos_out = torch.gather(pos, -2, idx[..., None].expand(idx.shape + (3,))) \
      - n_out * 0.5 * d_out[..., None]                     # overlap midpoint

  # edge-edge winner: one contact at the closest point between the two
  # supporting edges; rows 1.. are deactivated
  d1 = _pick(e1w, iE // E2)
  d2 = _pick(e2w, iE % E2)
  v1 = _pick(w1, torch.argmax(_pick(prE1.transpose(-1, -2), iE), -1))
  v2 = _pick(w2, torch.argmin(_pick(prE2.transpose(-1, -2), iE), -1))
  r12 = v2 - v1
  b = _dot(d1, d2)
  den = 1.0 - b * b
  safe = den.abs() > 1e-9
  den_s = torch.where(safe, den, 1.0)
  t = torch.where(safe, (_dot(r12, d1) - b * _dot(r12, d2)) / den_s, 0.0)
  s = torch.where(safe, (b * _dot(r12, d1) - _dot(r12, d2)) / den_s, 0.0)
  pos_ee = 0.5 * (v1 + t[..., None] * d1 + v2 + s[..., None] * d2)
  d_ee = torch.cat([_pick1(sepE, iE)[..., None],
                    torch.full(iE.shape + (npts - 1,), big,
                               device=sepE.device)], -1)
  d_out = torch.where(is_ee[..., None], d_ee, d_out)
  n_out = torch.where(is_ee[..., None, None],
                      _pick(ax, iE)[..., None, :].expand(n_out.shape), n_out)
  pos_out = torch.where(is_ee[..., None, None],
                        pos_ee[..., None, :].expand(pos_out.shape), pos_out)
  return pos_out, n_out, d_out


_BOX_FACES = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)


def _box_as_hull(s, vmax: int):
  """Box half-sizes [P, 3] -> hull arrays padded to vmax vertices (8 real,
  6 faces, 3 edge directions).

  The vertex padding matches the mesh hulls' vertex budget, because
  hull_hull picks candidate positions with a vertex-aligned
  where(from_a, w2, w1).
  """
  P = s.shape[0]
  hv = s.new_zeros((P, vmax, 3))
  hv[:, :8] = _corners(s) * s[:, None, :]
  hvm = s.new_zeros((P, vmax))
  hvm[:, :8] = 1.0
  faces = _table('box_faces', s.device).expand(P, 6, 3)
  hf = torch.cat([faces, torch.cat([s, s], -1)[..., None]], -1)
  eye = torch.eye(3, device=s.device).expand(P, 3, 3)
  return hv, hvm, hf, s.new_ones((P, 6)), eye, s.new_ones((P, 3))


def box_hull(p1, q1, s1, p2, q2, hv2, hvm2, hf2, hfm2, he2, hem2):
  bv, bvm, bf, bfm, be, bem = _box_as_hull(s1, hv2.shape[-2])
  return hull_hull(p1, q1, bv, bvm, bf, bfm, be, bem,
                   p2, q2, hv2, hvm2, hf2, hfm2, he2, hem2, npts=6)


def _ellipsoid_support_fix(q, s, n_pts, d_pts):
  """Bounding-sphere -> support-radius correction along the contact normal.

  The generic kernels treat an ellipsoid as its min-radius bounding
  sphere; the true surface extends to h(n) = |diag(s) n| along the contact
  normal.  h is even in n, so the normal's orientation is irrelevant.
  q [B, P, 4], s [P, 3], n_pts [B, P, npts, 3], d_pts [B, P, npts].
  """
  l = gm.quat_rotate_inv(q[..., None, :], n_pts)
  r_eff = torch.sqrt(((s[:, None, :] * l) ** 2).sum(-1))
  return d_pts + s.amin(-1)[:, None] - r_eff


def _flipped_capsule_ellipsoid(p1, q1, s1, p2, q2, s2):
  """Capsule (geom1) vs ellipsoid: the ellipsoid-capsule kernel with the
  normal negated."""
  pos, n, d = sphere_capsule(p2, q2, s2, p1, q1, s1, t1=ELLIPSOID)
  return pos, -n, d


def _kernel(t1: int, t2: int):
  """(t1, t2) -> batched pair kernel (p1, q1, s1, p2, q2, s2); a cylinder
  is a capsule except against a plane."""
  t1c = CAPSULE if t1 == CYLINDER else t1
  t2c = CAPSULE if t2 == CYLINDER else t2
  if t1c == PLANE:
    if t2c == SPHERE:
      return functools.partial(plane_sphere, t2=t2)
    if t2 == CYLINDER:
      return plane_cylinder
    if t2c == CAPSULE:
      return plane_capsule
    if t2c == ELLIPSOID:
      return plane_ellipsoid
    if t2c == BOX:
      return plane_box
  if t1c in (SPHERE, ELLIPSOID):
    if t2c in (SPHERE, ELLIPSOID):
      return functools.partial(sphere_sphere, t1=t1, t2=t2)
    if t2c == CAPSULE:
      return functools.partial(sphere_capsule, t1=t1)
    if t2c == BOX:
      return functools.partial(sphere_box, t1=t1)
  if t1c == CAPSULE:
    if t2c == CAPSULE:
      return capsule_capsule
    if t2c == ELLIPSOID:
      return _flipped_capsule_ellipsoid
    if t2c == BOX:
      return capsule_box
  if t1c == BOX and t2c == BOX:
    return box_box
  raise NotImplementedError(f'collision kernel ({t1}, {t2})')


_HULL_FIELDS = ('hull_vert', 'hull_vmask', 'hull_face', 'hull_fmask',
                'hull_edge', 'hull_emask')


def _hull_args(model: Model, geoms: np.ndarray, key: str):
  """The padded hull arrays of each geom of a pair group (cached on the
  model's device under ``key``)."""
  hid = np.asarray([model.geom_hullid[g] for g in geoms], np.int64)
  return tuple(model.const(f'{key}.{name}',
                           lambda a=getattr(model, name): a.cpu().numpy()[hid])
               for name in _HULL_FIELDS)


def _collide_mesh(model: Model, t1: int, key: str, g1, g2, p1, q1, s1,
                  p2, q2):
  """A pair group whose geom2 is a mesh (its convex hull)."""
  hv2, hvm2, hf2, hfm2, he2, hem2 = _hull_args(model, g2, key + '.2')
  t1c = CAPSULE if t1 == CYLINDER else t1
  if t1 == MESH:
    hull1 = _hull_args(model, g1, key + '.1')
    return hull_hull(p1, q1, *hull1, p2, q2, hv2, hvm2, hf2, hfm2, he2, hem2)
  if t1c == PLANE:
    return plane_hull(p1, q1, s1, p2, q2, hv2, hvm2)
  if t1c in (SPHERE, ELLIPSOID):
    return sphere_hull(p1, q1, s1, p2, q2, hf2, hfm2, t1=t1)
  if t1c == CAPSULE:
    return capsule_hull(p1, q1, s1, p2, q2, hf2, hfm2)
  if t1c == BOX:
    return box_hull(p1, q1, s1, p2, q2, hv2, hvm2, hf2, hfm2, he2, hem2)
  raise NotImplementedError(f'mesh collision vs type {t1}')


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
  for gi, ((t1, t2), pairs) in enumerate(model.col_pairs):
    npts = _POINTS[(t1, t2)]
    g1 = np.asarray([p[0] for p in pairs], np.int32)
    g2 = np.asarray([p[1] for p in pairs], np.int32)
    sl = slice(off, off + len(pairs))
    off += len(pairs)
    p1, q1, s1 = P1a[:, sl], Q1a[:, sl], S1a[sl]
    p2, q2, s2 = P2a[:, sl], Q2a[:, sl], S2a[sl]
    if t2 == MESH:
      pos, n, d = _collide_mesh(model, t1, f'col_hull{gi}', g1, g2, p1, q1,
                                s1, p2, q2)
    else:
      pos, n, d = _kernel(t1, t2)(p1, q1, s1, p2, q2, s2)  # [B, P, npts..]
    # ellipsoids: the bounding-sphere distance becomes the support radius
    # along the contact normal (plane_ellipsoid is exact: t1 == PLANE)
    if ELLIPSOID in (t1, t2) and t1 != PLANE:
      if t1 == ELLIPSOID:
        d = _ellipsoid_support_fix(q1, s1, n, d)
      if t2 == ELLIPSOID:
        d = _ellipsoid_support_fix(q2, s2, n, d)
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
