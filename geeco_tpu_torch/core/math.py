"""Quaternion / SO(3) / SE(3) math primitives (PyTorch).

Counterpart of ``geeco_tpu/core/math.py``: the same ops under the same
names, each broadcasting over any number of leading dims (env, body,
vertex ...).  Quaternions are MuJoCo's ``[w, x, y, z]``, scalar first, unit
norm, rotating a vector from the local frame into the parent/world frame.
"""

from __future__ import annotations

import functools

import torch

# ----------------------------------------------------------------------------
# quaternions
# ----------------------------------------------------------------------------


def _vec(values, like: torch.Tensor) -> torch.Tensor:
  """``values`` as a constant of ``like``'s dtype on its device, made once:
  the hot path makes no host-to-device copy (which a CUDA graph's capture
  cannot hold).  Callers only read it."""
  return _const(tuple(values), like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
  return torch.tensor(values, dtype=dtype, device=device)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis, broadcasting leading dims."""
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False
         ) -> torch.Tensor:
  return torch.linalg.vector_norm(v, dim=dim, keepdim=keepdim)


def quat_identity(device=None) -> torch.Tensor:
  return torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  return q / torch.clamp(norm(q, keepdim=True), min=eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Hamilton product a ⊗ b (both wxyz)."""
  aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
  bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
  return torch.stack(
      [
          aw * bw - ax * bx - ay * by - az * bz,
          aw * bx + ax * bw + ay * bz - az * by,
          aw * by - ax * bz + ay * bw + az * bx,
          aw * bz + ax * by - ay * bx + az * bw,
      ],
      dim=-1,
  )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return q * _vec([1.0, -1.0, -1.0, -1.0], q)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
  """Inverse of a unit quaternion (= conjugate)."""
  return quat_conj(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector v by quaternion q (local -> parent frame)."""
  # v' = v + 2*w*(u x v) + 2*(u x (u x v)),  u = q_xyz
  u = q[..., 1:]
  w = q[..., 0:1]
  uv = cross(u, v)
  return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Quaternion -> 3x3 rotation matrix."""
  w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  r = torch.stack(
      [
          1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
          2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
          2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
      ],
      dim=-1,
  )
  return r.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix -> quaternion (wxyz), branch-free (Shepperd)."""
  tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
  qw = torch.stack([
      1.0 + tr,
      m[..., 2, 1] - m[..., 1, 2],
      m[..., 0, 2] - m[..., 2, 0],
      m[..., 1, 0] - m[..., 0, 1],
  ], -1)
  qx = torch.stack([
      m[..., 2, 1] - m[..., 1, 2],
      1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
      m[..., 0, 1] + m[..., 1, 0],
      m[..., 0, 2] + m[..., 2, 0],
  ], -1)
  qy = torch.stack([
      m[..., 0, 2] - m[..., 2, 0],
      m[..., 0, 1] + m[..., 1, 0],
      1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
      m[..., 1, 2] + m[..., 2, 1],
  ], -1)
  qz = torch.stack([
      m[..., 1, 0] - m[..., 0, 1],
      m[..., 0, 2] + m[..., 2, 0],
      m[..., 1, 2] + m[..., 2, 1],
      1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
  ], -1)
  cand = torch.stack([qw, qx, qy, qz], -2)  # [..., 4(case), 4(quat)]
  # argmax returns the first maximum, as jnp.argmax does
  case = torch.argmax(torch.stack([
      tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1), dim=-1)
  idx = case[..., None, None].expand(case.shape + (1, 4))
  q = torch.gather(cand, -2, idx)[..., 0, :]
  return quat_normalize(q)


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
  """Intrinsic x-y-z euler angles (MuJoCo compiler default) -> quaternion."""
  ex, ey, ez = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
  zeros = torch.zeros_like(ex)
  qx = torch.stack([torch.cos(ex), torch.sin(ex), zeros, zeros], -1)
  qy = torch.stack([torch.cos(ey), zeros, torch.sin(ey), zeros], -1)
  qz = torch.stack([torch.cos(ez), zeros, zeros, torch.sin(ez)], -1)
  return quat_mul(quat_mul(qx, qy), qz)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
  """Integrate unit quaternion by world-frame angular velocity over dt:
  q' = exp(0.5*omega*dt) ⊗ q."""
  angle = norm(omega, keepdim=True)
  half = 0.5 * angle * dt
  k = torch.where(angle > 1e-9,
                  torch.sin(half) / torch.clamp(angle, min=1e-9),
                  0.5 * dt * torch.ones_like(angle))
  dq = torch.cat([torch.cos(half), omega * k], dim=-1)
  return quat_normalize(quat_mul(dq, q))


def quat_tangent(q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
  """d(q)/dt given world-frame angular velocity: 0.5 * [0, omega] ⊗ q."""
  zero = torch.zeros_like(omega[..., :1])
  ow = torch.cat([zero, omega], dim=-1)
  return 0.5 * quat_mul(ow, q)


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Rotation 'difference' qa ⊖ qb as a world-frame rotation vector
  (the axis-angle v with exp(v) ⊗ qb = qa)."""
  dq = quat_mul(qa, quat_conj(qb))
  dq = torch.where(dq[..., 0:1] < 0, -dq, dq)    # shortest path
  w = torch.clamp(dq[..., 0], -1.0, 1.0)
  angle = 2.0 * torch.arccos(w)
  s = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-18))
  axis = dq[..., 1:] / s[..., None]
  return torch.where(angle[..., None] > 1e-7, axis * angle[..., None],
                     2.0 * dq[..., 1:])


def mat_to_euler(m: torch.Tensor) -> torch.Tensor:
  """Rotation matrix -> intrinsic x-y-z euler (gym rotations.mat2euler)."""
  cy = torch.sqrt(m[..., 2, 2] * m[..., 2, 2] + m[..., 1, 2] * m[..., 1, 2])
  cond = cy > 1e-6
  ex = torch.where(cond, torch.arctan2(-m[..., 1, 2], m[..., 2, 2]),
                   torch.arctan2(m[..., 2, 1], m[..., 1, 1]))
  ey = torch.arctan2(m[..., 0, 2], cy)
  ez = torch.where(cond, torch.arctan2(-m[..., 0, 1], m[..., 0, 0]),
                   torch.zeros_like(ex))
  return torch.stack([ex, ey, ez], dim=-1)


# ----------------------------------------------------------------------------
# SE(3) transforms: (pos[3], quat[4]) pairs
# ----------------------------------------------------------------------------


def transform_point(pos, quat, p):
  """Apply transform (pos, quat) to local point p -> world point."""
  return pos + quat_rotate(quat, p)


def transform_inv_point(pos, quat, p):
  """World point p -> local frame of transform (pos, quat)."""
  return quat_rotate_inv(quat, p - pos)


def transform_compose(pos_a, quat_a, pos_b, quat_b):
  """Compose A*B (apply B first in A's frame): returns (pos, quat)."""
  return transform_point(pos_a, quat_a, pos_b), quat_normalize(
      quat_mul(quat_a, quat_b))


# ----------------------------------------------------------------------------
# misc
# ----------------------------------------------------------------------------


def skew(v: torch.Tensor) -> torch.Tensor:
  """Skew-symmetric cross-product matrix of v."""
  x, y, z = v[..., 0], v[..., 1], v[..., 2]
  zero = torch.zeros_like(x)
  m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
  return m.reshape(v.shape[:-1] + (3, 3))


def norm_safe(v: torch.Tensor, axis: int = -1, eps: float = 1e-12):
  """(norm, unit_vector) with zero-safe normalization."""
  n = norm(v, dim=axis, keepdim=True)
  return n.squeeze(axis), v / torch.clamp(n, min=eps)
