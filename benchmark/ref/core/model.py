"""Static ``Model`` and dynamic ``State`` for the PyTorch physics core.

Counterpart of ``geeco_tpu/core/model.py``.  The JAX package keeps these as
flax pytrees; here they are plain dataclasses of tensors, with the
structural integers and tuples (tree topology, qpos layout, geom types,
collision pair lists) kept as Python values.

``State`` and ``Kin`` carry a leading env axis written out: ``qpos`` is
``[B, nq]``, ``xpos`` is ``[B, nbody, 3]``, and so on.  ``Model`` is shared by
every env and has no env axis.

Everything is float32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# --- enum codes (match MuJoCo's mjtJoint / mjtGeom) --------------------------
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
PLANE, HFIELD, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX, MESH = range(8)

JOINT_QPOS_DIM = {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}
JOINT_DOF_DIM = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}


def _move(obj, device):
  """Copy of a dataclass with every tensor (and nested dataclass) moved."""
  changes = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    if isinstance(v, torch.Tensor):
      changes[f.name] = v.to(device)
    elif dataclasses.is_dataclass(v):
      changes[f.name] = _move(v, device)
  return dataclasses.replace(obj, **changes)


class _Tensors:
  """Mixin: ``replace`` (as flax's) and ``to(device)``."""

  def replace(self, **changes):
    return dataclasses.replace(self, **changes)

  def to(self, device):
    return _move(self, device)


@dataclass
class Option(_Tensors):
  """Simulation options (<option> element)."""
  timestep: torch.Tensor           # scalar
  gravity: torch.Tensor            # [3]
  density: torch.Tensor            # scalar, ambient fluid density
  viscosity: torch.Tensor          # scalar
  solver_iterations: int = 30
  ls_tolerance: float = 1e-8


@dataclass
class Model(_Tensors):
  """Static scene description compiled from MJCF (core/mjcf.py)."""

  opt: Option

  # --- sizes ---
  nq: int
  nv: int
  nu: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  nmocap: int
  ncam: int
  nlight: int
  neq: int

  # --- bodies ---
  body_parentid: Tuple[int, ...]
  body_mocapid: Tuple[int, ...]
  body_jntadr: Tuple[Tuple[int, ...], ...]
  body_name: Tuple[str, ...]
  body_pos: torch.Tensor        # [nbody, 3]
  body_quat: torch.Tensor       # [nbody, 4]
  body_mass: torch.Tensor       # [nbody]
  body_inertia: torch.Tensor    # [nbody, 3]
  body_ipos: torch.Tensor       # [nbody, 3]
  body_iquat: torch.Tensor      # [nbody, 4]

  # --- joints ---
  jnt_type: Tuple[int, ...]
  jnt_bodyid: Tuple[int, ...]
  jnt_qposadr: Tuple[int, ...]
  jnt_dofadr: Tuple[int, ...]
  jnt_limited: Tuple[bool, ...]
  jnt_name: Tuple[str, ...]
  jnt_pos: torch.Tensor         # [njnt, 3]
  jnt_axis: torch.Tensor        # [njnt, 3]
  jnt_range: torch.Tensor       # [njnt, 2]
  jnt_stiffness: torch.Tensor   # [njnt]
  jnt_ref: torch.Tensor         # [njnt]
  jnt_springref: torch.Tensor   # [njnt]
  jnt_solref: torch.Tensor      # [njnt, 2]
  jnt_solimp: torch.Tensor      # [njnt, 3]

  # --- dofs ---
  dof_jntid: Tuple[int, ...]
  dof_armature: torch.Tensor    # [nv]
  dof_damping: torch.Tensor     # [nv]

  # --- geoms ---
  geom_type: Tuple[int, ...]
  geom_bodyid: Tuple[int, ...]
  geom_contype: Tuple[int, ...]
  geom_conaffinity: Tuple[int, ...]
  geom_condim: Tuple[int, ...]
  geom_meshid: Tuple[int, ...]
  geom_name: Tuple[str, ...]
  geom_pos: torch.Tensor        # [ngeom, 3]
  geom_quat: torch.Tensor       # [ngeom, 4]
  geom_size: torch.Tensor       # [ngeom, 3]
  geom_rgba: torch.Tensor       # [ngeom, 4]
  geom_friction: torch.Tensor   # [ngeom, 3]
  geom_solref: torch.Tensor     # [ngeom, 2]
  geom_solimp: torch.Tensor     # [ngeom, 3]
  geom_margin: torch.Tensor     # [ngeom]

  # --- sites ---
  site_bodyid: Tuple[int, ...]
  site_name: Tuple[str, ...]
  site_pos: torch.Tensor        # [nsite, 3]
  site_quat: torch.Tensor       # [nsite, 4]
  site_size: torch.Tensor       # [nsite, 3]
  site_rgba: torch.Tensor       # [nsite, 4]

  # --- cameras ---
  cam_bodyid: Tuple[int, ...]
  cam_name: Tuple[str, ...]
  cam_pos: torch.Tensor         # [ncam, 3]
  cam_quat: torch.Tensor        # [ncam, 4]
  cam_fovy: torch.Tensor        # [ncam]

  # --- lights ---
  light_pos: torch.Tensor       # [nlight, 3]
  light_dir: torch.Tensor       # [nlight, 3]
  light_directional: Tuple[bool, ...]

  # --- actuators (position servos) ---
  actuator_jntid: Tuple[int, ...]
  actuator_name: Tuple[str, ...]
  actuator_kp: torch.Tensor         # [nu]
  actuator_ctrlrange: torch.Tensor  # [nu, 2]

  # --- equality constraints (weld) ---
  eq_body1: Tuple[int, ...]
  eq_body2: Tuple[int, ...]
  eq_solref: torch.Tensor       # [neq, 2]
  eq_solimp: torch.Tensor       # [neq, 3]

  # --- collision pair groups: ((typecode1, typecode2), ((g1, g2), ...)) ---
  col_pairs: Tuple[Any, ...]

  # --- convex hulls for mesh narrowphase (padded) ---
  geom_hullid: Tuple[int, ...]
  hull_vert: torch.Tensor       # [nhull, HV, 3]
  hull_vmask: torch.Tensor      # [nhull, HV]
  hull_face: torch.Tensor       # [nhull, HF, 4]
  hull_fmask: torch.Tensor      # [nhull, HF]
  hull_edge: torch.Tensor       # [nhull, HE, 3]
  hull_emask: torch.Tensor      # [nhull, HE]

  # --- default qpos (reference configuration) ---
  qpos0: torch.Tensor           # [nq]

  # device copies of static numpy index/mask arrays, filled on first use
  # (see ``const``); ``to(device)`` starts a fresh, empty cache
  _consts: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False,
                                           compare=False)

  @property
  def device(self) -> torch.device:
    return self.body_pos.device

  def to(self, device):
    return dataclasses.replace(_move(self, device), _consts={})

  def const(self, key: str, value) -> torch.Tensor:
    """``value`` (numpy) as a tensor on the model's device, cached by key.

    The static structure (index arrays, masks) is numpy, computed once per
    scene; this keeps one device copy of each so the hot path issues no
    host-to-device copy.  Integer arrays become int64 (index dtype).
    ``value`` may be a function that makes the array, called only when
    ``key`` is not cached yet.
    """
    t = self._consts.get(key)
    if t is None:
      arr = np.asarray(value() if callable(value) else value)
      if arr.dtype.kind in 'iu':
        arr = arr.astype(np.int64)
      t = torch.as_tensor(arr, device=self.device)
      self._consts[key] = t
    return t

  # ---------------------------------------------------------------- helpers
  def name2id(self, names: Tuple[str, ...], name: str) -> int:
    return names.index(name)

  def body(self, name: str) -> int:
    return self.body_name.index(name)

  def joint(self, name: str) -> int:
    return self.jnt_name.index(name)

  def geom(self, name: str) -> int:
    return self.geom_name.index(name)

  def site(self, name: str) -> int:
    return self.site_name.index(name)

  def cam(self, name: str) -> int:
    return self.cam_name.index(name)

  def actuator(self, name: str) -> int:
    return self.actuator_name.index(name)

  def jnt_qpos_slice(self, name: str):
    j = self.joint(name)
    adr = self.jnt_qposadr[j]
    return adr, adr + JOINT_QPOS_DIM[self.jnt_type[j]]

  def jnt_dof_slice(self, name: str):
    j = self.joint(name)
    adr = self.jnt_dofadr[j]
    return adr, adr + JOINT_DOF_DIM[self.jnt_type[j]]


@dataclass
class State(_Tensors):
  """Per-env dynamic state, leading env axis B on every tensor."""
  qpos: torch.Tensor        # [B, nq]
  qvel: torch.Tensor        # [B, nv]
  ctrl: torch.Tensor        # [B, nu]
  mocap_pos: torch.Tensor   # [B, nmocap, 3]
  mocap_quat: torch.Tensor  # [B, nmocap, 4]
  time: torch.Tensor        # [B]
  efc_force: Optional[torch.Tensor] = None  # [B, ne] solver warmstart

  @property
  def batch(self) -> int:
    return self.qpos.shape[0]


@dataclass
class Kin(_Tensors):
  """Forward-kinematics products, leading env axis B."""
  xpos: torch.Tensor        # [B, nbody, 3]  body frame origin, world
  xquat: torch.Tensor       # [B, nbody, 4]
  ximat: torch.Tensor       # [B, nbody, 3, 3]
  xipos: torch.Tensor       # [B, nbody, 3]  body COM, world
  geom_xpos: torch.Tensor   # [B, ngeom, 3]
  geom_xquat: torch.Tensor  # [B, ngeom, 4]
  site_xpos: torch.Tensor   # [B, nsite, 3]
  site_xmat: torch.Tensor   # [B, nsite, 3, 3]


def make_state(model: Model, batch: int = 1) -> State:
  """``batch`` envs at the model reference configuration."""
  dev = model.device
  mids = [b for b in range(model.nbody) if model.body_mocapid[b] >= 0]
  mpos = model.body_pos[mids] if mids else torch.zeros((0, 3), device=dev)
  mquat = model.body_quat[mids] if mids else torch.zeros((0, 4), device=dev)

  def rep(x):
    return x.to(torch.float32).expand((batch,) + tuple(x.shape)).clone()

  return State(
      qpos=rep(model.qpos0),
      qvel=torch.zeros((batch, model.nv), device=dev),
      ctrl=torch.zeros((batch, model.nu), device=dev),
      mocap_pos=rep(mpos),
      mocap_quat=rep(mquat),
      time=torch.zeros((batch,), device=dev),
  )


# ------------------------------------------------------------------ qpos ops


def get_joint_qpos(model: Model, qpos: torch.Tensor, name: str
                   ) -> torch.Tensor:
  lo, hi = model.jnt_qpos_slice(name)
  val = qpos[..., lo:hi]
  return val[..., 0] if hi - lo == 1 else val


def set_joint_qpos(model: Model, qpos: torch.Tensor, name: str,
                   value) -> torch.Tensor:
  """Copy of ``qpos`` with the joint's coordinates set (broadcast)."""
  lo, hi = model.jnt_qpos_slice(name)
  value = torch.as_tensor(value, dtype=qpos.dtype, device=qpos.device)
  if value.ndim == 0 or (hi - lo == 1 and value.shape[-1:] != (1,)):
    value = value[..., None]
  out = qpos.clone()
  out[..., lo:hi] = value
  return out


def get_joint_qvel(model: Model, qvel: torch.Tensor, name: str
                   ) -> torch.Tensor:
  lo, hi = model.jnt_dof_slice(name)
  val = qvel[..., lo:hi]
  return val[..., 0] if hi - lo == 1 else val


def set_joint_qvel(model: Model, qvel: torch.Tensor, name: str,
                   value) -> torch.Tensor:
  lo, hi = model.jnt_dof_slice(name)
  value = torch.as_tensor(value, dtype=qvel.dtype, device=qvel.device)
  if value.ndim == 0 or (hi - lo == 1 and value.shape[-1:] != (1,)):
    value = value[..., None]
  out = qvel.clone()
  out[..., lo:hi] = value
  return out
