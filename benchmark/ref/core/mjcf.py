"""MJCF-subset compiler: reference scene XMLs -> ``Model`` + assets.

Carried across from ``geeco_tpu/core/mjcf.py``: the compiler is numpy and is
unchanged, except that the final ``Model(...)`` holds torch tensors and the
texture readers raise instead of falling back to a grey colour.

Supports exactly the MJCF features exercised by the GEECO scenes
(reference: assets/gym/envs/*.xml, assets/gym/robots/fetch-gym.xml,
assets/gym/defaults/geeco-gym.xml):

  * <include>, <compiler meshdir/texturedir>, <option timestep/density/...>
  * nested <default> classes with childclass inheritance
  * <asset>: binary STL meshes, PNG textures (reduced to a mean color for the
    round-1 flat-shaded rasterizer), materials
  * <worldbody>: nested bodies, free/slide/hinge joints, geoms
    (plane/sphere/capsule/ellipsoid/cylinder/box/mesh), sites, cameras,
    lights, inertials, mocap bodies
  * <actuator><position>, <equality><weld>, <contact><exclude>

Compile-time work mirrors MuJoCo's compiler: reference qpos0 assembly,
geom-derived body inertia, weld-group computation and static collision-pair
enumeration (in place of a runtime broadphase — scenes here are small
enough that an exhaustive masked pair list beats data-dependent pruning).

Collision policy for mesh geoms: meshes attached to articulated (non-free)
bodies — i.e. the Fetch arm links — do not generate contact pairs; mesh
geoms on free bodies (nut/ball/bridge/diamond task objects) collide through
their convex hulls (``build_hull``; physics/collision.py hull kernels).
The reference mesh objects are unions of convex parts, one geom per part
(e.g. the 10-part nut, assets/gym/envs/geeco-nut-cone.xml:41-54), so a
per-geom hull is the exact narrowphase shape.  Mesh vertices are
re-centered so the AABB center is the geom origin.
"""

from __future__ import annotations

import os
import struct as pystruct
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .model import (BALL, BOX, CAPSULE, CYLINDER, ELLIPSOID, FREE, HINGE,
                    JOINT_DOF_DIM, JOINT_QPOS_DIM, MESH, Model, Option, PLANE,
                    SLIDE, SPHERE)

_GEOM_TYPES = {
    'plane': PLANE, 'sphere': SPHERE, 'capsule': CAPSULE,
    'ellipsoid': ELLIPSOID, 'cylinder': CYLINDER, 'box': BOX, 'mesh': MESH,
}
_JOINT_TYPES = {'free': FREE, 'ball': BALL, 'slide': SLIDE, 'hinge': HINGE}

_DEFAULT_SOLREF = (0.02, 1.0)
_DEFAULT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)  # mujoco 2.0 uses 3 values; padded
_DEFAULT_FRICTION = (1.0, 0.005, 0.0001)


# ---------------------------------------------------------------- assets


@dataclass
class MeshAsset:
  name: str
  vert: np.ndarray  # [n, 3] float32, AABB-centered
  face: np.ndarray  # [m, 3] int32
  aabb_half: np.ndarray  # [3] half extents of AABB
  center: np.ndarray     # [3] original AABB center (before recentering)


@dataclass
class Assets:
  meshes: List[MeshAsset] = field(default_factory=list)
  mesh_ids: Dict[str, int] = field(default_factory=dict)
  materials: Dict[str, np.ndarray] = field(default_factory=dict)  # rgba
  textures: Dict[str, np.ndarray] = field(default_factory=dict)   # mean rgb
  # full texture images [res, res, 3] float32 in [0,1] (renderer sampling)
  texture_images: Dict[str, np.ndarray] = field(default_factory=dict)
  # material -> (texture name, repeat_x, repeat_y)
  material_texture: Dict[str, Tuple[str, float, float]] = \
      field(default_factory=dict)
  # per-geom material name ('' if none), aligned with model geom ids
  geom_material: List[str] = field(default_factory=list)


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
  """Binary STL -> (verts [n,3], faces [m,3]); vertices deduplicated."""
  with open(path, 'rb') as f:
    data = f.read()
  if data[:5] == b'solid' and b'facet' in data[:200]:
    # ASCII STL fallback
    verts = []
    for line in data.decode('ascii', errors='ignore').splitlines():
      parts = line.split()
      if parts and parts[0] == 'vertex':
        verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    tri = np.asarray(verts, np.float32).reshape(-1, 3)
  else:
    n = pystruct.unpack('<I', data[80:84])[0]
    rec = np.frombuffer(data[84:84 + n * 50], dtype=np.uint8).reshape(n, 50)
    tri = rec[:, 12:48].copy().view('<f4').reshape(n, 3, 3).reshape(-1, 3)
    tri = tri.astype(np.float32)
  # deduplicate vertices
  uniq, inv = np.unique(tri.round(decimals=6), axis=0, return_inverse=True)
  faces = inv.reshape(-1, 3).astype(np.int32)
  return uniq.astype(np.float32), faces


def _texture_mean_rgb(path: str) -> np.ndarray:
  # Pillow is required: a texture that cannot be read raises, since a grey
  # stand-in would silently change every rendered frame
  from PIL import Image
  with Image.open(path) as im:
    img = np.asarray(im.convert('RGB'), np.float32) / 255.0
  return img.reshape(-1, 3).mean(axis=0)


def _texture_image(path: str, res: int = 64) -> np.ndarray:
  """Texture image downsampled to [res, res, 3] float32 in [0,1]."""
  from PIL import Image
  with Image.open(path) as im:
    img = im.convert('RGB').resize((res, res), Image.BILINEAR)
  return np.asarray(img, np.float32) / 255.0


# ---------------------------------------------------------------- parsing


def _parse_floats(s: str) -> np.ndarray:
  return np.array([float(x) for x in s.split()], np.float64)


def _euler_to_quat_np(e: np.ndarray) -> np.ndarray:
  """Intrinsic xyz euler -> wxyz quaternion (numpy, compile-time)."""
  def axis_quat(angle, axis):
    q = np.zeros(4)
    q[0] = np.cos(angle / 2)
    q[1 + axis] = np.sin(angle / 2)
    return q
  def mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw])
  q = axis_quat(e[0], 0)
  q = mul(q, axis_quat(e[1], 1))
  q = mul(q, axis_quat(e[2], 2))
  return q / np.linalg.norm(q)


def _elem_quat(el: ET.Element) -> np.ndarray:
  if 'quat' in el.attrib:
    q = _parse_floats(el.attrib['quat'])
    n = np.linalg.norm(q)
    return q / n if n > 0 else np.array([1.0, 0, 0, 0])
  if 'euler' in el.attrib:
    return _euler_to_quat_np(_parse_floats(el.attrib['euler']))
  if 'axisangle' in el.attrib:
    aa = _parse_floats(el.attrib['axisangle'])
    axis = aa[:3] / max(np.linalg.norm(aa[:3]), 1e-12)
    q = np.zeros(4)
    q[0] = np.cos(aa[3] / 2)
    q[1:] = axis * np.sin(aa[3] / 2)
    return q
  return np.array([1.0, 0.0, 0.0, 0.0])


def _resolve_includes(path: str) -> ET.Element:
  """Parse XML and splice <include> elements in place."""
  tree = ET.parse(path)
  root = tree.getroot()
  base = os.path.dirname(os.path.abspath(path))

  def splice(parent: ET.Element):
    i = 0
    while i < len(parent):
      child = parent[i]
      if child.tag == 'include':
        inc_path = os.path.normpath(os.path.join(base, child.attrib['file']))
        inc_root = _resolve_includes(inc_path)
        parent.remove(child)
        # an included <mujoco> contributes its children at splice point
        for j, sub in enumerate(list(inc_root)):
          parent.insert(i + j, sub)
      else:
        splice(child)
        i += 1

  splice(root)
  return root


def _merge_mujoco_sections(root: ET.Element) -> ET.Element:
  """Merge duplicate top-level sections (asset/default/...) after includes."""
  merged: Dict[str, ET.Element] = {}
  for child in list(root):
    if child.tag in ('asset', 'default', 'equality', 'contact', 'actuator',
                     'worldbody'):
      if child.tag in merged:
        for sub in list(child):
          merged[child.tag].append(sub)
        root.remove(child)
      else:
        merged[child.tag] = child
  return root


class _Defaults:
  """MJCF default-class resolution with inheritance."""

  def __init__(self):
    self.classes: Dict[str, Dict[str, Dict[str, str]]] = {'': {}}

  def load(self, default_el: Optional[ET.Element]):
    if default_el is None:
      return
    self._walk(default_el, '', {})

  def _walk(self, el: ET.Element, cls: str, inherited: Dict):
    table = {k: dict(v) for k, v in inherited.items()}
    for child in el:
      if child.tag == 'default':
        continue
      table.setdefault(child.tag, {}).update(child.attrib)
    self.classes[cls] = table
    for child in el:
      if child.tag == 'default':
        sub_cls = child.attrib.get('class', '')
        self._walk(child, sub_cls, table)

  def resolve(self, el: ET.Element, tag: str, cls: str) -> Dict[str, str]:
    use_cls = el.attrib.get('class', cls)
    base = dict(self.classes.get(use_cls, {}).get(tag, {}))
    base.update(el.attrib)
    return base


# ---------------------------------------------------------------- inertia


def _geom_mass_inertia(gtype: int, size: np.ndarray, mass: Optional[float],
                       density: float, mesh: Optional[MeshAsset]):
  """Returns (mass, diag inertia about geom COM in geom frame)."""
  if gtype == PLANE:
    return 0.0, np.zeros(3)
  if gtype == SPHERE:
    r = size[0]
    vol = 4 / 3 * np.pi * r ** 3
    m = mass if mass is not None else density * vol
    i = 0.4 * m * r * r
    return m, np.array([i, i, i])
  if gtype == BOX:
    hx, hy, hz = size[:3]
    vol = 8 * hx * hy * hz
    m = mass if mass is not None else density * vol
    return m, m / 3.0 * np.array([hy * hy + hz * hz, hx * hx + hz * hz,
                                  hx * hx + hy * hy])
  if gtype == CAPSULE:
    r, hl = size[0], size[1]
    vol_cyl = np.pi * r * r * 2 * hl
    vol_sph = 4 / 3 * np.pi * r ** 3
    m = mass if mass is not None else density * (vol_cyl + vol_sph)
    mc = m * vol_cyl / (vol_cyl + vol_sph)
    ms = m - mc
    # cylinder about center, axis=z
    ixy = mc * ((3 * r * r + 4 * hl * hl) / 12.0)
    iz = 0.5 * mc * r * r
    # hemispheres via parallel axis
    ixy += ms * (0.4 * r * r + hl * hl + 0.75 * hl * r)
    iz += 0.4 * ms * r * r
    return m, np.array([ixy, ixy, iz])
  if gtype == CYLINDER:
    r, hl = size[0], size[1]
    vol = np.pi * r * r * 2 * hl
    m = mass if mass is not None else density * vol
    ixy = m * (3 * r * r + 4 * hl * hl) / 12.0
    return m, np.array([ixy, ixy, 0.5 * m * r * r])
  if gtype == ELLIPSOID:
    a, b, c = size[:3]
    vol = 4 / 3 * np.pi * a * b * c
    m = mass if mass is not None else density * vol
    return m, m / 5.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
  if gtype == MESH:
    assert mesh is not None
    hx, hy, hz = mesh.aabb_half
    vol = 8 * hx * hy * hz
    m = mass if mass is not None else density * vol
    return m, m / 3.0 * np.array([hy * hy + hz * hz, hx * hx + hz * hz,
                                  hx * hx + hy * hy])
  raise ValueError(f'inertia for geom type {gtype} unsupported')


# --- convex hulls for mesh narrowphase ------------------------------------

HULL_VMAX = 24   # padded vertex budget per hull
HULL_FMAX = 44   # padded face budget (<= 2*VMAX-4 for VMAX=24)
HULL_EMAX = 12   # padded unique-edge-direction budget (SAT cross axes)


def build_hull(verts: np.ndarray, vmax: int = HULL_VMAX,
               fmax: int = HULL_FMAX):
  """Convex hull of a point cloud, decimated to fit static budgets.

  Returns (vert [vmax, 3], vmask [vmax], face [fmax, 4], fmask [fmax])
  with faces as outward half-spaces n·x <= off.  The reference mesh
  objects are unions of convex parts (e.g. the 10-part nut,
  assets/gym/envs/geeco-nut-cone.xml:41-54), so one hull per mesh geom is
  the exact convex narrowphase shape.
  """
  from scipy.spatial import ConvexHull
  pts = np.asarray(verts, np.float64)
  assert fmax >= 2 * vmax - 4, 'face budget must fit a hull on vmax verts'

  def directions(n):
    """6 axis directions + (n-6) Fibonacci-sphere directions."""
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    k = np.arange(n - 6) + 0.5
    phi = np.arccos(1.0 - 2.0 * k / (n - 6))
    theta = np.pi * (1.0 + np.sqrt(5.0)) * k
    fib = np.stack([np.sin(phi) * np.cos(theta),
                    np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    return np.concatenate([axes, fib])

  def finish(p):
    hull = ConvexHull(p)
    hv = p[hull.vertices]
    # merge coplanar triangulated facets into unique half-spaces
    eq = hull.equations  # [m, 4]: n·x + d <= 0
    eqr = np.round(eq / 1e-4) * 1e-4
    planes = np.unique(eqr, axis=0)
    if hv.shape[0] > vmax or planes.shape[0] > fmax:
      return None
    # support-point decimation must preserve the AABB exactly
    shrink = max(float((pts.min(0) - hv.min(0)).max()),
                 float((hv.max(0) - pts.max(0)).max()))
    assert shrink <= 1e-6, (
        f'hull decimation shrank AABB by {shrink:.6f}')
    nv, nf = hv.shape[0], planes.shape[0]
    vert = np.zeros((vmax, 3), np.float32)
    vert[:nv] = hv
    vmask = np.zeros(vmax, np.float32)
    vmask[:nv] = 1.0
    face = np.zeros((fmax, 4), np.float32)
    face[:nf, :3] = planes[:, :3]
    face[:nf, 3] = -planes[:, 3]     # n·x <= off
    fmask = np.zeros(fmax, np.float32)
    fmask[:nf] = 1.0
    return vert, vmask, face, fmask

  # exact hull if it already fits the budgets
  try:
    out = finish(pts)
    if out is not None:
      return out
  except AssertionError:
    raise
  except Exception:
    pass
  # decimate to support points along vmax fixed directions: every kept
  # vertex is an ORIGINAL surface point (cluster means would lie strictly
  # inside the hull — the shape silently shrinks and contacts fire late),
  # the 6 axis directions pin the AABB exactly, and the counts are bounded
  # by construction (nv <= vmax, facets <= 2*vmax-4 <= fmax).
  idx = np.unique(np.argmax(pts @ directions(vmax).T, axis=0))
  out = finish(pts[idx])
  if out is None:
    raise ValueError('hull decimation failed to fit budgets')
  return out


def hull_edge_dirs(vert: np.ndarray, vmask: np.ndarray,
                   emax: int = HULL_EMAX):
  """Unique edge directions of a padded hull, for SAT cross axes.

  Edge directions are deduplicated up to sign within ~3 degrees and ranked
  by multiplicity, so the budget keeps the structurally dominant directions
  (prism axes, ring edges) when the hull has more than emax.  Triangulation
  diagonals of coplanar facets may appear among the edges; as SAT axes they
  are merely redundant, never wrong (any axis separating two convex sets
  proves disjointness).  Returns (edge [emax, 3] unit rows, emask [emax]).
  """
  from scipy.spatial import ConvexHull
  pts = np.asarray(vert, np.float64)[np.asarray(vmask) > 0.5]
  edge = np.zeros((emax, 3), np.float32)
  emask_out = np.zeros(emax, np.float32)
  if pts.shape[0] < 4:
    return edge, emask_out
  try:
    hull = ConvexHull(pts)
  except Exception:
    return edge, emask_out
  pairs = set()
  for simplex in hull.simplices:
    for i in range(3):
      a, b = int(simplex[i]), int(simplex[(i + 1) % 3])
      pairs.add((min(a, b), max(a, b)))
  dirs = []
  for a, b in pairs:
    d = pts[b] - pts[a]
    n = np.linalg.norm(d)
    if n < 1e-9:
      continue
    d = d / n
    nz = np.nonzero(np.abs(d) > 1e-6)[0]
    if nz.size and d[nz[0]] < 0:
      d = -d
    dirs.append(d)
  clusters: list = []  # [direction, edge count]
  cos_tol = np.cos(np.radians(3.0))
  for d in dirs:
    for c in clusters:
      if abs(float(d @ c[0])) >= cos_tol:
        c[1] += 1
        break
    else:
      clusters.append([d, 1])
  clusters.sort(key=lambda c: -c[1])
  keep = np.stack([c[0] for c in clusters[:emax]])
  edge[:keep.shape[0]] = keep
  emask_out[:keep.shape[0]] = 1.0
  return edge, emask_out


def _quat_to_mat_np(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _mat_to_quat_np(m):
  tr = np.trace(m)
  if tr > 0:
    s = np.sqrt(tr + 1.0) * 2
    q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                  (m[1, 0] - m[0, 1]) / s])
  else:
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
  return q / np.linalg.norm(q)


# Distal Fetch links that can reach the task workspace and therefore get
# collision capsule proxies (fetch-gym.xml link geom names).  gripper_link
# is deliberately absent: its bounding capsule would fill the concave grasp
# cavity between the fingers and bump objects the real palm mesh clears
# (breaks the MuJoCo replay-parity gate); the finger boxes carry the grasp
# contacts exactly as in the reference.
_ARM_PROXY_LINKS = ('shoulder_lift', 'upperarm_roll', 'elbow_flex',
                    'forearm_roll', 'wrist_flex', 'wrist_roll')


def _fit_capsule_np(verts: np.ndarray):
  """Bounding capsule of a vertex cloud along its principal axis.

  Returns (pos, quat, radius, half_len) in the vertex frame: the segment
  lies on the principal component through the extent midpoint; the radius
  is the exact covering distance to that segment (conservative bound —
  every vertex is inside the capsule, slightly loose at the caps).
  """
  c = verts.mean(axis=0)
  cov = np.cov((verts - c).T)
  w, v = np.linalg.eigh(cov)
  u = v[:, -1]
  t = (verts - c) @ u
  t0, t1 = float(t.min()), float(t.max())
  mid = c + u * (0.5 * (t0 + t1))
  radial = (verts - mid) - np.outer((verts - mid) @ u, u)
  r0 = float(np.linalg.norm(radial, axis=1).max())
  hl = max(0.5 * (t1 - t0) - r0, 0.0)
  a, b = mid - hl * u, mid + hl * u
  ab = b - a
  tt = np.clip(((verts - a) @ ab) / max(float(ab @ ab), 1e-12), 0.0, 1.0)
  r = float(np.linalg.norm(verts - (a + tt[:, None] * ab), axis=1).max())
  e = np.eye(3)[int(np.argmin(np.abs(u)))]
  x = np.cross(e, u)
  x /= np.linalg.norm(x)
  y = np.cross(u, x)
  quat = _mat_to_quat_np(np.column_stack([x, y, u]))
  return mid, quat, r, hl


# ---------------------------------------------------------------- compiler


class _Builder:
  """Accumulates model arrays during worldbody traversal."""

  def __init__(self, assets: Assets, defaults: _Defaults):
    self.assets = assets
    self.defaults = defaults
    # bodies (body 0 = world)
    self.body_parentid = [0]
    self.body_mocapid = [-1]
    self.body_name = ['world']
    self.body_pos = [np.zeros(3)]
    self.body_quat = [np.array([1.0, 0, 0, 0])]
    self.body_inertial = [None]  # explicit (mass, ipos, iquat, diag) or None
    self.body_geoms: List[List[int]] = [[]]
    self.body_jnts: List[List[int]] = [[]]
    # joints
    self.jnt = {k: [] for k in (
        'type', 'bodyid', 'pos', 'axis', 'range', 'limited', 'stiffness',
        'ref', 'springref', 'armature', 'damping', 'solref', 'solimp', 'name')}
    # geoms
    self.geom = {k: [] for k in (
        'type', 'bodyid', 'pos', 'quat', 'size', 'rgba', 'contype',
        'conaffinity', 'condim', 'friction', 'solref', 'solimp', 'margin',
        'meshid', 'name', 'mass', 'density')}
    self.site = {k: [] for k in ('bodyid', 'pos', 'quat', 'size', 'rgba',
                                 'name')}
    self.cam = {k: [] for k in ('bodyid', 'pos', 'quat', 'fovy', 'name')}
    self.light = {k: [] for k in ('pos', 'dir', 'directional')}
    self.mocap_count = 0

  # -------------------------------------------------------------- elements

  def add_body(self, el: ET.Element, parent: int, childclass: str) -> int:
    bid = len(self.body_name)
    name = el.attrib.get('name', f'body{bid}')
    self.body_parentid.append(parent)
    self.body_name.append(name)
    self.body_pos.append(_parse_floats(el.attrib.get('pos', '0 0 0')))
    self.body_quat.append(_elem_quat(el))
    mocap = el.attrib.get('mocap', 'false') == 'true'
    if mocap:
      self.body_mocapid.append(self.mocap_count)
      self.mocap_count += 1
    else:
      self.body_mocapid.append(-1)
    self.body_inertial.append(None)
    self.body_geoms.append([])
    self.body_jnts.append([])
    return bid

  def add_inertial(self, el: ET.Element, bid: int):
    mass = float(el.attrib['mass'])
    ipos = _parse_floats(el.attrib.get('pos', '0 0 0'))
    iquat = _elem_quat(el)
    if 'diaginertia' in el.attrib:
      diag = _parse_floats(el.attrib['diaginertia'])
    elif 'fullinertia' in el.attrib:
      fi = _parse_floats(el.attrib['fullinertia'])
      m = np.array([[fi[0], fi[3], fi[4]], [fi[3], fi[1], fi[5]],
                    [fi[4], fi[5], fi[2]]])
      w, v = np.linalg.eigh(m)
      diag = w
      iquat = _mat_to_quat_np(v)
    else:
      diag = np.zeros(3)
    self.body_inertial[bid] = (mass, ipos, iquat, diag)

  def add_joint(self, el: ET.Element, bid: int, childclass: str):
    a = self.defaults.resolve(el, 'joint', childclass)
    jid = len(self.jnt['type'])
    jtype = _JOINT_TYPES[a.get('type', 'hinge')]
    self.jnt['type'].append(jtype)
    self.jnt['bodyid'].append(bid)
    self.jnt['pos'].append(_parse_floats(a.get('pos', '0 0 0')))
    axis = _parse_floats(a.get('axis', '0 0 1'))
    self.jnt['axis'].append(axis / max(np.linalg.norm(axis), 1e-12))
    limited = a.get('limited', 'true' if 'range' in a else 'false') == 'true'
    # mujoco: explicit limited="false" overrides presence of range
    self.jnt['limited'].append(limited and jtype in (SLIDE, HINGE))
    self.jnt['range'].append(_parse_floats(a.get('range', '0 0')))
    self.jnt['stiffness'].append(float(a.get('stiffness', '0')))
    ref = float(a.get('ref', '0'))
    self.jnt['ref'].append(ref)
    self.jnt['springref'].append(float(a.get('springref', '0')))
    self.jnt['armature'].append(float(a.get('armature', '0')))
    self.jnt['damping'].append(float(a.get('damping', '0')))
    self.jnt['solref'].append(_parse_floats(
        a.get('solreflimit', '%g %g' % _DEFAULT_SOLREF)))
    si = _parse_floats(a.get('solimplimit',
                             '%g %g %g' % _DEFAULT_SOLIMP[:3]))
    self.jnt['solimp'].append(np.resize(si, 3))
    self.jnt['name'].append(el.attrib.get('name', f'joint{jid}'))
    self.body_jnts[bid].append(jid)

  def add_geom(self, el: ET.Element, bid: int, childclass: str):
    a = self.defaults.resolve(el, 'geom', childclass)
    gid = len(self.geom['type'])
    gtype = _GEOM_TYPES[a.get('type', 'sphere')]
    pos = _parse_floats(a.get('pos', '0 0 0'))
    quat = _elem_quat_from_attrs(a)
    size = np.resize(_parse_floats(a.get('size', '0 0 0')), 3)
    meshid = -1
    if gtype == MESH:
      meshid = self.assets.mesh_ids[a['mesh']]
      mesh = self.assets.meshes[meshid]
      # bake AABB centering into geom pos; size <- AABB half extents
      pos = pos + _quat_to_mat_np(quat) @ mesh.center
      size = mesh.aabb_half.astype(np.float64)
    # color: explicit rgba > material > default gray
    if 'rgba' in a:
      rgba = np.resize(_parse_floats(a['rgba']), 4)
    elif 'material' in a and a['material'] in self.assets.materials:
      rgba = self.assets.materials[a['material']]
    else:
      rgba = np.array([0.5, 0.5, 0.5, 1.0])
    self.geom['type'].append(gtype)
    self.geom['bodyid'].append(bid)
    self.geom['pos'].append(pos)
    self.geom['quat'].append(quat)
    self.geom['size'].append(size)
    self.geom['rgba'].append(rgba)
    self.geom['contype'].append(int(a.get('contype', '1')))
    self.geom['conaffinity'].append(int(a.get('conaffinity', '1')))
    self.geom['condim'].append(int(a.get('condim', '3')))
    fr = np.resize(_parse_floats(a.get('friction',
                                       '%g %g %g' % _DEFAULT_FRICTION)), 3)
    self.geom['friction'].append(fr)
    self.geom['solref'].append(_parse_floats(
        a.get('solref', '%g %g' % _DEFAULT_SOLREF)))
    si = _parse_floats(a.get('solimp', '%g %g %g' % _DEFAULT_SOLIMP[:3]))
    self.geom['solimp'].append(np.resize(si, 3))
    self.geom['margin'].append(float(a.get('margin', '0')))
    self.geom['meshid'].append(meshid)
    self.geom['name'].append(el.attrib.get('name', f'geom{gid}'))
    self.assets.geom_material.append(a.get('material', ''))
    self.geom['mass'].append(float(a['mass']) if 'mass' in a else None)
    self.geom['density'].append(float(a.get('density', '1000')))
    self.body_geoms[bid].append(gid)

  def add_site(self, el: ET.Element, bid: int, childclass: str):
    a = self.defaults.resolve(el, 'site', childclass)
    sid = len(self.site['bodyid'])
    self.site['bodyid'].append(bid)
    self.site['pos'].append(_parse_floats(a.get('pos', '0 0 0')))
    self.site['quat'].append(_elem_quat_from_attrs(a))
    self.site['size'].append(np.resize(_parse_floats(a.get('size', '0.005')),
                                       3))
    self.site['rgba'].append(np.resize(
        _parse_floats(a.get('rgba', '0.5 0.5 0.5 1')), 4))
    self.site['name'].append(el.attrib.get('name', f'site{sid}'))

  def add_camera(self, el: ET.Element, bid: int):
    cid = len(self.cam['bodyid'])
    self.cam['bodyid'].append(bid)
    self.cam['pos'].append(_parse_floats(el.attrib.get('pos', '0 0 0')))
    self.cam['quat'].append(_elem_quat(el))
    self.cam['fovy'].append(float(el.attrib.get('fovy', '45')))
    self.cam['name'].append(el.attrib.get('name', f'cam{cid}'))

  def add_light(self, el: ET.Element, bid: int):
    self.light['pos'].append(_parse_floats(el.attrib.get('pos', '0 0 0')))
    d = _parse_floats(el.attrib.get('dir', '0 0 -1'))
    self.light['dir'].append(d / max(np.linalg.norm(d), 1e-12))
    self.light['directional'].append(
        el.attrib.get('directional', 'false') == 'true')

  # -------------------------------------------------------------- traversal

  def walk_body(self, el: ET.Element, bid: int, childclass: str):
    childclass = el.attrib.get('childclass', childclass)
    for child in el:
      if child.tag == 'body':
        sub = self.add_body(child, bid, childclass)
        self.walk_body(child, sub, childclass)
      elif child.tag == 'joint':
        self.add_joint(child, bid, childclass)
      elif child.tag == 'freejoint':
        fake = ET.Element('joint', {'type': 'free',
                                    **{k: v for k, v in child.attrib.items()}})
        self.add_joint(fake, bid, childclass)
      elif child.tag == 'geom':
        self.add_geom(child, bid, childclass)
      elif child.tag == 'site':
        self.add_site(child, bid, childclass)
      elif child.tag == 'camera':
        self.add_camera(child, bid)
      elif child.tag == 'light':
        self.add_light(child, bid)
      elif child.tag == 'inertial':
        self.add_inertial(child, bid)


def _elem_quat_from_attrs(a: Dict[str, str]) -> np.ndarray:
  el = ET.Element('x', {k: a[k] for k in ('quat', 'euler', 'axisangle')
                        if k in a})
  return _elem_quat(el)


def load_model(xml_path: str,
               arm_proxies: bool = True) -> Tuple[Model, Assets]:
  """Compile an MJCF file into (Model, Assets).

  arm_proxies: emit invisible bounding-capsule collision proxies for
    articulated robot-link meshes (MuJoCo collides those meshes directly;
    see the proxy block below).
  """
  root = _merge_mujoco_sections(_resolve_includes(xml_path))
  base = os.path.dirname(os.path.abspath(xml_path))

  compiler = root.find('compiler')
  meshdir = os.path.normpath(os.path.join(
      base, compiler.attrib.get('meshdir', '.'))) if compiler is not None \
      else base
  texdir = os.path.normpath(os.path.join(
      base, compiler.attrib.get('texturedir', '.'))) if compiler is not None \
      else base

  # --- option
  opt_el = root.find('option')
  timestep = float(opt_el.attrib.get('timestep', '0.002')) \
      if opt_el is not None else 0.002
  density = float(opt_el.attrib.get('density', '0')) \
      if opt_el is not None else 0.0
  viscosity = float(opt_el.attrib.get('viscosity', '0')) \
      if opt_el is not None else 0.0
  gravity = _parse_floats(opt_el.attrib['gravity']) \
      if opt_el is not None and 'gravity' in opt_el.attrib \
      else np.array([0.0, 0.0, -9.81])

  # --- assets
  assets = Assets()
  asset_el = root.find('asset')
  if asset_el is not None:
    for tex in asset_el.findall('texture'):
      name = tex.attrib.get('name', '')
      if 'file' in tex.attrib:
        path = os.path.join(texdir, tex.attrib['file'])
        assets.textures[name] = _texture_mean_rgb(path)
        assets.texture_images[name] = _texture_image(path)
      elif tex.attrib.get('builtin') == 'gradient':
        rgb1 = _parse_floats(tex.attrib.get('rgb1', '1 1 1'))
        rgb2 = _parse_floats(tex.attrib.get('rgb2', '0 0 0'))
        assets.textures[name] = 0.5 * (rgb1 + rgb2)
    for mat in asset_el.findall('material'):
      name = mat.attrib['name']
      if 'rgba' in mat.attrib:
        rgba = np.resize(_parse_floats(mat.attrib['rgba']), 4)
      elif 'texture' in mat.attrib and mat.attrib['texture'] in assets.textures:
        rgba = np.concatenate([assets.textures[mat.attrib['texture']], [1.0]])
      else:
        rgba = np.array([0.7, 0.7, 0.7, 1.0])
      assets.materials[name] = rgba
      if 'texture' in mat.attrib and \
          mat.attrib['texture'] in assets.texture_images:
        rep = np.resize(_parse_floats(mat.attrib.get('texrepeat', '1 1')), 2)
        assets.material_texture[name] = (mat.attrib['texture'],
                                         float(rep[0]), float(rep[1]))
    for mesh in asset_el.findall('mesh'):
      name = mesh.attrib.get('name',
                             os.path.basename(mesh.attrib['file']).split('.')[0])
      vert, face = load_stl(os.path.join(meshdir, mesh.attrib['file']))
      scale = np.resize(_parse_floats(mesh.attrib.get('scale', '1 1 1')), 3)
      vert = vert * scale.astype(np.float32)
      lo, hi = vert.min(axis=0), vert.max(axis=0)
      center = 0.5 * (lo + hi)
      assets.mesh_ids[name] = len(assets.meshes)
      assets.meshes.append(MeshAsset(
          name=name, vert=vert - center, face=face,
          aabb_half=0.5 * (hi - lo), center=center))

  # --- defaults
  defaults = _Defaults()
  defaults.load(root.find('default'))

  # --- worldbody
  builder = _Builder(assets, defaults)
  world_el = root.find('worldbody')
  builder.walk_body(world_el, 0, '')

  nbody = len(builder.body_name)
  njnt = len(builder.jnt['type'])
  ngeom = len(builder.geom['type'])

  # --- qpos / dof layout
  jnt_qposadr, jnt_dofadr = [], []
  nq = nv = 0
  for jtype in builder.jnt['type']:
    jnt_qposadr.append(nq)
    jnt_dofadr.append(nv)
    nq += JOINT_QPOS_DIM[jtype]
    nv += JOINT_DOF_DIM[jtype]
  dof_jntid, dof_armature, dof_damping = [], [], []
  for j, jtype in enumerate(builder.jnt['type']):
    for _ in range(JOINT_DOF_DIM[jtype]):
      dof_jntid.append(j)
      dof_armature.append(builder.jnt['armature'][j])
      dof_damping.append(builder.jnt['damping'][j])

  # --- qpos0: free joints start at compiled body pose; scalar joints at ref
  qpos0 = np.zeros(nq)
  for j, jtype in enumerate(builder.jnt['type']):
    adr = jnt_qposadr[j]
    bid = builder.jnt['bodyid'][j]
    if jtype == FREE:
      if builder.body_parentid[bid] != 0:
        raise NotImplementedError('free joints must attach to world children')
      qpos0[adr:adr + 3] = builder.body_pos[bid]
      qpos0[adr + 3:adr + 7] = builder.body_quat[bid]
      # body_pos is absorbed into qpos for free bodies
      builder.body_pos[bid] = np.zeros(3)
      builder.body_quat[bid] = np.array([1.0, 0, 0, 0])
    elif jtype == BALL:
      qpos0[adr:adr + 4] = np.array([1.0, 0, 0, 0])
    else:
      qpos0[adr] = builder.jnt['ref'][j]

  # --- body mass/inertia: explicit inertial or geom-derived
  body_mass = np.zeros(nbody)
  body_ipos = np.zeros((nbody, 3))
  body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
  body_inertia = np.zeros((nbody, 3))
  for b in range(nbody):
    if builder.body_inertial[b] is not None:
      m, ipos, iquat, diag = builder.body_inertial[b]
      body_mass[b] = m
      body_ipos[b] = ipos
      body_iquat[b] = iquat
      body_inertia[b] = diag
    elif builder.body_geoms[b]:
      # accumulate in body frame
      total_m = 0.0
      com = np.zeros(3)
      parts = []
      for g in builder.body_geoms[b]:
        gtype = builder.geom['type'][g]
        mesh = assets.meshes[builder.geom['meshid'][g]] \
            if builder.geom['meshid'][g] >= 0 else None
        m, diag = _geom_mass_inertia(gtype, builder.geom['size'][g],
                                     builder.geom['mass'][g],
                                     builder.geom['density'][g], mesh)
        parts.append((m, diag, builder.geom['pos'][g],
                      builder.geom['quat'][g]))
        total_m += m
        com += m * builder.geom['pos'][g]
      if total_m > 0:
        com /= total_m
        inertia = np.zeros((3, 3))
        for m, diag, gpos, gquat in parts:
          rot = _quat_to_mat_np(gquat)
          i3 = rot @ np.diag(diag) @ rot.T
          d = gpos - com
          i3 += m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
          inertia += i3
        w, v = np.linalg.eigh(inertia)
        if np.linalg.det(v) < 0:
          v[:, 0] = -v[:, 0]
        body_mass[b] = total_m
        body_ipos[b] = com
        body_iquat[b] = _mat_to_quat_np(v)
        body_inertia[b] = np.maximum(w, 1e-9)

  # minimum inertia floor for dynamic bodies (numerical safety)
  for b in range(nbody):
    if builder.body_jnts[b] and body_mass[b] > 0:
      body_inertia[b] = np.maximum(body_inertia[b], 1e-6)

  # --- equality welds
  eq_body1, eq_body2, eq_solref, eq_solimp = [], [], [], []
  eq_el = root.find('equality')
  if eq_el is not None:
    for weld in eq_el.findall('weld'):
      eq_body1.append(builder.body_name.index(weld.attrib['body1']))
      eq_body2.append(builder.body_name.index(weld.attrib['body2']))
      eq_solref.append(_parse_floats(weld.attrib.get(
          'solref', '%g %g' % _DEFAULT_SOLREF)))
      si = _parse_floats(weld.attrib.get('solimp',
                                         '%g %g %g' % _DEFAULT_SOLIMP[:3]))
      eq_solimp.append(np.resize(si, 3))

  # --- contact excludes
  excludes = set()
  contact_el = root.find('contact')
  if contact_el is not None:
    for ex in contact_el.findall('exclude'):
      b1 = builder.body_name.index(ex.attrib['body1'])
      b2 = builder.body_name.index(ex.attrib['body2'])
      excludes.add((min(b1, b2), max(b1, b2)))

  # --- actuators
  act_jntid, act_kp, act_ctrlrange, act_name = [], [], [], []
  act_el = root.find('actuator')
  if act_el is not None:
    for pos_act in act_el.findall('position'):
      a = defaults.resolve(pos_act, 'position', '')
      act_jntid.append(builder.jnt['name'].index(a['joint']))
      act_kp.append(float(a.get('kp', '1')))
      act_ctrlrange.append(_parse_floats(a.get('ctrlrange', '0 0')))
      act_name.append(pos_act.attrib.get('name', a['joint']))

  # --- weld groups for collision filtering
  body_weldid = [0] * nbody
  for b in range(1, nbody):
    body_weldid[b] = b if builder.body_jnts[b] else \
        body_weldid[builder.body_parentid[b]]
  # weld-parent: parent body of the weld root
  weld_parentid = [body_weldid[builder.body_parentid[body_weldid[b]]]
                   for b in range(nbody)]

  # --- arm-link collision capsule proxies
  # Articulated mesh geoms (Fetch torso/arm links) skip hull narrowphase in
  # the hot path (`collidable` below), but MuJoCo collides them: the robot
  # geoms in assets_gym/robots/fetch-gym.xml carry the default
  # contype/conaffinity of 1 (reference src/geeco_gym scene stack).  Parity
  # is preserved with an auto-fitted bounding capsule per distal arm link:
  # an invisible (alpha 0 — the renderer skips it) capsule geom on the same
  # body that inherits the link's contact parameters, so the arm presses on
  # the table and objects instead of ghosting through them.  Proximal
  # structure (base/torso/head/estop/laser) is left contact-free: those
  # links never enter the task workspace, and their loose capsule bounds
  # would fabricate rest contacts (e.g. the base hull's bounding sphere
  # penetrates the floor the real mesh merely touches).
  proxy_gids = set()
  if arm_proxies:
    for g in range(ngeom):
      if builder.geom['type'][g] != MESH:
        continue
      if builder.geom['contype'][g] == 0 and \
         builder.geom['conaffinity'][g] == 0:
        continue
      if not any(s in builder.geom['name'][g] for s in _ARM_PROXY_LINKS):
        continue
      bid = builder.geom['bodyid'][g]
      wid = body_weldid[bid]
      if wid == 0:
        continue  # welded to world: can never move into contact
      if builder.jnt['type'][builder.body_jnts[wid][0]] == FREE:
        continue  # free-floating task object: collides via its convex hull
      mesh = assets.meshes[builder.geom['meshid'][g]]
      cpos, cquat, rad, hl = _fit_capsule_np(mesh.vert - mesh.center)
      gr = _quat_to_mat_np(builder.geom['quat'][g])
      builder.geom['type'].append(CAPSULE)
      builder.geom['bodyid'].append(bid)
      builder.geom['pos'].append(builder.geom['pos'][g] + gr @ cpos)
      builder.geom['quat'].append(_mat_to_quat_np(gr @ _quat_to_mat_np(cquat)))
      builder.geom['size'].append(np.array([rad, hl, 0.0]))
      builder.geom['rgba'].append(np.zeros(4))
      for k in ('contype', 'conaffinity', 'condim', 'friction', 'solref',
                'solimp', 'margin'):
        builder.geom[k].append(builder.geom[k][g])
      builder.geom['meshid'].append(-1)
      builder.geom['name'].append(builder.geom['name'][g] + '__colcap')
      builder.geom['mass'].append(0.0)
      builder.geom['density'].append(0.0)
      assets.geom_material.append('')
      builder.body_geoms[bid].append(len(builder.geom['type']) - 1)
      proxy_gids.add(len(builder.geom['type']) - 1)
    ngeom = len(builder.geom['type'])

  # --- collision pair enumeration (static broadphase)
  def collidable(g):
    if builder.geom['contype'][g] == 0 and builder.geom['conaffinity'][g] == 0:
      return False
    gtype = builder.geom['type'][g]
    if gtype == MESH:
      bid = builder.geom['bodyid'][g]
      jnts = builder.body_jnts[bid]
      # round-1 policy: articulated meshes (arm links) don't collide
      return bool(jnts) and builder.jnt['type'][jnts[0]] == FREE
    return True

  pair_groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
  for g1 in range(ngeom):
    for g2 in range(g1 + 1, ngeom):
      if not (collidable(g1) and collidable(g2)):
        continue
      b1, b2 = builder.geom['bodyid'][g1], builder.geom['bodyid'][g2]
      w1, w2 = body_weldid[b1], body_weldid[b2]
      if w1 == w2:
        continue
      # proxy capsules are loose bounds: they collide with the world and
      # free objects only, never within the robot chain (the bounds overlap
      # at rest where the real link meshes do not, so robot self-pairs
      # would inject spurious forces)
      def _articulated(b):
        wid = body_weldid[b]
        return wid != 0 and \
            builder.jnt['type'][builder.body_jnts[wid][0]] != FREE
      if (g1 in proxy_gids and _articulated(b2)) or \
         (g2 in proxy_gids and _articulated(b1)):
        continue
      if (min(b1, b2), max(b1, b2)) in excludes:
        continue
      if (min(w1, w2), max(w1, w2)) in excludes:
        continue
      # parent-child weld filter (mujoco default; world-parented pairs are
      # exempt so free bodies still collide with world geoms)
      if (weld_parentid[b1] == w2 and w2 != 0) or \
         (weld_parentid[b2] == w1 and w1 != 0):
        continue
      ct1, ca1 = builder.geom['contype'][g1], builder.geom['conaffinity'][g1]
      ct2, ca2 = builder.geom['contype'][g2], builder.geom['conaffinity'][g2]
      if not ((ct1 & ca2) or (ct2 & ca1)):
        continue
      t1c = builder.geom['type'][g1]
      t2c = builder.geom['type'][g2]
      if t1c == PLANE and t2c == PLANE:
        continue
      if w1 == 0 and w2 == 0:
        continue  # both static
      # order pair by type code
      if t1c <= t2c:
        key, pair = (t1c, t2c), (g1, g2)
      else:
        key, pair = (t2c, t1c), (g2, g1)
      pair_groups.setdefault(key, []).append(pair)

  col_pairs = tuple(sorted(
      (key, tuple(pairs)) for key, pairs in pair_groups.items()))

  # --- convex hulls (one per mesh asset; geom_hullid == geom meshid)
  hull_vert, hull_vmask, hull_face, hull_fmask = [], [], [], []
  hull_edge, hull_emask = [], []
  for mesh in builder.assets.meshes:
    hv, hvm, hf, hfm = build_hull(mesh.vert)
    he, hem = hull_edge_dirs(hv, hvm)
    hull_vert.append(hv)
    hull_vmask.append(hvm)
    hull_face.append(hf)
    hull_fmask.append(hfm)
    hull_edge.append(he)
    hull_emask.append(hem)

  def f32(x):
    return torch.as_tensor(np.asarray(x, np.float64).astype(np.float32))

  model = Model(
      opt=Option(
          timestep=f32(timestep), gravity=f32(gravity), density=f32(density),
          viscosity=f32(viscosity)),
      nq=nq, nv=nv, nu=len(act_jntid), nbody=nbody, njnt=njnt, ngeom=ngeom,
      nsite=len(builder.site['bodyid']), nmocap=builder.mocap_count,
      ncam=len(builder.cam['bodyid']), nlight=len(builder.light['pos']),
      neq=len(eq_body1),
      body_parentid=tuple(builder.body_parentid),
      body_mocapid=tuple(builder.body_mocapid),
      body_jntadr=tuple(tuple(j) for j in builder.body_jnts),
      body_name=tuple(builder.body_name),
      body_pos=f32(np.stack(builder.body_pos)),
      body_quat=f32(np.stack(builder.body_quat)),
      body_mass=f32(body_mass),
      body_inertia=f32(body_inertia),
      body_ipos=f32(body_ipos),
      body_iquat=f32(body_iquat),
      jnt_type=tuple(builder.jnt['type']),
      jnt_bodyid=tuple(builder.jnt['bodyid']),
      jnt_qposadr=tuple(jnt_qposadr),
      jnt_dofadr=tuple(jnt_dofadr),
      jnt_limited=tuple(builder.jnt['limited']),
      jnt_name=tuple(builder.jnt['name']),
      jnt_pos=f32(np.stack(builder.jnt['pos']) if njnt else np.zeros((0, 3))),
      jnt_axis=f32(np.stack(builder.jnt['axis']) if njnt else np.zeros((0, 3))),
      jnt_range=f32(np.stack(builder.jnt['range']) if njnt
                    else np.zeros((0, 2))),
      jnt_stiffness=f32(builder.jnt['stiffness']),
      jnt_ref=f32(builder.jnt['ref']),
      jnt_springref=f32(builder.jnt['springref']),
      jnt_solref=f32(np.stack(builder.jnt['solref']) if njnt
                     else np.zeros((0, 2))),
      jnt_solimp=f32(np.stack(builder.jnt['solimp']) if njnt
                     else np.zeros((0, 3))),
      dof_jntid=tuple(dof_jntid),
      dof_armature=f32(dof_armature),
      dof_damping=f32(dof_damping),
      geom_type=tuple(builder.geom['type']),
      geom_bodyid=tuple(builder.geom['bodyid']),
      geom_contype=tuple(builder.geom['contype']),
      geom_conaffinity=tuple(builder.geom['conaffinity']),
      geom_condim=tuple(builder.geom['condim']),
      geom_meshid=tuple(builder.geom['meshid']),
      geom_name=tuple(builder.geom['name']),
      geom_pos=f32(np.stack(builder.geom['pos']) if ngeom
                   else np.zeros((0, 3))),
      geom_quat=f32(np.stack(builder.geom['quat']) if ngeom
                    else np.zeros((0, 4))),
      geom_size=f32(np.stack(builder.geom['size']) if ngeom
                    else np.zeros((0, 3))),
      geom_rgba=f32(np.stack(builder.geom['rgba']) if ngeom
                    else np.zeros((0, 4))),
      geom_friction=f32(np.stack(builder.geom['friction']) if ngeom
                        else np.zeros((0, 3))),
      geom_solref=f32(np.stack(builder.geom['solref']) if ngeom
                      else np.zeros((0, 2))),
      geom_solimp=f32(np.stack(builder.geom['solimp']) if ngeom
                      else np.zeros((0, 3))),
      geom_margin=f32(builder.geom['margin']),
      site_bodyid=tuple(builder.site['bodyid']),
      site_name=tuple(builder.site['name']),
      site_pos=f32(np.stack(builder.site['pos'])
                   if builder.site['bodyid'] else np.zeros((0, 3))),
      site_quat=f32(np.stack(builder.site['quat'])
                    if builder.site['bodyid'] else np.zeros((0, 4))),
      site_size=f32(np.stack(builder.site['size'])
                    if builder.site['bodyid'] else np.zeros((0, 3))),
      site_rgba=f32(np.stack(builder.site['rgba'])
                    if builder.site['bodyid'] else np.zeros((0, 4))),
      cam_bodyid=tuple(builder.cam['bodyid']),
      cam_name=tuple(builder.cam['name']),
      cam_pos=f32(np.stack(builder.cam['pos'])
                  if builder.cam['bodyid'] else np.zeros((0, 3))),
      cam_quat=f32(np.stack(builder.cam['quat'])
                   if builder.cam['bodyid'] else np.zeros((0, 4))),
      cam_fovy=f32(builder.cam['fovy']),
      light_pos=f32(np.stack(builder.light['pos'])
                    if builder.light['pos'] else np.zeros((0, 3))),
      light_dir=f32(np.stack(builder.light['dir'])
                    if builder.light['dir'] else np.zeros((0, 3))),
      light_directional=tuple(builder.light['directional']),
      actuator_jntid=tuple(act_jntid),
      actuator_name=tuple(act_name),
      actuator_kp=f32(act_kp),
      actuator_ctrlrange=f32(np.stack(act_ctrlrange) if act_jntid
                             else np.zeros((0, 2))),
      eq_body1=tuple(eq_body1),
      eq_body2=tuple(eq_body2),
      eq_solref=f32(np.stack(eq_solref) if eq_body1 else np.zeros((0, 2))),
      eq_solimp=f32(np.stack(eq_solimp) if eq_body1 else np.zeros((0, 3))),
      col_pairs=col_pairs,
      geom_hullid=tuple(builder.geom['meshid']),
      hull_vert=f32(np.stack(hull_vert) if hull_vert
                    else np.zeros((0, HULL_VMAX, 3))),
      hull_vmask=f32(np.stack(hull_vmask) if hull_vert
                     else np.zeros((0, HULL_VMAX))),
      hull_face=f32(np.stack(hull_face) if hull_vert
                    else np.zeros((0, HULL_FMAX, 4))),
      hull_fmask=f32(np.stack(hull_fmask) if hull_vert
                     else np.zeros((0, HULL_FMAX))),
      hull_edge=f32(np.stack(hull_edge) if hull_vert
                    else np.zeros((0, HULL_EMAX, 3))),
      hull_emask=f32(np.stack(hull_emask) if hull_vert
                     else np.zeros((0, HULL_EMAX))),
      qpos0=f32(qpos0),
  )
  return model, assets
