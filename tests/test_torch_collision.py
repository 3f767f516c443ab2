"""Port parity (collision): every pair kernel of geeco_tpu_torch against the
JAX package's vmapped kernel, and ``collide`` on the clutter and mesh
scenes, on the CPU.

Inputs are made with numpy from fixed seeds: random poses around each
other that give separated, touching and penetrating pairs (each case
asserts it saw both signs).  The hull kernels take the padded hulls of the
nut-cone and ball-cup models.  ``collide`` runs on states of clutter4,
clutter12, nut-cone and ball-cup settled by the JAX stepper.
"""

import os

from tests.conftest import REPO_ROOT, reference_xml
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core import mjcf as jmjcf
from geeco_tpu.core.model import make_state as jmake_state
from geeco_tpu.core.model import set_joint_qpos as jset
from geeco_tpu.physics import collision as JC
from geeco_tpu.physics import kinematics as JK
from geeco_tpu.physics.step import build_stepper as jbuild
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.physics import collision as TC
from geeco_tpu_torch.physics import kinematics as TK

torch.set_num_threads(1)

PLANE, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX, MESH = 0, 2, 3, 4, 5, 6, 7
# float32 kernels, the same formulas with sums in another order
ATOL = 1e-5
# deactivated rows sit at d = 1e9 (a hull manifold past its deepest vertices)
# with their points ~5e8 from the pair: every value also has this rtol
BIG_RTOL = 1e-6
# the rows of a pair separated by more than FAR are held to their dist at
# FAR_RTOL, and their points and normals only to being finite: such rows
# never act (a row acts below 0), and their geometry is ill-conditioned:
# the axis and closest point of two far, nearly parallel edges move by up
# to 4e-4 (normal), 9e-5 of the dist and 0.14 m (point) with the rounding
# (measured on the settled scenes), and a far hull manifold may take
# another vertex of equal depth
FAR, FAR_RTOL = 0.05, 1e-4
P = 48   # pairs per case

PRIMITIVE_PAIRS = [
    (PLANE, SPHERE), (PLANE, CAPSULE), (PLANE, ELLIPSOID), (PLANE, CYLINDER),
    (PLANE, BOX), (SPHERE, SPHERE), (SPHERE, CAPSULE), (SPHERE, ELLIPSOID),
    (SPHERE, CYLINDER), (SPHERE, BOX), (ELLIPSOID, ELLIPSOID),
    (ELLIPSOID, CAPSULE), (ELLIPSOID, BOX), (CAPSULE, CAPSULE),
    (CAPSULE, ELLIPSOID), (CAPSULE, CYLINDER), (CAPSULE, BOX),
    (CYLINDER, BOX), (CYLINDER, CYLINDER), (CYLINDER, ELLIPSOID),
    (BOX, BOX)]


def _quats(rng, n, max_angle=np.pi):
  axis = rng.normal(size=(n, 3))
  axis /= np.linalg.norm(axis, axis=1, keepdims=True)
  ang = rng.uniform(-max_angle, max_angle, n)
  return np.concatenate([np.cos(ang / 2)[:, None],
                         np.sin(ang / 2)[:, None] * axis], 1).astype(
                             np.float32)


def _sizes(rng, t, n):
  if t == PLANE:
    return np.tile([1.0, 1.0, 0.01], (n, 1)).astype(np.float32)
  if t == SPHERE:
    return np.stack([rng.uniform(0.02, 0.06, n), np.zeros(n), np.zeros(n)],
                    1).astype(np.float32)
  if t in (CAPSULE, CYLINDER):
    return np.stack([rng.uniform(0.01, 0.04, n), rng.uniform(0.02, 0.08, n),
                     np.zeros(n)], 1).astype(np.float32)
  return rng.uniform(0.015, 0.06, (n, 3)).astype(np.float32)


def _radius(t, s):
  """Bounding radius of each geom of type t (sizes [n, 3])."""
  if t == SPHERE:
    return s[:, 0]
  if t in (CAPSULE, CYLINDER):
    return s[:, 0] + s[:, 1]
  return np.linalg.norm(s, axis=1) if t == BOX else s.max(1)


def _poses(rng, t1, n, reach):
  """Geom 2 at a random offset from geom 1 (a tilted plane's point); the
  offset is up to 1.3 x ``reach`` (a scalar or one per pair)."""
  reach = np.broadcast_to(np.asarray(reach, np.float64), (n,))[:, None]
  p1 = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
  if t1 == PLANE:
    q1 = _quats(rng, n, np.pi / 6)
    up = np.stack([2 * (q1[:, 1] * q1[:, 3] + q1[:, 0] * q1[:, 2]),
                   2 * (q1[:, 2] * q1[:, 3] - q1[:, 0] * q1[:, 1]),
                   1 - 2 * (q1[:, 1] ** 2 + q1[:, 2] ** 2)], 1)
    lateral = rng.uniform(-0.2, 0.2, (n, 3))
    p2 = p1 + lateral - (lateral * up).sum(1, keepdims=True) * up + \
        up * rng.uniform(-0.5, 1.0, (n, 1)) * reach
  else:
    q1 = _quats(rng, n)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p2 = p1 + d * rng.uniform(0.4, 1.3, (n, 1)) * reach
  return p1, q1, p2.astype(np.float32), _quats(rng, n)


def _port(*arrays):
  """numpy [P, ...] -> torch; poses gain the env axis of 1."""
  return [torch.as_tensor(a) for a in arrays]


def _match_rows(got, ref):
  """Reorder each pair's rows of ``got`` onto ``ref``'s.

  A manifold's candidate points at equal depth (the corners of a face, a
  hull's coplanar vertices) tie in exact arithmetic; float rounding breaks
  the tie, so the two engines may list them in another order (ROADMAP,
  "box-box manifold slot order").  The rows are matched one to one by
  nearest (pos, normal, dist) before the comparison, which still holds
  every matched row to the tolerances.
  """
  from scipy.optimize import linear_sum_assignment
  pos, n, d = got
  out = [x.copy() for x in got]
  for i in range(d.shape[0]):
    if d.shape[1] < 2:
      break
    scale = np.maximum(np.abs(ref[2][i]), 1.0)[None, :]
    cost = (np.abs(pos[i][:, None] - ref[0][i][None]).sum(-1) / scale +
            np.abs(n[i][:, None] - ref[1][i][None]).sum(-1) +
            np.abs(d[i][:, None] - ref[2][i][None]) / scale)
    rows, cols = linear_sum_assignment(cost)
    for k in range(3):
      out[k][i][cols] = got[k][i][rows]
  return out


def _close(got, ref):
  got, ref = [np.asarray(x) for x in got], [np.asarray(x) for x in ref]
  for name, g, r in zip(('pos', 'normal', 'dist'), got, ref):
    assert g.shape == r.shape, (name, g.shape, r.shape)
  got = _match_rows(got, ref)
  # rows of pairs whose every row lies beyond FAR: finite only (see FAR)
  far = np.broadcast_to(ref[2].min(-1, keepdims=True) > FAR, ref[2].shape)
  near, dead = ~far & (ref[2] < 1e8), ~far & (ref[2] >= 1e8)
  np.testing.assert_allclose(got[0][near], ref[0][near], atol=ATOL,
                             rtol=BIG_RTOL, err_msg='pos')
  assert np.isfinite(got[0][far]).all() and np.isfinite(got[1]).all()
  # a row at 1e9 sits half that far along its normal: BIG_RTOL of its dist
  err = np.abs(got[0][dead] - ref[0][dead]).max(-1, initial=0.0)
  assert (err <= BIG_RTOL * ref[2][dead] + ATOL).all(), \
      f'pos (rows at 1e9): {err.max(initial=0.0)}'
  np.testing.assert_allclose(got[1][~far], ref[1][~far], atol=ATOL,
                             err_msg='normal')
  np.testing.assert_allclose(got[2][~far], ref[2][~far], atol=ATOL,
                             rtol=BIG_RTOL, err_msg='dist')
  np.testing.assert_allclose(got[2][far], ref[2][far], atol=ATOL,
                             rtol=FAR_RTOL, err_msg='dist (far pairs)')


def _signs(d):
  d = np.asarray(d)
  return bool((d < 0).any()) and bool(((d > 0) & (d < 1e8)).any())


@pytest.mark.parametrize('t1,t2', PRIMITIVE_PAIRS)
def test_primitive_kernel_matches(t1, t2):
  """The kernel of ``_kernel(t1, t2)`` and, where an ellipsoid takes part,
  the support-radius fix ``collide`` applies after it."""
  rng = np.random.RandomState(100 * t1 + t2)
  s1, s2 = _sizes(rng, t1, P), _sizes(rng, t2, P)
  # a plane's reach is the height over it; else the two bounding radii
  reach = 0.06 if t1 == PLANE else _radius(t1, s1) + _radius(t2, s2)
  p1, q1, p2, q2 = _poses(rng, t1, P, reach)
  jk = jax.jit(jax.vmap(JC._kernel(t1, t2)))
  ref = jk(*map(jnp.asarray, (p1, q1, s1, p2, q2, s2)))
  tp1, tq1, ts1, tp2, tq2, ts2 = _port(p1, q1, s1, p2, q2, s2)
  got = TC._kernel(t1, t2)(tp1[None], tq1[None], ts1, tp2[None], tq2[None],
                           ts2)
  got = [g[0] for g in got]
  _close(got, ref)
  assert _signs(ref[2]), 'the poses must give separated and touching pairs'
  if ELLIPSOID in (t1, t2) and t1 != PLANE:
    d_ref, d_got = ref[2], got[2][None]
    for t, q, s in ((t1, q1, s1), (t2, q2, s2)):
      if t == ELLIPSOID:
        d_ref = jax.vmap(JC._ellipsoid_support_fix)(
            jnp.asarray(q), jnp.asarray(s), ref[1], d_ref)
        d_got = TC._ellipsoid_support_fix(torch.as_tensor(q)[None],
                                          torch.as_tensor(s), got[1][None],
                                          d_got)
    np.testing.assert_allclose(d_got[0].numpy(), np.asarray(d_ref),
                               atol=ATOL)


# ---------------------------------------------------------------- hulls


@pytest.fixture(scope='module', params=['nut-cone', 'ball-cup'])
def hulls(request):
  jm, _ = jmjcf.load_model(reference_xml(f'geeco-{request.param}.xml'))
  arrays = tuple(np.asarray(getattr(jm, f)) for f in TC._HULL_FIELDS)
  # the hulls of the scene's mesh-mesh pairs (both sides)
  mm = dict(jm.col_pairs)[(MESH, MESH)]
  h1 = np.asarray([jm.geom_hullid[a] for a, _ in mm])
  h2 = np.asarray([jm.geom_hullid[b] for _, b in mm])
  radius = np.linalg.norm(arrays[0], axis=-1).max(-1)     # per hull
  return request.param, arrays, h1, h2, radius


def _hull_case(hulls, seed, n=P):
  _, arrays, h1, h2, radius = hulls
  rng = np.random.RandomState(seed)
  pick = rng.randint(0, len(h1), n)
  return rng, arrays, h1[pick], h2[pick], radius


@pytest.mark.parametrize('kind', ['plane', 'sphere', 'ellipsoid', 'capsule',
                                  'box', 'hull'])
def test_hull_kernel_matches(hulls, kind):
  rng, arrays, hid1, hid2, radius = _hull_case(hulls, 7)
  hv2, hvm2, hf2, hfm2, he2, hem2 = (a[hid2] for a in arrays)
  reach = radius[hid2] + (radius[hid1] if kind == 'hull' else 0.04)
  t1 = {'plane': PLANE, 'sphere': SPHERE, 'ellipsoid': ELLIPSOID,
        'capsule': CAPSULE, 'box': BOX, 'hull': MESH}[kind]
  p1, q1, p2, q2 = _poses(rng, t1, P, 1.0)
  off = p2 - p1
  p2 = (p1 + off * reach[:, None].astype(np.float32)).astype(np.float32)
  s1 = _sizes(rng, t1, P)
  J = lambda *a: [jnp.asarray(x) for x in a]
  T = lambda *a: [torch.as_tensor(x) for x in a]
  B = lambda x: torch.as_tensor(x)[None]
  if kind == 'plane':
    ref = jax.jit(jax.vmap(JC.plane_hull))(*J(p1, q1, s1, p2, q2, hv2, hvm2))
    got = TC.plane_hull(B(p1), B(q1), *T(s1), B(p2), B(q2), *T(hv2, hvm2))
  elif kind in ('sphere', 'ellipsoid'):
    ref = jax.jit(jax.vmap(lambda *a: JC.sphere_hull(*a, t1=t1)))(
        *J(p1, q1, s1, p2, q2, hf2, hfm2))
    got = TC.sphere_hull(B(p1), B(q1), *T(s1), B(p2), B(q2), *T(hf2, hfm2),
                         t1=t1)
  elif kind == 'capsule':
    ref = jax.jit(jax.vmap(JC.capsule_hull))(
        *J(p1, q1, s1, p2, q2, hf2, hfm2))
    got = TC.capsule_hull(B(p1), B(q1), *T(s1), B(p2), B(q2), *T(hf2, hfm2))
  elif kind == 'box':
    ref = jax.jit(jax.vmap(JC.box_hull))(
        *J(p1, q1, s1, p2, q2, hv2, hvm2, hf2, hfm2, he2, hem2))
    got = TC.box_hull(B(p1), B(q1), *T(s1), B(p2), B(q2),
                      *T(hv2, hvm2, hf2, hfm2, he2, hem2))
  else:
    hull1 = [a[hid1] for a in arrays]
    ref = jax.jit(jax.vmap(JC.hull_hull))(
        *J(p1, q1, *hull1, p2, q2, hv2, hvm2, hf2, hfm2, he2, hem2))
    got = TC.hull_hull(B(p1), B(q1), *T(*hull1), B(p2), B(q2),
                       *T(hv2, hvm2, hf2, hfm2, he2, hem2))
  _close([g[0] for g in got], ref)
  assert _signs(ref[2]), 'the poses must give separated and touching pairs'


def _beam_hull(half):
  verts = np.array([[sx * half[0], sy * half[1], sz * half[2]]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                   np.float32)
  hv, hvm, hf, hfm = jmjcf.build_hull(verts)
  he, hem = jmjcf.hull_edge_dirs(hv, hvm)
  return hv, hvm, hf, hfm, he, hem


def test_hull_hull_edge_edge_branch():
  """Square beams rolled 45 degrees about their long axes, crossing ridge
  over ridge at several overlaps and yaws: an edge-edge axis wins, so one
  live row and five rows at 1e9 (as ``tests/test_hull.py`` sets it up)."""
  n = 8
  rng = np.random.RandomState(3)
  a, b = np.radians(45.0) / 2, rng.uniform(-0.2, 0.2, n) / 2
  q1 = np.tile([np.cos(a), np.sin(a), 0.0, 0.0], (n, 1)).astype(np.float32)
  # roll about y, then a small yaw about z
  q2 = np.stack([np.cos(a) * np.cos(b), -np.sin(a) * np.sin(b),
                 np.sin(a) * np.cos(b), np.cos(a) * np.sin(b)], 1
                ).astype(np.float32)
  h1 = _beam_hull(np.array([0.5, 0.05, 0.05]))
  h2 = _beam_hull(np.array([0.05, 0.5, 0.05]))
  ridge = 0.05 * np.sqrt(2.0)
  p1 = np.zeros((n, 3), np.float32)
  p2 = np.zeros((n, 3), np.float32)
  p2[:, 2] = 2 * ridge - rng.uniform(0.005, 0.03, n)
  p2[:, :2] = rng.uniform(-0.05, 0.05, (n, 2))
  tile = lambda h: [np.repeat(x[None], n, 0) for x in h]
  ref = jax.jit(jax.vmap(JC.hull_hull))(
      *map(jnp.asarray, [p1, q1, *tile(h1), p2, q2, *tile(h2)]))
  d = np.asarray(ref[2])
  assert (d[:, 0] < 0).all() and (d[:, 1:] == 1e9).all()
  got = TC.hull_hull(torch.as_tensor(p1)[None], torch.as_tensor(q1)[None],
                     *map(torch.as_tensor, tile(h1)),
                     torch.as_tensor(p2)[None], torch.as_tensor(q2)[None],
                     *map(torch.as_tensor, tile(h2)))
  _close([g[0] for g in got], ref)


# ---------------------------------------------------------------- collide


# scene -> the MuJoCo fixture whose initial object poses it starts from
# (clutter12 has none: its reference pose)
FIXTURES = {'pad2-cube2-clutter4': 'pad2cube2clutter4',
            'pad2-cube2-clutter12': None, 'nut-cone': 'nutcone',
            'ball-cup': 'ballcup'}


@pytest.fixture(scope='module', params=list(FIXTURES))
def settled(request):
  """A state of the scene settled by the JAX stepper: the objects at their
  poses in the MuJoCo fixture's first frame, then 12 substeps."""
  jm, _ = jmjcf.load_model(reference_xml(f'geeco-{request.param}.xml'))
  mesh = any(t == MESH for (_, t), _ in jm.col_pairs)
  js = jbuild(jm, select_mode='quota' if mesh else 'topk')
  method = 'psd_block' if mesh else 'psd'
  sub = jax.jit(lambda s: js.substep(s, 30, method))
  st = js.init_state(jmake_state(jm))
  if FIXTURES[request.param]:
    fx = np.load(os.path.join(REPO_ROOT, 'tests', 'fixtures',
                              f'mujoco_pickplace_{FIXTURES[request.param]}'
                              '.npz'))
    q = st.qpos
    for name, obj in zip(fx['obj_joint_names'], fx['init_obj_qpos']):
      q = jset(jm, q, str(name), jnp.asarray(obj, jnp.float32))
    st = st.replace(qpos=q)
  for _ in range(12):
    st = sub(st)
  return request.param, jm, convert.model_from_reference(jm), st


def test_collide_matches_on_settled_scenes(settled):
  name, jm, tm, st = settled
  ref = jax.jit(lambda s: JC.collide(jm, JK.fk(jm, s)))(st)
  got = TC.collide(tm, TK.fk(tm, convert.state_from_reference(st)))
  np.testing.assert_array_equal(got.geom1, np.asarray(ref.geom1))
  np.testing.assert_array_equal(got.geom2, np.asarray(ref.geom2))
  off = 0
  for (t1, t2), pairs in jm.col_pairs:     # one pair group at a time
    rows = slice(off, off + JC._POINTS[(t1, t2)] * len(pairs))
    off = rows.stop
    shape = lambda x, k: np.asarray(x)[rows].reshape(len(pairs), -1, *k)
    _close([shape(got.pos[0], (3,)), shape(got.normal[0], (3,)),
            shape(got.dist[0], ())],
           [shape(ref.pos, (3,)), shape(ref.normal, (3,)),
            shape(ref.dist, ())])
  assert off == len(ref.dist)
  assert (np.asarray(ref.dist) < 0).sum() >= 4, name   # resting contacts


def test_model_carries_hulls(settled):
  """``convert.model_from_reference`` carries the hull ids and the padded
  hull arrays."""
  name, jm, tm, _ = settled
  assert tuple(tm.geom_hullid) == tuple(jm.geom_hullid)
  for f in TC._HULL_FIELDS:
    np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                  np.asarray(getattr(jm, f)), err_msg=f)
  assert TC.ncon_max(tm) == JC.ncon_max(jm)
