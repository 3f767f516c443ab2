"""Render-scene compilation: Model + Assets -> static triangle buffers.

Carried across unchanged from ``geeco_tpu/render/scene.py`` (numpy); only
its imports point at the port's modules.  Build it from a model whose
tensors lie on the CPU.

Primitives are tessellated and meshes decimated (vertex clustering) at
compile time into one flat vertex/triangle soup, with per-vertex geom ids so
a frame render is: gather geom world poses -> transform all vertices ->
rasterize.  All shapes static; the per-frame work is pure batched math.

Replaces the reference's offscreen OpenGL context (mujoco-py
MjRenderContextOffscreen; reference: src/geeco_gym/pickplace.py:260-264)
with an on-device pipeline whose output lives in HBM next to the policy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..core.mjcf import Assets
from ..core.model import (BOX, CAPSULE, CYLINDER, ELLIPSOID, MESH, Model,
                          PLANE, SPHERE)


class RenderScene(NamedTuple):
  vert: np.ndarray       # [V, 3] local coords (geom frame)
  vert_geom: np.ndarray  # [V] geom id per vertex
  tri: np.ndarray        # [T, 3] vertex indices
  tri_geom: np.ndarray   # [T] geom id per triangle
  ngeom: int
  # --- texture sampling (tessellated texel grid per textured surface) ---
  # Textured planes / box tops are subdivided into a G x G quad grid; each
  # sub-triangle carries a texel index into its surface's [R, R] grid so
  # shading reads a per-triangle base color instead of the geom color.
  # Surfaces are "slots": slot s samples tex_default[s] unless the caller
  # overrides it at render time (background-video domain randomization).
  tri_texslot: np.ndarray  # [T] int32 slot id, -1 = untextured
  tri_texel: np.ndarray    # [T] int32 v*R + u into the slot's texel grid
  tex_default: np.ndarray  # [S, R, R, 3] f32 static texel colors
  tex_slot_geom: np.ndarray  # [S] int32 geom id per slot
  tex_res: int             # R
  # --- shadows (planar occlusion-tested, see rasterizer._shadow_factors) ---
  # receivers: triangles of static bodies (table / floor / walls) whose
  # shading gets a per-vertex light-visibility test; casters: triangles of
  # free-jointed bodies (the task objects).  Arm links cast via their
  # collision capsule proxies, resolved at renderer build (invisible
  # capsule geoms on articulated bodies, core/mjcf.py arm-proxy block).
  shadow_recv: np.ndarray  # [Rr] int32 triangle indices
  shadow_cast: np.ndarray  # [Ct] int32 triangle indices
  # deduplicated receiver sample points: grid tessellations share vertices
  # heavily (~5x), so light visibility is tested once per unique vertex and
  # averaged per triangle (soft 0/1/3..1 edge levels)
  shadow_pts: np.ndarray     # [Pv] int32 vertex ids
  shadow_recv_pt: np.ndarray  # [Rr, 3] int32 indices into shadow_pts
  # --- analytic rects (planes + textured box top faces) -----------------
  # Large flat surfaces are NOT tessellated into triangles: the rasterizer
  # ray-casts them analytically per pixel (exact edges, per-pixel texels,
  # zero binning load).  Round-3 fix: their texel-grid triangles were
  # small, got no big-triangle binning protection, and dense robot-mesh
  # columns evicted them -> sky holes behind the robot (caught by the
  # golden MuJoCo ray-cast parity fixture).
  rect_geom: np.ndarray   # [R] int32 geom id
  rect_off: np.ndarray    # [R, 3] f32 rect center offset in geom frame
  rect_half: np.ndarray   # [R, 2] f32 in-plane half extents
  rect_slot: np.ndarray   # [R] int32 texture slot, -1 = flat geom color
  rect_recv: np.ndarray   # [R] bool static shadow receiver
  rect_grid: np.ndarray   # [R] int32 texel-cell grid G (visual parity with
  #                         the tessellated path: texels quantized to the
  #                         G x G cells the old _grid_quad would have used)


# ------------------------------------------------------------- tessellation


def _box_mesh():
  v = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                for sz in (-1, 1)], np.float32)
  f = np.array([
      [0, 1, 3], [0, 3, 2],  # -x
      [4, 6, 7], [4, 7, 5],  # +x
      [0, 4, 5], [0, 5, 1],  # -y
      [2, 3, 7], [2, 7, 6],  # +y
      [0, 2, 6], [0, 6, 4],  # -z
      [1, 5, 7], [1, 7, 3],  # +z
  ], np.int32)
  return v, f


def _icosphere(subdiv: int = 1):
  t = (1.0 + np.sqrt(5.0)) / 2.0
  v = np.array([
      [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
  v /= np.linalg.norm(v, axis=1, keepdims=True)
  f = np.array([
      [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
      [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
      [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
      [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
  for _ in range(subdiv):
    mids = {}
    verts = list(v)
    faces = []
    def mid(a, b):
      key = (min(a, b), max(a, b))
      if key not in mids:
        m = verts[a] + verts[b]
        m = m / np.linalg.norm(m)
        mids[key] = len(verts)
        verts.append(m)
      return mids[key]
    for a, b, c in f:
      ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
      faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
  return v, f


def _capsule_mesh(radius: float, half_len: float, nseg: int = 12):
  """Capsule along z: cylinder + hemispherical caps."""
  ang = np.linspace(0, 2 * np.pi, nseg, endpoint=False)
  ring = np.stack([np.cos(ang), np.sin(ang)], -1)
  verts, faces = [], []
  # cylinder rings
  top = np.concatenate([radius * ring, np.full((nseg, 1), half_len)], -1)
  bot = np.concatenate([radius * ring, np.full((nseg, 1), -half_len)], -1)
  verts = list(bot) + list(top)
  for i in range(nseg):
    j = (i + 1) % nseg
    faces += [[i, j, nseg + j], [i, nseg + j, nseg + i]]
  # caps from icosphere hemispheres (coarse: fan to pole)
  top_pole = len(verts)
  verts.append(np.array([0, 0, half_len + radius], np.float32))
  bot_pole = len(verts)
  verts.append(np.array([0, 0, -half_len - radius], np.float32))
  for i in range(nseg):
    j = (i + 1) % nseg
    faces.append([nseg + i, nseg + j, top_pole])
    faces.append([j, i, bot_pole])
  return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def decimate(vert: np.ndarray, face: np.ndarray,
             target_faces: int) -> tuple[np.ndarray, np.ndarray]:
  """Vertex-clustering decimation to approximately target_faces."""
  if face.shape[0] <= target_faces:
    return vert, face
  lo, hi = vert.min(0), vert.max(0)
  extent = np.maximum(hi - lo, 1e-6)
  # binary search grid resolution
  for res in (64, 48, 32, 24, 16, 12, 8, 6, 4, 3):
    cell = extent.max() / res
    key = np.floor((vert - lo) / cell).astype(np.int64)
    key1 = key[:, 0] * 1000000 + key[:, 1] * 1000 + key[:, 2]
    uniq, inv = np.unique(key1, return_inverse=True)
    # representative = mean of cluster
    rep = np.zeros((len(uniq), 3), np.float64)
    cnt = np.zeros(len(uniq), np.int64)
    np.add.at(rep, inv, vert)
    np.add.at(cnt, inv, 1)
    rep = (rep / cnt[:, None]).astype(np.float32)
    nf = inv[face]
    keep = (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & \
        (nf[:, 0] != nf[:, 2])
    nf = nf[keep]
    if nf.shape[0] <= target_faces:
      return rep, nf.astype(np.int32)
  return rep, nf.astype(np.int32)


# ------------------------------------------------------------- compile


# plane half-extent fallback when size is zero (infinite plane in MJCF)
_PLANE_DEFAULT_HALF = 5.0
# decimation budgets: articulated arm links stay crisper than decor
_MESH_FACE_BUDGET = 400
# texel grid per textured surface (G x G quads = 2*G^2 tris); the table top
# spans ~180 px in the 256^2 external camera -> ~7 px texels at G=24
_TEX_GRID = 24
_TEX_RES = 32


def _grid_quad(hx: float, hy: float, z: float, grid: int):
  """G x G quad grid over [-hx,hx]x[-hy,hy] at height z.

  Returns (verts [(G+1)^2, 3], faces [2G^2, 3], texel [2G^2] v*R+u) with
  texels sampled at cell centers of an R x R texture grid (R = _TEX_RES).
  """
  G, R = grid, _TEX_RES
  xs = np.linspace(-hx, hx, G + 1)
  ys = np.linspace(-hy, hy, G + 1)
  vx, vy = np.meshgrid(xs, ys, indexing='xy')
  verts = np.stack([vx.ravel(), vy.ravel(), np.full(vx.size, z)], -1)
  faces, texel = [], []
  for j in range(G):
    for i in range(G):
      a = j * (G + 1) + i
      b = a + 1
      c = a + (G + 1)
      d = c + 1
      # texel at the cell center; image row 0 = +y edge (top of the image
      # maps to +y, matching OpenGL's t-up convention after the row flip)
      u = int((i + 0.5) / G * R)
      v = int((1.0 - (j + 0.5) / G) * R)
      t = min(v, R - 1) * R + min(u, R - 1)
      faces.append([a, b, d])
      faces.append([a, d, c])
      texel.extend([t, t])
  return (verts.astype(np.float32), np.asarray(faces, np.int32),
          np.asarray(texel, np.int32))


def _sample_texture(img: np.ndarray, repx: float, repy: float) -> np.ndarray:
  """Tile a texture by (repx, repy) and box-resample to [R, R, 3]."""
  R = _TEX_RES
  th, tw, _ = img.shape
  # sample at R x R cell centers of the tiled texture
  u = (np.arange(R) + 0.5) / R * repx % 1.0
  v = (np.arange(R) + 0.5) / R * repy % 1.0
  iu = np.minimum((u * tw).astype(np.int64), tw - 1)
  iv = np.minimum((v * th).astype(np.int64), th - 1)
  return img[iv][:, iu].astype(np.float32)


def build_render_scene(model: Model, assets: Assets,
                       mesh_face_budget: int = _MESH_FACE_BUDGET,
                       skip_alpha_below: float = 0.01,
                       tex_grid: int = _TEX_GRID,
                       analytic_rects: bool = False) -> RenderScene:
  # analytic_rects default matches build_renderer (False): the analytic
  # background layer is opt-in until the shared-occlusion-pass redesign
  # lands (see geeco_tpu/render/scene.py)
  all_v, all_vg, all_f, all_fg = [], [], [], []
  all_slot, all_texel = [], []
  tex_default, tex_slot_geom = [], []
  voff = 0
  box_v, box_f = _box_mesh()
  sph_v, sph_f = _icosphere(1)
  rgba = np.asarray(model.geom_rgba)

  def geom_texture(g):
    """(texture image, repx, repy) for geom g, or None."""
    if not tex_grid or g >= len(assets.geom_material):
      return None
    mt = assets.material_texture.get(assets.geom_material[g])
    if mt is None:
      return None
    tex, repx, repy = mt
    img = assets.texture_images.get(tex)
    return None if img is None else (img, repx, repy)

  def grid_for(hx, hy):
    """Texel grid scaled to surface size: the 0.9 m table top gets the
    full grid (~6 px texels in the external camera), multi-meter
    background planes half of it, small trims (table legs) almost none —
    bounding the triangle-count cost of texturing."""
    ext = max(hx, hy)
    if ext <= 0.15:
      return 2
    if ext <= 0.6:
      return tex_grid
    return max(2, tex_grid // 4)

  def emit(v, f, g, texel=None, slot=-1):
    nonlocal voff
    all_v.append(v.astype(np.float32))
    all_vg.append(np.full(v.shape[0], g, np.int32))
    all_f.append(f.astype(np.int32) + voff)
    all_fg.append(np.full(f.shape[0], g, np.int32))
    all_slot.append(np.full(f.shape[0], slot, np.int32))
    all_texel.append(np.zeros(f.shape[0], np.int32)
                     if texel is None else texel)
    voff += v.shape[0]

  rect_geom, rect_off, rect_half, rect_slot, rect_grid = [], [], [], [], []

  def emit_rect(g, off, half, tex):
    slot = -1
    if tex is not None:
      img, repx, repy = tex
      slot = len(tex_default)
      tex_default.append(_sample_texture(img, repx, repy))
      tex_slot_geom.append(g)
    rect_geom.append(g)
    rect_off.append(off)
    rect_half.append(half)
    rect_slot.append(slot)
    rect_grid.append(grid_for(half[0], half[1]))

  for g in range(model.ngeom):
    gtype = model.geom_type[g]
    size = np.asarray(model.geom_size[g])
    if rgba[g, 3] < skip_alpha_below:
      continue  # statically invisible (e.g. debug crosshair handled per-env)
    tex = geom_texture(g)
    if gtype == PLANE:
      hx = size[0] if size[0] > 0 else _PLANE_DEFAULT_HALF
      hy = size[1] if size[1] > 0 else _PLANE_DEFAULT_HALF
      if analytic_rects:
        emit_rect(g, (0.0, 0.0, 0.0), (hx, hy), tex)
        continue
      if tex is not None:
        img, repx, repy = tex
        v, f, texel = _grid_quad(hx, hy, 0.0, grid_for(hx, hy))
        slot = len(tex_default)
        tex_default.append(_sample_texture(img, repx, repy))
        tex_slot_geom.append(g)
        emit(v, f, g, texel, slot)
        continue
      v = np.array([[-hx, -hy, 0], [hx, -hy, 0], [hx, hy, 0], [-hx, hy, 0]],
                   np.float32)
      f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    elif gtype == BOX:
      if tex is not None:
        if analytic_rects:
          # analytic textured +z face; the 5 other faces keep the coarse
          # box mesh with the material mean color
          emit_rect(g, (0.0, 0.0, float(size[2])),
                    (float(size[0]), float(size[1])), tex)
          vb, fb = box_v * size[None, :], box_f[:10]  # drop the 2 +z faces
          emit(vb, fb, g)
          continue
        # tessellate + texture the +z face; the 5 other faces keep the
        # coarse box mesh with the material mean color
        img, repx, repy = tex
        v, f, texel = _grid_quad(size[0], size[1], size[2],
                                 grid_for(size[0], size[1]))
        slot = len(tex_default)
        tex_default.append(_sample_texture(img, repx, repy))
        tex_slot_geom.append(g)
        emit(v, f, g, texel, slot)
        vb, fb = box_v * size[None, :], box_f[:10]  # drop the 2 +z faces
        emit(vb, fb, g)
        continue
      v, f = box_v * size[None, :], box_f
    elif gtype == SPHERE:
      v, f = sph_v * size[0], sph_f
    elif gtype == ELLIPSOID:
      v, f = sph_v * size[None, :], sph_f
    elif gtype in (CAPSULE, CYLINDER):
      v, f = _capsule_mesh(size[0], size[1])
    elif gtype == MESH:
      mesh = assets.meshes[model.geom_meshid[g]]
      v, f = decimate(mesh.vert, mesh.face, mesh_face_budget)
    else:
      continue
    emit(v, f, g)
  S, R = len(tex_default), _TEX_RES
  if not all_f:  # degenerate scene of only rects
    all_v = [np.zeros((0, 3), np.float32)]
    all_vg = [np.zeros(0, np.int32)]
    all_f = [np.zeros((0, 3), np.int32)]
    all_fg = [np.zeros(0, np.int32)]
    all_slot = [np.zeros(0, np.int32)]
    all_texel = [np.zeros(0, np.int32)]
  tri_geom_all = np.concatenate(all_fg)
  # body movability: any joint on the chain to world (for receivers);
  # free-jointed bodies (the loose task objects) are the triangle casters
  movable = np.zeros(model.nbody, bool)
  has_free = np.zeros(model.nbody, bool)
  for b in range(model.nbody):
    has_free[b] = any(model.jnt_type[j] == 0  # FREE
                      for j in model.body_jntadr[b])
    p = b
    while p:
      if model.body_jntadr[p]:
        movable[b] = True
        break
      p = model.body_parentid[p]
  gb = np.asarray(model.geom_bodyid)
  recv = np.nonzero(~movable[gb[tri_geom_all]])[0].astype(np.int32)
  cast = np.nonzero(has_free[gb[tri_geom_all]])[0].astype(np.int32)
  tri_all = np.concatenate(all_f)
  spts, sinv = np.unique(tri_all[recv].ravel(), return_inverse=True)
  return RenderScene(
      vert=np.concatenate(all_v),
      vert_geom=np.concatenate(all_vg),
      tri=np.concatenate(all_f),
      tri_geom=np.concatenate(all_fg),
      ngeom=model.ngeom,
      tri_texslot=np.concatenate(all_slot),
      tri_texel=np.concatenate(all_texel),
      tex_default=(np.stack(tex_default) if S
                   else np.zeros((0, R, R, 3), np.float32)),
      tex_slot_geom=np.asarray(tex_slot_geom, np.int32),
      tex_res=R,
      shadow_recv=recv,
      shadow_cast=cast,
      shadow_pts=spts.astype(np.int32),
      shadow_recv_pt=sinv.reshape(-1, 3).astype(np.int32),
      rect_geom=np.asarray(rect_geom, np.int32),
      rect_off=(np.asarray(rect_off, np.float32)
                if rect_geom else np.zeros((0, 3), np.float32)),
      rect_half=(np.asarray(rect_half, np.float32)
                 if rect_geom else np.zeros((0, 2), np.float32)),
      rect_slot=np.asarray(rect_slot, np.int32),
      rect_recv=(~movable[gb[np.asarray(rect_geom, np.int32)]]
                 if rect_geom else np.zeros(0, bool)),
      rect_grid=np.asarray(rect_grid, np.int32),
  )
