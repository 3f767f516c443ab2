"""Tiled batched triangle rasterizer producing RGB(-D) observations.

Counterpart of ``geeco_tpu/render/rasterizer.py``, with every option of its
``build_renderer``.  Pipeline, for B envs at once:
  1. transform the compiled triangle soup by the geom world poses (Kin)
  2. project to screen space (MuJoCo camera: looks along -z, y up,
     vertical fov = cam_fovy) and flat-shade each triangle, with
     occlusion-tested shadows on static receivers
  3. binning, one of two ways:
     * hierarchical: coarse regions of 4x4 fine tiles keep their top-K1
       triangles by priority, then mid regions of 2x2 tiles keep the first
       K2 coarse candidates that overlap them; each fine tile reads its mid
       region's list, and the hand-written CUDA kernel
       (``raster_kernel.raster_tiles``) z-buffers it in inverse depth on the
       card, its plain PyTorch twin on the CPU;
     * flat (the JAX package's ``_bin_flat`` + ``_raster_jnp``): every fine
       tile keeps its top ``tris_per_tile`` triangles of all T and a
       chunked z-min scan rasterizes them, in plain PyTorch on every device
  4. compose the tiles into the image, then composite the analytic
     background layer: the scene's rects (planes, textured box tops) when
     ``analytic_rects``, ray-cast per pixel; sky at zfar where nothing is hit
  5. optionally OpenGL-style nonlinear depth (``depth_gl``)

Which path a render takes is the JAX package's choice: the flat one when
``backend='jnp'`` or when the tile grid is no multiple of 4 a side, the
hierarchical one otherwise.  ``backend='auto'`` here means the hierarchical
path (the kernel on the card, its twin on the CPU), where the JAX package's
'auto' means Pallas on the TPU and flat binning elsewhere; 'pallas' is a
synonym of 'auto'.  A scene with no triangles at all is the analytic layer
alone.  ``Renderer.path_counts`` counts the renders each path took.

Layout: the JAX package keeps [K, n_tiles] planes (tiles in TPU lanes);
here the binned planes are tile-major, [B, n_tiles, K], so one CUDA block
reads one tile's slot list from contiguous memory.  Tile order within the
image is the JAX package's mid-major order (tile = mid * 4 + sub) on the
hierarchical path and row-major on the flat one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..core import math as gm
from ..core.mjcf import Assets
from ..core.model import CAPSULE, Kin, Model
from ..utils import profiling
from . import raster_kernel
from .scene import RenderScene, build_render_scene

_COARSE = 4   # fine tiles per coarse-region side
_MID = 2      # fine tiles per mid-region side


@dataclass
class Renderer:
  model: Model
  scene: RenderScene
  width: int
  height: int
  cam_id: int
  tile: int
  tris_per_tile: int
  chunk: int
  znear: float
  zfar: float
  sky_rgb: Tuple[float, float, float]
  depth_gl: bool  # OpenGL-style nonlinear depth output
  cull: int       # backface culling: 0 off, +1/-1 keep that area sign
  coarse: int     # the JAX package's coarse option: kept, unused as there
  coarse_k: int   # candidate capacity per coarse (4x4-tile) region
  mid_k: int      # candidate capacity per mid (2x2-tile) region
  backend: str    # 'auto' | 'pallas' (hierarchical) | 'jnp' (flat)
  shadows: bool   # occlusion-tested shadows on static receivers
  shadow_caps: Tuple[int, ...]  # capsule occluder geom ids (arm proxies)
  rect_pixel_texels: bool  # full per-pixel texels on analytic rects
  #                          (False = cell-quantized, as the tessellated
  #                          path's texel quads)
  scene_key: str = ''  # the options the scene was built with: the key of
  #                      its arrays in the model's tensor cache
  # renders per path ('hierarchical', 'flat', 'rects'), shared by the
  # renderers ``replace`` derives from this one
  path_counts: Dict[str, int] = field(default_factory=dict, compare=False)

  def replace(self, **changes) -> 'Renderer':
    return dataclasses.replace(self, **changes)

  def render(self, kin: Kin, geom_rgba: torch.Tensor | None = None,
             textures: torch.Tensor | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render B envs: (rgb uint8 [B, H, W, 3], depth f32 [B, H, W]).

    ``textures`` (f32 in [0, 1], [S, R, R, 3] for every env or
    [B, S, R, R, 3] per env) overrides the static texel colours of the
    scene's textured surfaces (``RenderScene.tri_texslot`` and the textured
    rects): the reference's TextureModder background randomisation.  The
    texels only colour the triangles, so the raster kernel is the same.
    """
    with profiling.span('render'):
      return _render(self, kin, geom_rgba, textures)

  def const(self, name: str, value=None) -> torch.Tensor:
    """A RenderScene array (or ``value``, an array derived from the scene)
    as a cached tensor on the model's device."""
    return self.model.const(
        f'scene{self.scene_key}.{name}',
        getattr(self.scene, name) if value is None else value)


BACKENDS = ('auto', 'pallas', 'jnp')


def build_renderer(model: Model, assets: Assets, width: int = 256,
                   height: int = 256, camera: str = 'external_camera_1',
                   tile: int = 16, tris_per_tile: int = 96, chunk: int = 8,
                   znear: float = 0.05, zfar: float = 10.0,
                   mesh_face_budget: int = 400, tex_grid: int = None,
                   depth_gl: bool = False, cull: int = -1,
                   coarse: int = 4, coarse_k: int = 512, mid_k: int = 192,
                   backend: str = 'auto', shadows: bool = True,
                   rect_pixel_texels: bool = False,
                   analytic_rects: bool = False) -> Renderer:
  """Compile the scene (numpy, from a model on the CPU) into a Renderer.

  The JAX package's options and defaults.  ``camera``: any named camera of
  the model (``gripper_camera_rgb`` rides on the gripper).  ``tile``: the
  fine tile's side in pixels (the frame must hold whole tiles; the coarse
  and mid regions are 4 and 2 tiles a side).  ``tris_per_tile`` and
  ``chunk``: the flat path's slots per tile and slots per z-min step.
  ``mesh_face_budget`` and ``tex_grid`` (None: the scene's default; 0: flat
  colours) shape the scene; ``analytic_rects`` ray-casts its planes and box
  tops per pixel instead of tessellating them, with per-pixel texels when
  ``rect_pixel_texels``.  ``backend``: see the module docstring.
  """
  if backend not in BACKENDS:
    raise ValueError(f'backend {backend!r} is not one of {BACKENDS}')
  if tile < 1 or height % tile or width % tile:
    raise ValueError(f'{width}x{height} does not hold whole {tile}-px '
                     'tiles')
  scene_kwargs = {} if tex_grid is None else {'tex_grid': tex_grid}
  scene = build_render_scene(model, assets, mesh_face_budget=mesh_face_budget,
                             analytic_rects=analytic_rects, **scene_kwargs)
  # sky colour: mean of the builtin gradient skybox texture
  sky = (0.45, 0.86, 0.57)
  # arm-link capsule occluders: the invisible collision proxies double as
  # shadow casters
  rgba = model.geom_rgba.cpu().numpy()
  caps = tuple(int(g) for g in range(model.ngeom)
               if model.geom_type[g] == CAPSULE and rgba[g, 3] < 0.01)
  return Renderer(model=model, scene=scene, width=width, height=height,
                  cam_id=model.cam(camera), tile=tile,
                  tris_per_tile=tris_per_tile, chunk=chunk, znear=znear,
                  zfar=zfar, sky_rgb=sky, depth_gl=depth_gl, cull=cull,
                  coarse=coarse, coarse_k=min(coarse_k, scene.tri.shape[0]),
                  mid_k=min(mid_k, coarse_k), backend=backend,
                  shadows=shadows, shadow_caps=caps,
                  rect_pixel_texels=rect_pixel_texels,
                  scene_key=(f'[{mesh_face_budget},{tex_grid},'
                             f'{analytic_rects}]'))


# ---------------------------------------------------------------------------
# stage 1+2: vertex transform, projection, shading -> per-triangle planes


class TriPlanes(NamedTuple):
  """Per-triangle screen-space scalar planes (all [B, T])."""
  x0: torch.Tensor
  y0: torch.Tensor
  x1: torch.Tensor
  y1: torch.Tensor
  x2: torch.Tensor
  y2: torch.Tensor
  iz0: torch.Tensor    # 1/depth at vertices
  iz1: torch.Tensor
  iz2: torch.Tensor
  valid: torch.Tensor  # bool
  colp: torch.Tensor   # packed shaded colour r*65536 + g*256 + b (exact f32)


def _camera(r: Renderer, kin: Kin):
  """Camera world pose: (position [B, 3], rotation [B, 3, 3], cols = axes)."""
  model = r.model
  cb = model.cam_bodyid[r.cam_id]
  cam_pos = kin.xpos[:, cb] + gm.quat_rotate(kin.xquat[:, cb],
                                             model.cam_pos[r.cam_id])
  cam_quat = gm.quat_mul(kin.xquat[:, cb], model.cam_quat[r.cam_id])
  return cam_pos, gm.quat_to_mat(cam_quat)


def _vertex_world(r: Renderer, kin: Kin) -> torch.Tensor:
  """Transform all scene vertices into world space [B, V, 3]."""
  vg = r.const('vert_geom')
  return (kin.geom_xpos[:, vg] +
          gm.quat_rotate(kin.geom_xquat[:, vg], r.const('vert')))


def _project_and_shade(r: Renderer, kin: Kin, rgba: torch.Tensor,
                       cam=None, world=None, textures=None) -> TriPlanes:
  model, scene = r.model, r.scene
  H, W = r.height, r.width
  cam_pos, Rc = _camera(r, kin) if cam is None else cam
  if world is None:
    world = _vertex_world(r, kin)                       # [B, V, 3]

  pc = torch.einsum('zvi,zij->zvj', world - cam_pos[:, None], Rc)
  depth_v = -pc[..., 2]                                 # positive in front
  f = 1.0 / torch.tan(torch.deg2rad(model.cam_fovy[r.cam_id]) * 0.5)
  safe_d = torch.clamp(depth_v, min=1e-4)
  aspect = W / H
  u = (pc[..., 0] * f / (safe_d * aspect) * 0.5 + 0.5) * W
  v = (0.5 - pc[..., 1] * f / safe_d * 0.5) * H

  tri = r.const('tri')                                  # [T, 3]
  tg = r.const('tri_geom')                              # [T]
  i0, i1, i2 = tri[:, 0], tri[:, 1], tri[:, 2]
  x0, y0 = u[:, i0], v[:, i0]
  x1, y1 = u[:, i1], v[:, i1]
  x2, y2 = u[:, i2], v[:, i2]
  d0, d1, d2 = depth_v[:, i0], depth_v[:, i1], depth_v[:, i2]
  w0, w1, w2 = world[:, i0], world[:, i1], world[:, i2]

  valid = (d0 > r.znear) & (d1 > r.znear) & (d2 > r.znear)
  valid &= rgba[:, tg, 3] > 0.5                         # per-env visibility
  area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
  valid &= area.abs() > 1e-8
  if r.cull:
    valid &= (area * r.cull) > 0

  # ---- flat shading per triangle
  n_w = gm.cross(w1 - w0, w2 - w0)
  n_w = n_w / torch.clamp(gm.norm(n_w, keepdim=True), min=1e-9)
  centroid = (w0 + w1 + w2) / 3.0
  to_cam = cam_pos[:, None] - centroid
  flip = torch.sign((n_w * to_cam).sum(-1, keepdim=True) + 1e-12)
  n_w = n_w * flip                     # double-sided: face the camera
  if model.nlight:
    if model.light_directional[0]:
      l = (-model.light_dir[0]).expand(centroid.shape)
    else:
      l = model.light_pos[0] - centroid
      l = l / torch.clamp(gm.norm(l, keepdim=True), min=1e-9)
  else:
    l = centroid.new_tensor([0.0, 0.0, 1.0]).expand(centroid.shape)
  diff = torch.clamp((n_w * l).sum(-1), min=0.0)
  if (r.shadows and model.nlight and scene.shadow_recv.size and
      (scene.shadow_cast.size or r.shadow_caps)):
    # shadowed receivers lose the light's diffuse term (ambient remains)
    diff = diff * (1.0 - _shadow_occlusion(r, kin, world))
  shade = torch.clamp(0.45 + 0.6 * diff, 0.0, 1.1)
  base = rgba[:, tg, :3]                                # [B, T, 3]
  if scene.tex_default.shape[0]:
    # textured triangles read their texel from the slot's [R, R] grid;
    # ``textures`` overrides the static texels for this render
    R2 = scene.tex_res * scene.tex_res
    slot = r.const('tri_texslot')
    idx = torch.clamp(slot, min=0) * R2 + r.const('tri_texel')
    if textures is None:
      trgb = r.const('tex_default').reshape(-1, 3)[idx]       # [T, 3]
    else:
      tex = torch.as_tensor(textures, dtype=torch.float32,
                            device=base.device)
      want = tuple(scene.tex_default.shape)
      if tuple(tex.shape[-4:]) != want or tex.dim() not in (4, 5):
        raise ValueError(f'textures must be {want} or [B, *{want}], got '
                         f'{tuple(tex.shape)}')
      trgb = tex.reshape(tex.shape[:-4] + (-1, 3))[..., idx, :]
    base = torch.where((slot >= 0)[:, None], trgb, base)
  c = torch.clamp(base * shade[..., None] * 255.0, 0.0, 255.0)
  colp = (torch.floor(c[..., 0]) * 65536.0 + torch.floor(c[..., 1]) * 256.0 +
          torch.floor(c[..., 2]))              # exact in f32 (< 2^24)

  iz0 = 1.0 / torch.clamp(d0, min=1e-6)
  iz1 = 1.0 / torch.clamp(d1, min=1e-6)
  iz2 = 1.0 / torch.clamp(d2, min=1e-6)
  return TriPlanes(x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, valid, colp)


def _seg_seg_dist(p1: torch.Tensor, d1: torch.Tensor, pa: torch.Tensor,
                  pb: torch.Tensor) -> torch.Tensor:
  """Min distance between segments p1->p1+d1 ([B,P,3]) and pa->pb ([B,C,3]).

  Vectorised Ericson closest points of two segments; returns [B, P, C].
  """
  d2 = pb - pa                                          # [B, C, 3]
  rv = p1[:, :, None, :] - pa[:, None, :, :]            # [B, P, C, 3]
  a = (d1 * d1).sum(-1)[:, :, None]                     # [B, P, 1]
  e = (d2 * d2).sum(-1)[:, None, :]                     # [B, 1, C]
  f = torch.einsum('zcj,zpcj->zpc', d2, rv)
  c = torch.einsum('zpj,zpcj->zpc', d1, rv)
  b = torch.einsum('zpj,zcj->zpc', d1, d2)
  denom = a * e - b * b
  big = denom > 1e-12
  zero = torch.zeros((), dtype=denom.dtype, device=denom.device)
  one = torch.ones((), dtype=denom.dtype, device=denom.device)
  s = torch.clamp(torch.where(big, b * f - c * e, zero) /
                  torch.where(big, denom, one), 0.0, 1.0)
  t = torch.clamp((b * s + f) / torch.where(e > 1e-12, e, one), 0.0, 1.0)
  s = torch.clamp((b * t - c) / torch.where(a > 1e-12, a, one), 0.0, 1.0)
  q1 = p1[:, :, None, :] + s[..., None] * d1[:, :, None, :]
  q2 = pa[:, None, :, :] + t[..., None] * d2[:, None, :, :]
  return gm.norm(q1 - q2)


# casters per chunk of the Moller-Trumbore loop: bounds the [B, Pv, CC, 3]
# intermediates
_SHADOW_CHUNK = 64


def _occlude_points(r: Renderer, kin: Kin, world: torch.Tensor,
                    P: torch.Tensor) -> torch.Tensor:
  """Light-visibility test for world points P [B, Pv, 3] -> occlusion.

  Tests against (a) free-body triangles (Moller-Trumbore, in chunks of
  casters) and (b) the arm's capsule proxies (segment-segment distance).
  """
  model, scene = r.model, r.scene
  if model.light_directional[0]:
    d = (-model.light_dir[0] * 20.0).expand(P.shape)
  else:
    d = model.light_pos[0] - P                          # [B, Pv, 3]
  eps = 1e-3
  occ = P.new_zeros(P.shape[:2])

  ct = np.asarray(scene.shadow_cast)
  if ct.size:
    CC = min(_SHADOW_CHUNK, ct.size)
    pad = (-ct.size) % CC
    # pad with copies of the first caster: occlusion is an OR
    ct = np.concatenate([ct, np.full(pad, ct[0], ct.dtype)])
    tri_c = r.const('shadow_cast_tri', np.asarray(scene.tri)[ct])
    for c0 in range(0, ct.size, CC):
      abc = tri_c[c0:c0 + CC]
      A, Bv, Cv = world[:, abc[:, 0]], world[:, abc[:, 1]], world[:, abc[:, 2]]
      e1 = (Bv - A)[:, None]                           # [B, 1, CC, 3]
      e2 = (Cv - A)[:, None]
      pv = gm.cross(d[:, :, None, :], e2)              # [B, Pv, CC, 3]
      det = (e1 * pv).sum(-1)
      ok = det.abs() > 1e-9
      inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
      tv = P[:, :, None, :] - A[:, None]
      u = (tv * pv).sum(-1) * inv
      qv = gm.cross(tv, e1)
      v = (d[:, :, None, :] * qv).sum(-1) * inv
      t = (e2 * qv).sum(-1) * inv
      hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps) &
             (t < 1.0 - eps))
      occ = torch.maximum(occ, hit.any(-1).to(occ.dtype))

  if r.shadow_caps:
    gids = model.const('render.shadow_caps', r.shadow_caps)
    gp = kin.geom_xpos[:, gids]                         # [B, Nc, 3]
    gq = kin.geom_xquat[:, gids]
    ax = gm.quat_rotate(gq, gp.new_tensor([0.0, 0.0, 1.0]).expand(gp.shape))
    hl = model.geom_size[gids, 1][:, None]
    rad = model.geom_size[gids, 0]
    dist = _seg_seg_dist(P, d, gp - ax * hl, gp + ax * hl)
    occ = torch.maximum(occ, (dist < rad).any(-1).to(occ.dtype))
  return occ


def _shadow_occlusion(r: Renderer, kin: Kin, world: torch.Tensor
                      ) -> torch.Tensor:
  """Per-triangle shadow fraction [B, T] in [0, 1].

  Light visibility is tested once per unique receiver vertex, then averaged
  over each receiver triangle's 3 vertices.  Non-receivers get 0.
  """
  B = world.shape[0]
  P = world[:, r.const('shadow_pts')]                   # [B, Pv, 3]
  occ = _occlude_points(r, kin, world, P)
  occ_tri = occ[:, r.const('shadow_recv_pt')].mean(-1)  # [B, Rr]
  T = r.scene.tri.shape[0]
  out = occ.new_zeros((B, T))
  out[:, r.const('shadow_recv')] = occ_tri
  return out


def _analytic_bg(r: Renderer, kin: Kin, rgba: torch.Tensor, textures, cam,
                 world: torch.Tensor):
  """Per-pixel ray cast of the scene's analytic rects (planes, textured box
  tops): (depth [B, H, W] f32, colp [B, H, W] packed f32), the JAX
  package's ``_analytic_bg``.  Where no rect is hit: depth zfar, sky.

  Each rect's texels, light query and grid shadows are as in the JAX
  package: cell-quantized to its G x G texel cells (or per pixel with
  ``rect_pixel_texels``); light visibility tested on its (G+1)^2 grid
  points and read back 4-corner averaged per cell (bilinear per pixel
  with ``rect_pixel_texels``).
  """
  model, scene = r.model, r.scene
  H, W = r.height, r.width
  cam_pos, Rc = cam                                     # [B, 3], [B, 3, 3]
  B, dev = cam_pos.shape[0], cam_pos.device
  nrect = int(scene.rect_geom.shape[0])
  best_colp = torch.full((B, H, W), _pack_sky(r.sky_rgb), device=dev)
  best_depth = torch.full((B, H, W), r.zfar, device=dev)
  if nrect == 0:
    return best_depth, best_colp

  # unnormalized camera-frame pixel rays (a, b, -1): z-depth along the ray
  # equals the ray parameter s (the exact inverse of the projection)
  f = 1.0 / torch.tan(torch.deg2rad(model.cam_fovy[r.cam_id]) * 0.5)
  aspect = W / H
  a = ((2.0 * (torch.arange(W, device=dev) + 0.5) / W) - 1.0) * aspect / f
  b = (1.0 - 2.0 * (torch.arange(H, device=dev) + 0.5) / H) / f
  dirw = (a[None, None, :, None] * Rc[:, None, None, :, 0] +
          b[None, :, None, None] * Rc[:, None, None, :, 1] -
          Rc[:, None, None, :, 2])                      # [B, H, W, 3]
  dot = lambda x, v: (x * v[:, None, None, :]).sum(-1)  # [B,H,W,3]·[B,3]

  tex = None
  if scene.tex_default.shape[0]:
    tex = (r.const('tex_default') if textures is None else
           torch.as_tensor(textures, dtype=torch.float32, device=dev))
  Rt = scene.tex_res
  shadows = (r.shadows and model.nlight and
             (scene.shadow_cast.size or r.shadow_caps))
  rows = torch.arange(B, device=dev)[:, None, None]

  for k in range(nrect):
    g = int(scene.rect_geom[k])
    hx, hy = float(scene.rect_half[k, 0]), float(scene.rect_half[k, 1])
    Rg = gm.quat_to_mat(kin.geom_xquat[:, g])           # [B, 3, 3]
    center = kin.geom_xpos[:, g] + (Rg @ r.const('rect_off')[k])
    U, V, N = Rg[..., 0], Rg[..., 1], Rg[..., 2]        # [B, 3]

    denom = dot(dirw, N)                                # [B, H, W]
    hit = denom.abs() > 1e-9
    safe = torch.where(hit, denom, torch.ones_like(denom))
    s = ((center - cam_pos) * N).sum(-1)[:, None, None] / safe
    rel = cam_pos - center                              # [B, 3]
    lu = s * dot(dirw, U) + (rel * U).sum(-1)[:, None, None]
    lv = s * dot(dirw, V) + (rel * V).sum(-1)[:, None, None]
    inside = (hit & (s > r.znear) & (lu.abs() <= hx) & (lv.abs() <= hy) &
              (rgba[:, g, 3] > 0.5)[:, None, None])

    G = int(scene.rect_grid[k])
    u01 = lu / hx * 0.5 + 0.5
    v01 = lv / hy * 0.5 + 0.5
    if r.rect_pixel_texels:
      uq, vq = u01, v01
    else:                                               # cell centres
      uq = (torch.clamp((u01 * G).to(torch.int32), 0, G - 1).to(u01.dtype)
            + 0.5) / G
      vq = (torch.clamp((v01 * G).to(torch.int32), 0, G - 1).to(v01.dtype)
            + 0.5) / G

    slot = int(scene.rect_slot[k])
    if slot >= 0 and tex is not None:
      # texel mapping as scene._grid_quad: image row 0 = +y edge
      iu = torch.clamp((uq * Rt).to(torch.int64), 0, Rt - 1)
      iv = torch.clamp(((1.0 - vq) * Rt).to(torch.int64), 0, Rt - 1)
      base = (tex[slot][iv, iu] if tex.dim() == 4 else
              tex[rows, slot, iv, iu])                  # [B, H, W, 3]
    else:
      base = rgba[:, g, :3][:, None, None, :].expand(B, H, W, 3)

    # flat shading, the normal facing the camera (double-sided, as the
    # triangles)
    n_o = N * torch.sign((rel * N).sum(-1, keepdim=True) + 1e-12)
    if model.nlight:
      if model.light_directional[0]:
        diff = torch.clamp((n_o * -model.light_dir[0]).sum(-1), min=0.0)
        diff = diff[:, None, None].expand(B, H, W)
      else:
        # light query at the (possibly cell-quantized) surface point
        q_pix = (center[:, None, None, :] +
                 ((uq * 2.0 - 1.0) * hx)[..., None] * U[:, None, None, :] +
                 ((vq * 2.0 - 1.0) * hy)[..., None] * V[:, None, None, :])
        l = model.light_pos[0] - q_pix
        l = l / torch.clamp(gm.norm(l, keepdim=True), min=1e-9)
        diff = torch.clamp(dot(l, n_o), min=0.0)
    else:
      diff = torch.clamp(n_o[:, 2], min=0.0)[:, None, None].expand(B, H, W)

    if shadows and bool(scene.rect_recv[k]):
      # light visibility on the rect's (G+1)^2 grid, read back per pixel
      sg = G
      gl = np.linspace(-1.0, 1.0, sg + 1)
      gu, gv = np.meshgrid(gl * hx, gl * hy, indexing='ij')
      gu = torch.as_tensor(gu.ravel(), dtype=torch.float32, device=dev)
      gv = torch.as_tensor(gv.ravel(), dtype=torch.float32, device=dev)
      pts = (center[:, None, :] + gu[None, :, None] * U[:, None, :] +
             gv[None, :, None] * V[:, None, :])         # [B, (sg+1)^2, 3]
      occ = _occlude_points(r, kin, world, pts)         # [B, (sg+1)^2]
      fu = torch.clamp(u01 * sg, 0.0, sg - 1e-4)
      fv = torch.clamp(v01 * sg, 0.0, sg - 1e-4)
      iu0 = fu.to(torch.int64)
      iv0 = fv.to(torch.int64)
      at = lambda du, dv: torch.gather(
          occ, 1, ((iu0 + du) * (sg + 1) + iv0 + dv).reshape(B, -1)
      ).reshape(B, H, W)
      o00, o10, o01, o11 = at(0, 0), at(1, 0), at(0, 1), at(1, 1)
      if r.rect_pixel_texels:
        wu = fu - iu0
        wv = fv - iv0
        occ_pix = ((1 - wu) * (1 - wv) * o00 + wu * (1 - wv) * o10 +
                   (1 - wu) * wv * o01 + wu * wv * o11)
      else:
        occ_pix = 0.25 * (o00 + o10 + o01 + o11)
      diff = diff * (1.0 - occ_pix)

    shade = torch.clamp(0.45 + 0.6 * diff, 0.0, 1.1)
    c = torch.clamp(base * shade[..., None] * 255.0, 0.0, 255.0)
    colp = (torch.floor(c[..., 0]) * 65536.0 + torch.floor(c[..., 1]) * 256.0
            + torch.floor(c[..., 2]))

    win = inside & (s < best_depth)
    best_depth = torch.where(win, s, best_depth)
    best_colp = torch.where(win, colp, best_colp)
  return best_depth, best_colp


def _pack_sky(sky_rgb) -> float:
  s = [int(np.clip(c * 255.0, 0, 255)) for c in sky_rgb]
  return float(s[0] * 65536 + s[1] * 256 + s[2])


def _unpack_col(colp: torch.Tensor) -> torch.Tensor:
  """Packed f32 colour plane -> uint8 [..., 3]."""
  ci = colp.to(torch.int32)
  return torch.stack([(ci // 65536) % 256, (ci // 256) % 256, ci % 256],
                     -1).to(torch.uint8)


# ---------------------------------------------------------------------------
# stage 3: binning


def _bbox_planes(tp: TriPlanes):
  lox = torch.minimum(torch.minimum(tp.x0, tp.x1), tp.x2)
  hix = torch.maximum(torch.maximum(tp.x0, tp.x1), tp.x2)
  loy = torch.minimum(torch.minimum(tp.y0, tp.y1), tp.y2)
  hiy = torch.maximum(torch.maximum(tp.y0, tp.y1), tp.y2)
  return lox, loy, hix, hiy


def _bin_priority(tp: TriPlanes, tile: int) -> torch.Tensor:
  """Per-triangle binning priority: 1/z of the nearest vertex (so overflow
  drops the farthest triangles), plus a large constant for triangles whose
  screen bbox can cover a whole fine tile (big background quads)."""
  izmax = torch.maximum(torch.maximum(tp.iz0, tp.iz1), tp.iz2)
  lox, loy, hix, hiy = _bbox_planes(tp)
  big = ((hix - lox) >= tile) & ((hiy - loy) >= tile)
  return izmax + 1e4 * big.to(izmax.dtype)


def _bin_flat(r: Renderer, tp: TriPlanes):
  """Single-level binning (the JAX package's ``_bin_flat``): the top
  ``tris_per_tile`` triangles of all T for every fine tile, row-major.
  Returns (top_idx int64, slot_ok bool), each [B, n_tiles, K]; ties keep
  the lower triangle index first, as ``jax.lax.top_k`` does."""
  H, W, TS = r.height, r.width, r.tile
  ty, tx = H // TS, W // TS
  lox, loy, hix, hiy = _bbox_planes(tp)
  B, T = lox.shape
  dev = lox.device
  tiles_x = torch.arange(tx, device=dev) * TS
  tiles_y = torch.arange(ty, device=dev) * TS
  ox = (lox[..., None] < tiles_x + TS) & (hix[..., None] >= tiles_x)
  oy = (loy[..., None] < tiles_y + TS) & (hiy[..., None] >= tiles_y)
  overlap = oy[..., :, None] & ox[..., None, :] & tp.valid[..., None, None]
  overlap = overlap.reshape(B, T, ty * tx).transpose(1, 2)   # [B, tiles, T]
  prio = _bin_priority(tp, TS)[:, None, :]
  prio = torch.where(overlap, prio, torch.zeros_like(prio))
  top_prio, top_idx = torch.sort(prio, dim=-1, descending=True, stable=True)
  K = r.tris_per_tile
  return top_idx[..., :K], top_prio[..., :K] > 0


def _raster_flat(r: Renderer, planes: List[torch.Tensor], npx: int):
  """Chunked z-buffer scan (the JAX package's ``_raster_jnp``), plain
  PyTorch on every device.

  planes: 11 tensors [B, tiles, K] (x0..y2 tile-relative, iz0..iz2, ok,
  colp).  Each step takes ``chunk`` slots: per pixel the nearest covering
  slot of the chunk (the first on a tie) replaces the buffer's where it is
  strictly nearer.  As there, K // chunk whole chunks are scanned.
  Returns (zbuf, colbuf packed f32), each [B, tiles, npx].
  """
  x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp = planes
  TS = r.tile
  B, n_tiles, K = x0.shape
  C = min(r.chunk, K)
  dev = x0.device
  lin = torch.arange(npx, device=dev)
  px = ((lin % TS).to(x0.dtype) + 0.5)[None, None, None, :]
  py = ((lin // TS).to(x0.dtype) + 0.5)[None, None, None, :]
  zbuf = torch.full((B, n_tiles, npx), float('inf'), device=dev)
  cbuf = torch.full((B, n_tiles, npx), _pack_sky(r.sky_rgb), device=dev)
  inf = torch.full((), float('inf'), device=dev)
  one = torch.ones((), device=dev)
  for c0 in range(0, (K // C) * C, C):
    sl = lambda p: p[..., c0:c0 + C, None]             # [B, tiles, C, 1]
    X0, Y0, X1, Y1, X2, Y2 = (sl(p) for p in (x0, y0, x1, y1, x2, y2))
    IZ0, IZ1, IZ2 = sl(iz0), sl(iz1), sl(iz2)
    e0 = (X1 - X0) * (py - Y0) - (Y1 - Y0) * (px - X0)   # [B, tiles, C, px]
    e1 = (X2 - X1) * (py - Y1) - (Y2 - Y1) * (px - X1)
    e2 = (X0 - X2) * (py - Y2) - (Y0 - Y2) * (px - X2)
    area = (X1 - X0) * (Y2 - Y0) - (Y1 - Y0) * (X2 - X0)
    sgn = torch.sign(area)
    inside = ((e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0) &
              (sl(ok) > 0.5))
    inv_area = 1.0 / torch.where(area.abs() > 1e-9, area, one)
    inv_z = (e1 * IZ0 + e2 * IZ1 + e0 * IZ2) * inv_area
    z = torch.where(inside, 1.0 / torch.clamp(inv_z, min=1e-6), inf)
    zc, sel = torch.min(z, dim=2)                      # [B, tiles, px]
    cc = torch.gather(colp[..., c0:c0 + C], 2, sel)
    closer = zc < zbuf
    zbuf = torch.where(closer, zc, zbuf)
    cbuf = torch.where(closer, cc, cbuf)
  return zbuf, cbuf


def _bin_hierarchical(r: Renderer, tp: TriPlanes) -> List[torch.Tensor]:
  """Hierarchical binning (the JAX package's ``_bin_pallas``).

  Coarse 4x4-fine-tile regions keep the top-K1 triangles by priority; mid
  2x2-fine-tile regions keep, in coarse order, the first K2 of their
  parent's candidates that overlap them.  Returns 11 planes
  (x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp), each [B, n_tiles, K2]
  in mid-major tile order (tile = mid * 4 + sub), with coordinates
  relative to each mid region's origin: the JAX planes transposed.
  """
  H, W, TS = r.height, r.width, r.tile
  ty, tx = H // TS, W // TS
  CS, MS = _COARSE, _MID
  cty, ctx = ty // CS, tx // CS
  mty, mtx = ty // MS, tx // MS
  n_coarse = cty * ctx
  n_mid = mty * mtx
  K1, K2 = r.coarse_k, r.mid_k
  lox, loy, hix, hiy = _bbox_planes(tp)
  B, T = lox.shape
  dev = lox.device

  # ---- coarse overlap -> top-K1 candidate ids per coarse region.  A stable
  # descending sort keeps the lower index first among equal priorities, as
  # jax.lax.top_k does (torch.topk leaves the order of ties unspecified).
  CTS = TS * CS
  cx0 = torch.arange(ctx, device=dev) * CTS
  cy0 = torch.arange(cty, device=dev) * CTS
  ox = (lox[..., None] < cx0 + CTS) & (hix[..., None] >= cx0)   # [B, T, ctx]
  oy = (loy[..., None] < cy0 + CTS) & (hiy[..., None] >= cy0)   # [B, T, cty]
  overlap_c = oy[..., :, None] & ox[..., None, :] & tp.valid[..., None, None]
  overlap_c = overlap_c.reshape(B, T, n_coarse).transpose(1, 2)
  prio = _bin_priority(tp, TS)
  prio_c = torch.where(overlap_c, prio[:, None, :], torch.zeros_like(
      prio[:, None, :]))                                # [B, n_coarse, T]
  cprio, cidx = torch.sort(prio_c, dim=-1, descending=True, stable=True)
  cprio, cidx = cprio[..., :K1], cidx[..., :K1]         # [B, n_coarse, K1]

  # ---- coarse attribute fetch
  flat_idx = cidx.reshape(B, -1)
  cplanes = [torch.gather(p, 1, flat_idx).reshape(B, n_coarse, K1)
             for p in (tp.x0, tp.y0, tp.x1, tp.y1, tp.x2, tp.y2, tp.iz0,
                       tp.iz1, tp.iz2, tp.colp)]
  cx0p, cy0p, cx1p, cy1p, cx2p, cy2p = cplanes[:6]
  c_ok = cprio > 0
  clox = torch.minimum(torch.minimum(cx0p, cx1p), cx2p)
  chix = torch.maximum(torch.maximum(cx0p, cx1p), cx2p)
  cloy = torch.minimum(torch.minimum(cy0p, cy1p), cy2p)
  chiy = torch.maximum(torch.maximum(cy0p, cy1p), cy2p)

  # ---- mid regions: the overlapping parent candidates, in parent order
  MTS = TS * MS
  mid = torch.arange(n_mid, device=dev)
  mx0 = ((mid % mtx) * MTS).to(lox.dtype)[:, None]      # [n_mid, 1]
  my0 = ((mid // mtx) * MTS).to(lox.dtype)[:, None]
  R_ = CS // MS                                         # mids per coarse side

  def rep(p):                         # [B, n_coarse, K1] -> [B, n_mid, K1]
    x = p.reshape(B, cty, 1, ctx, 1, K1).expand(B, cty, R_, ctx, R_, K1)
    return x.reshape(B, n_mid, K1)

  ovm = ((rep(clox) < mx0 + MTS) & (rep(chix) >= mx0) &
         (rep(cloy) < my0 + MTS) & (rep(chiy) >= my0) & rep(c_ok))
  # the JAX sort key is -(K1 - k) on overlapping slots and 0 elsewhere:
  # overlapping slots first in slot order, then the rest in slot order
  order = torch.argsort((~ovm).to(torch.int8), dim=-1, stable=True)
  order = order[..., :K2]                               # [B, n_mid, K2]
  m_ok = torch.gather(ovm, -1, order).to(lox.dtype)
  mplanes = [torch.gather(rep(p), -1, order) for p in cplanes]
  for i in range(6):
    mplanes[i] = mplanes[i] - (mx0 if i % 2 == 0 else my0)
  mplanes.insert(9, m_ok)                               # x0..iz2, ok, colp

  # ---- expand to fine tiles: [B, n_mid, K2] -> [B, n_tiles, K2] mid-major
  return [p.repeat_interleave(MS * MS, dim=1) for p in mplanes]


def _coeff_planes(planes: List[torch.Tensor], tile: int, mid_sub: int
                  ) -> torch.Tensor:
  """11 vertex planes [B, n_tiles, K] -> affine coefficients
  [B, n_tiles, 13, K] (the JAX package's ``_coeff_planes``).

  Each edge function and the interpolated inverse depth are affine in the
  pixel coordinates, e_i(p) = A_i*px + B_i*py + C_i.  Folded in once: the
  area-sign normalisation (inside becomes e_i >= 0), slot validity
  (invalid slots get C0 = -1e30, never inside) and the sub-tile offset of
  each fine tile within its mid region.  Runs in PyTorch before the kernel
  launch.  Row order: A0,B0,C0, A1,B1,C1, A2,B2,C2, Az,Bz,Cz, colp.
  """
  x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp = planes
  n_tiles = x0.shape[1]
  S = mid_sub
  a0, b0 = y0 - y1, x1 - x0
  c0 = -a0 * x0 - b0 * y0
  a1, b1 = y1 - y2, x2 - x1
  c1 = -a1 * x1 - b1 * y1
  a2, b2 = y2 - y0, x0 - x2
  c2 = -a2 * x2 - b2 * y2
  area = b0 * (y2 - y0) + a0 * (x2 - x0)   # == e0(v2), signed 2*area
  s = torch.sign(area)
  a0, b0, c0 = a0 * s, b0 * s, c0 * s
  a1, b1, c1 = a1 * s, b1 * s, c1 * s
  a2, b2, c2 = a2 * s, b2 * s, c2 * s
  inv_area = 1.0 / torch.clamp(area.abs(), min=1e-9)
  az = (a1 * iz0 + a2 * iz1 + a0 * iz2) * inv_area
  bz = (b1 * iz0 + b2 * iz1 + b0 * iz2) * inv_area
  cz = (c1 * iz0 + c2 * iz1 + c0 * iz2) * inv_area
  c0 = torch.where(ok > 0.5, c0, torch.full_like(c0, -1e30))
  # mid-relative -> fine-tile-relative (tile = mid * S^2 + sy * S + sx)
  sub = torch.arange(n_tiles, device=x0.device) % (S * S)
  ox = ((sub % S) * tile).to(x0.dtype)[:, None]        # [n_tiles, 1]
  oy = ((sub // S) * tile).to(x0.dtype)[:, None]
  c0 = c0 + a0 * ox + b0 * oy
  c1 = c1 + a1 * ox + b1 * oy
  c2 = c2 + a2 * ox + b2 * oy
  cz = cz + az * ox + bz * oy
  return torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz, colp],
                     dim=2).contiguous()


def _compose_midmajor(buf: torch.Tensor, ty: int, tx: int, TS: int,
                      MS: int) -> torch.Tensor:
  """[B, n_tiles (mid-major), npx] -> [B, H, W] image."""
  B = buf.shape[0]
  mty, mtx = ty // MS, tx // MS
  x = buf.reshape(B, mty, mtx, MS, MS, TS, TS)   # (my, mx, sy, sx, py, px)
  x = x.permute(0, 1, 3, 5, 2, 4, 6)
  return x.reshape(B, ty * TS, tx * TS)


# ---------------------------------------------------------------------------


def _render(r: Renderer, kin: Kin, geom_rgba: torch.Tensor | None,
            textures: torch.Tensor | None = None):
  H, W, TS = r.height, r.width, r.tile
  ty, tx = H // TS, W // TS
  n_tiles, npx = ty * tx, TS * TS
  B = kin.xpos.shape[0]

  rgba = r.model.geom_rgba.expand(B, -1, -1) if geom_rgba is None \
      else geom_rgba
  cam = _camera(r, kin)
  world = _vertex_world(r, kin)
  inf = torch.full((), float('inf'), device=world.device)

  if r.scene.tri.shape[0] == 0:
    # rect-only scene: the analytic layer is the whole image
    path = 'rects'
    depth = torch.full((B, H, W), float('inf'), device=world.device)
    cimg = torch.zeros((B, H, W), device=world.device)
  else:
    tp = _project_and_shade(r, kin, rgba, cam=cam, world=world,
                            textures=textures)
    if r.backend != 'jnp' and ty % _COARSE == 0 and tx % _COARSE == 0:
      path = 'hierarchical'
      planes = _bin_hierarchical(r, tp)                 # [B, n_tiles, K2]
      coeffs = _coeff_planes(planes, TS, _MID)          # [B, n_tiles, 13, K2]
      izbuf, cbuf = raster_kernel.raster_tiles(coeffs, TS,
                                               _pack_sky(r.sky_rgb))
      depth = _compose_midmajor(
          torch.where(izbuf > 0.0, 1.0 / torch.clamp(izbuf, min=1e-9), inf),
          ty, tx, TS, _MID)
      cimg = _compose_midmajor(cbuf, ty, tx, TS, _MID)
    else:
      path = 'flat'
      top_idx, slot_ok = _bin_flat(r, tp)               # [B, n_tiles, K]
      tile_id = torch.arange(n_tiles, device=world.device)
      orx = ((tile_id % tx) * TS).to(world.dtype)[:, None]
      ory = ((tile_id // tx) * TS).to(world.dtype)[:, None]
      flat_idx = top_idx.reshape(B, -1)
      take = lambda p: torch.gather(p, 1, flat_idx).reshape(top_idx.shape)
      planes = [take(tp.x0) - orx, take(tp.y0) - ory,
                take(tp.x1) - orx, take(tp.y1) - ory,
                take(tp.x2) - orx, take(tp.y2) - ory,
                take(tp.iz0), take(tp.iz1), take(tp.iz2),
                slot_ok.to(world.dtype), take(tp.colp)]
      zbuf, cbuf = _raster_flat(r, planes, npx)
      depth = torch.where(torch.isfinite(zbuf), zbuf, inf)
      tiles = lambda x: x.reshape(B, ty, tx, TS, TS).permute(
          0, 1, 3, 2, 4).reshape(B, H, W)
      cimg, depth = tiles(cbuf), tiles(depth)
  r.path_counts[path] = r.path_counts.get(path, 0) + 1

  # composite the analytic background layer: triangles win only where
  # strictly nearer; rect-missed pixels carry the sky at zfar
  bg_depth, bg_colp = _analytic_bg(r, kin, rgba, textures, cam, world)
  tri_wins = depth < bg_depth
  cimg = torch.where(tri_wins, cimg, bg_colp)
  depth = torch.where(tri_wins, depth, bg_depth)
  if r.depth_gl:
    zn, zf = r.znear, r.zfar
    depth = torch.clamp((zf / (zf - zn)) *
                        (1.0 - zn / torch.clamp(depth, min=zn)), 0.0, 1.0)
  return _unpack_col(cimg), depth                       # uint8 [B, H, W, 3]
